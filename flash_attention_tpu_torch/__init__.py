"""flash-attention-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package `flash_attention_tpu` is the reference; this package keeps
its module names.  Plain tensor code is PyTorch; each Pallas kernel on a
ported path is a kernel written by hand for sm_90a (`csrc/`), built on
first use.  Ported so far: the GPT-2 serving path (flash-attention
forward, einsum decode, sampling, the continuous-batching engine), the
GPT-2 training path (flash-attention backward, dropout, remat, AdamW,
checkpoints, the trainer and its demo), with the packed-QKV op and the
SDPA drop-in, quantized-KV serving (int8/fp8 cache, quantized-KV flash
attention, the paged and slot-major decode kernels), the Llama family
with weight-only int8/int4 (`models.llama`, `quant.weights`), chunked
prefill and speculative decoding in the engine, and measurement: timers
(`utils.measure`), memory reports, liveness and traces
(`utils.profiling`), the autotuner over the forward kernel's tiles
(`kernels.autotune`, with the engine's and the trainer's warm-up hooks)
and the walkthrough (`demo.walkthrough`); and the sharded paths
(`parallel`): DeviceMesh/DTensor sharding, ring and head-parallel
attention over torch.distributed, DP/TP and context-parallel training, and
Llama tensor-parallel serving.
"""

import importlib

from .kernels import (
    BlockSizes,
    flash_attention,
    flash_attention_with_lse,
    vanilla_attention,
)
from .ops import dot_product_attention, flash_attention_qkv_packed

__version__ = "0.1.0"

# Lazily importable subsystems (keeps `import flash_attention_tpu_torch`
# light).
_SUBMODULES = (
    "kernels",
    "ops",
    "models",
    "training",
    "inference",
    "quant",
    "data",
    "utils",
    "config",
    "parallel",
)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BlockSizes",
    "dot_product_attention",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_qkv_packed",
    "vanilla_attention",
    "__version__",
    *_SUBMODULES,
]
