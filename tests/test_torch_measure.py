"""utils.measure on the CPU lane, and the port's public names against the
JAX package's.

`chain_timer` / `ab_compare` port `tests/test_utils_misc.py::
test_measure_chain_timer_and_ab` on CPU tensors (wall time around the eager
chain); their CUDA-graph path and `graph_ms` / `time_ms` run on the card
(chip_smoke.py's measure phase)."""

from __future__ import annotations

import importlib

import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's threads)
from flash_attention_tpu_torch.utils import measure


def test_measure_chain_timer_and_ab():
    """Positive per-call times, every variant present, the recheck row
    (the drift band's other end)."""
    x = torch.ones(8, 128)
    dt = measure.chain_timer(lambda c: c * 1.0001, x, depth=8, iters=2)
    assert dt > 0
    res = measure.ab_compare({"a": lambda c: c * 1.0001, "b": lambda c: c + 1e-4}, x, depth=8, iters=2)
    assert set(res) == {"a", "b", "a+recheck"}
    assert all(v > 0 for v in res.values())
    res = measure.ab_compare({"a": lambda c: c * 1.0001, "b": lambda c: c + 1e-4}, x, depth=2, iters=1, base="b")
    assert set(res) == {"a", "b", "b+recheck"}


def test_chain_timer_chains_each_call_on_the_last():
    """The chain feeds each call the previous result, cast to the carry's
    dtype, `depth` times per timed run (plus one warm-up call); a function
    that changes the carry's shape is refused."""
    seen = []

    def f(c, step):
        seen.append(float(c[0]))
        return (c + step).double()

    measure.chain_timer(f, torch.zeros(4), torch.ones(4), depth=3, iters=2)
    assert seen == [0.0, 0.0, 1.0, 2.0, 0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="shape"):
        measure.chain_timer(lambda c: c.sum(), torch.zeros(4), depth=2, iters=1)


def test_floor_ms_takes_the_longer_of_bytes_and_operations():
    """K1's bound at b8 h12 L1024 D64 bf16 causal: 50 MB of q, k, v, o at
    3.35 TB/s against 12.9 GFLOP at 989 TFLOP/s, the bytes by a hair."""
    elems = 8 * 12 * 1024 * 64
    ms, by = measure.floor_ms(4 * elems * 2, 4 * 8 * 12 * 1024 * 1024 * 64 / 2)
    assert by == "bytes" and ms == pytest.approx(4 * elems * 2 / 3.35e12 * 1e3)
    ms, by = measure.floor_ms(1.0, 67e9, peak=measure.FP32_FLOPS)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_floor_ms_of_fp32_work_at_the_3xtf32_rate():
    """fp32 K2 at b8 h12 L1024 D64 causal: four products of the forward's
    size, 25.8 GFLOP, at a third of TF32's 495 TFLOP/s is 0.156 ms, bound by
    its operations (its 151 MB take 0.045 ms)."""
    flops = 2 * 4 * 8 * 12 * 1024 * 1024 * 64 / 2
    assert measure.TF32X3_FLOPS == pytest.approx(165e12)
    ms, by = measure.floor_ms(6 * 8 * 12 * 1024 * 64 * 4 + 2 * 8 * 12 * 1024 * 4, flops, peak=measure.TF32X3_FLOPS)
    assert by == "operations" and ms == pytest.approx(0.1562, abs=1e-4)


# JAX names the port leaves out, by subpackage: the XLA compilation cache
# and the fused clip+AdamW are not ported (ROADMAP, "Do not port"); the
# functional model API is the GPT module.
NOT_PORTED = {
    "training": {"enable_compilation_cache", "fused_clip_adamw"},
    "models": {"forward", "init_params"},
}


@pytest.mark.parametrize(
    "sub", ["", "kernels", "utils", "inference", "training", "models", "quant", "ops", "data", "parallel"]
)
def test_subpackage_exports_match_the_jax_package(sub):
    """Every name in each JAX subpackage's __all__ is in the port's, less
    the names listed above, and imports from it."""
    suffix = f".{sub}" if sub else ""
    jax_all = set(importlib.import_module(f"flash_attention_tpu{suffix}").__all__)
    port = importlib.import_module(f"flash_attention_tpu_torch{suffix}")
    missing = jax_all - set(port.__all__) - NOT_PORTED.get(sub, set())
    assert not missing, missing
    for name in jax_all - NOT_PORTED.get(sub, set()):
        assert getattr(port, name) is not None, name


def test_utils_and_kernels_export_measurement_and_the_tuner():
    from flash_attention_tpu_torch.kernels import autotune, autotune_for_model, tuned_blocks  # noqa: F401
    from flash_attention_tpu_torch.utils import (  # noqa: F401
        MemoryReport,
        ab_compare,
        chain_timer,
        compare_memory,
        device_info,
        flops_estimate,
        memory_report,
        patch_function,
        trace,
        unpatch_function,
    )

    assert callable(autotune) and callable(patch_function)
