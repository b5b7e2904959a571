"""Sharding/communication layer: meshes, TP rules, ring attention.

Port of `flash_attention_tpu/parallel/`: a `DeviceMesh` with the JAX
package's (data, model, seq) axes, DTensor placements for its
NamedShardings, and torch.distributed collectives and P2P where its
shard_map bodies call psum and ppermute.  One process drives one device:
start the process group with `initialize_multihost` (NCCL on the card,
gloo on the CPU) before making a mesh.
"""

from .inference_tp import (
    cache_specs,
    llama_param_specs,
    shard_llama_for_inference,
    tp_decode_loop,
    tp_prefill,
)
from .mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, batch_sharding, make_mesh, replicated,
    seq_batch_sharding,
)
from .multihost import assert_same_across_hosts, initialize_multihost, topology
from .ring_attention import head_parallel_attention, ring_attention
from .sharding import gpt_param_sharding, gpt_param_specs, shard_params

__all__ = [
    "cache_specs",
    "llama_param_specs",
    "shard_llama_for_inference",
    "tp_decode_loop",
    "tp_prefill",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "assert_same_across_hosts",
    "batch_sharding",
    "seq_batch_sharding",
    "gpt_param_sharding",
    "gpt_param_specs",
    "head_parallel_attention",
    "initialize_multihost",
    "make_mesh",
    "replicated",
    "ring_attention",
    "shard_params",
    "topology",
]
