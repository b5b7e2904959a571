"""Multi-process initialisation and process-level helpers.

Port of `flash_attention_tpu/parallel/multihost.py`.  Where JAX brings up
its coordination service with `jax.distributed.initialize`,
`torch.distributed` needs one process per device and a process group:
`initialize_multihost` starts it from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or from explicit arguments, with
NCCL for the card and gloo for the CPU.  Nothing tells a program of a
cluster otherwise, so off-cluster (no arguments, no torchrun) it does
nothing, as the JAX function tolerates a failed auto-detection.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..config import resolve_device

logger = logging.getLogger(__name__)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> dict:
    """Start the default process group, returning a topology summary.

    coordinator_address: an init method (`tcp://host:port`,
    `file:///path`); with it, num_processes and process_id are the world
    size and this process's rank.  Without it, torchrun's environment is
    used when present.  device: "cuda" (default, NCCL; the process takes
    card LOCAL_RANK) or "cpu" (gloo).  A no-op when the group is already up
    or there is nothing to join.
    """
    if not dist.is_initialized():
        explicit = coordinator_address is not None or (num_processes is not None and num_processes > 1)
        from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        if explicit or from_env:
            dev = resolve_device(device)
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            kwargs = {}
            if coordinator_address is not None:
                kwargs = dict(
                    init_method=coordinator_address,
                    world_size=num_processes if num_processes is not None else 1,
                    rank=process_id if process_id is not None else 0,
                )
            dist.init_process_group(backend, **kwargs)
        else:
            logger.info("initialize_multihost: no coordinator and no torchrun environment; single process")
    return topology()


def topology() -> dict:
    """Process/device topology summary (JAX's keys): one device per process."""
    if dist.is_initialized():
        backend = dist.get_backend()
        return {
            "process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "global_devices": dist.get_world_size(),
            "local_devices": int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
            "platform": "gpu" if backend == "nccl" else "cpu",
        }
    return {
        "process_index": 0,
        "process_count": 1,
        "global_devices": 1,
        "local_devices": 1,
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
    }


def assert_same_across_hosts(value: int, name: str = "value") -> None:
    """Cross-process agreement check: an all_reduce of `value` must give
    value * world size.  Catches mismatched per-process configs early."""
    if not dist.is_initialized():
        return
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    total = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(total)
    expected = int(value) * dist.get_world_size()
    if int(total.item()) != expected:
        raise ValueError(f"{name} disagrees across hosts: psum {int(total.item())} != {expected}")
