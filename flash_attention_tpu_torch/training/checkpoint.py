"""Checkpoint / resume with `torch.save` / `torch.load`.

Port of `flash_attention_tpu/training/checkpoint.py`, where orbax saved a
pytree.  A checkpoint is a directory `step_N` holding `state.pt`: a dict of
tensors, numbers and state dicts (model, optimizer, the train step's
counters, the generator state).  It is loaded with `weights_only=True`, so
loading runs no pickled code.  `enable_compilation_cache` is XLA-only and
is not ported.
"""

from __future__ import annotations

import os
import pathlib
from typing import Any

import torch

_STATE = "state.pt"


def save_checkpoint(path: str | os.PathLike, state: dict[str, Any]) -> None:
    """Save `state` into the directory `path` (created, or overwritten)."""
    path = pathlib.Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path / _STATE)  # a crash mid-save leaves the old state


def restore_checkpoint(path: str | os.PathLike, map_location=None) -> dict[str, Any]:
    """Load the state saved by `save_checkpoint` in `path`."""
    return torch.load(pathlib.Path(path).resolve() / _STATE, map_location=map_location, weights_only=True)


def latest_step_dir(root: str | os.PathLike) -> pathlib.Path | None:
    """Find the highest-numbered step_* checkpoint directory under root."""
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = sorted(
        (p for p in root.iterdir() if p.name.startswith("step_")),
        key=lambda p: int(p.name.split("_")[1]),
    )
    return steps[-1] if steps else None
