"""Measured tile autotuning for the flash-attention forward.

Port of `flash_attention_tpu/kernels/autotune.py`: sweep candidate tilings
of `flash_attention` on the inputs' own device with `utils.measure.
chain_timer` (on the card a chain of calls in a CUDA graph, best of N), and
cache the winner per (shape, dtype, causal, GQA group) in a JSON file, so
that a configuration pays the sweep once per device.

    from flash_attention_tpu_torch.kernels.autotune import autotune, tuned_blocks
    bs = autotune(q, k, v)                     # sweep (or hit) and cache
    bs = tuned_blocks(q.shape, k.shape[2], q.dtype, num_kv_heads=k.shape[1],
                      device=q.device)         # cache only, None on a miss

`flash_attention` with neither `block_sizes` nor chunk counts, and without
window or segment ids, consults `tuned_blocks` itself.

The candidates are the tile heights the bf16/fp16 forward kernel K1 is
built at (`block_sizes.K1_TILES` at the padded head dim), each with
`default_blocks`' other fields; the CUDA backward keeps its own tiles, and
the tuner times the forward only, as JAX's does.  The plain version runs
any tile, so the CPU sweeps the same set as the card.  Unlike the JAX
package, which drops a candidate that fails to compile and falls back to
the defaults, a failing candidate raises: each is a kernel that was built
for it, so a failure is a fault, not a slower choice.

The cache file is the JAX package's (`FA_AUTOTUNE_CACHE`, default
`~/.cache/flash_attention_tpu/autotune.json`), with the same protocol:
merge with the file, then rename over it, so that the last writer wins per
key and not per file.  Every key starts with `torch|` and the device name
(`torch.cuda.get_device_name`, spaces as `_`, or `cpu`), so the two
packages' entries never collide, and one card's never serve another.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import threading
from typing import Any, Iterable

import torch

from ..utils.measure import chain_timer
from .block_sizes import K1_TILES, BlockSizes, _padded, default_blocks

__all__ = ["autotune", "autotune_for_model", "candidate_blocks", "clear_cache", "tuned_blocks"]

_LOCK = threading.Lock()
# (cache path, its entries): reloaded when FA_AUTOTUNE_CACHE names another file
_MEM: tuple[pathlib.Path, dict[str, Any]] | None = None


def _cache_path() -> pathlib.Path:
    env = os.environ.get("FA_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "flash_attention_tpu" / "autotune.json"


def _load() -> dict[str, Any]:
    global _MEM
    p = _cache_path()
    if _MEM is None or _MEM[0] != p:
        try:
            entries = json.loads(p.read_text())
        except (OSError, ValueError):
            entries = {}
        _MEM = (p, entries)
    return _MEM[1]


def _save() -> None:
    """Merge-then-rename: re-read the file, overlay this process's entries
    and write through a temporary file and os.replace, so that another
    process's entries survive and a reader never sees a torn file."""
    p = _cache_path()
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        merged: dict[str, Any] = {}
        try:
            merged = json.loads(p.read_text())
        except (OSError, ValueError):
            pass
        merged.update(_load())
        tmp = p.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(merged, indent=1, sort_keys=True))
        os.replace(tmp, p)
    except OSError:
        pass  # the cache saves time; a read-only home must not fail the caller


def clear_cache() -> None:
    """Forget every entry, in memory and in the file."""
    global _MEM
    with _LOCK:
        _MEM = (_cache_path(), {})
        try:
            _cache_path().unlink()
        except OSError:
            pass


@functools.lru_cache(maxsize=None)
def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "_")
    return device.type


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _key(device, b, h, lq, lk, d, dtype, causal, group) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (
        f"torch|{_device_name(dev)}|b{b}h{h}q{lq}k{lk}d{d}|{str(dtype).removeprefix('torch.')}"
        f"|causal={int(causal)}|g{group}"
    )


def _blocks(lq: int, lk: int, d: int, group: int, dtype, block_q: int) -> BlockSizes:
    return dataclasses.replace(default_blocks(lq, lk, d, group, dtype=dtype), block_q=block_q)


def _entry(hit: dict) -> BlockSizes:
    """The tiling a cache entry holds."""
    return BlockSizes(**{f.name: hit.get(f.name) for f in dataclasses.fields(BlockSizes)})


def candidate_blocks(lq: int, lk: int, d: int, group: int = 1, dtype=None) -> list[BlockSizes]:
    """The tilings to sweep: one for each tile height the bf16/fp16 K1 is
    built at, at head dim `d`'s padded head dim (`K1_TILES`), default first,
    each with `default_blocks`' other fields.  The same set on every device
    and dtype; where K1 has one tile (fp32 on the card, head dims above 256)
    the others change the plain version's tile only."""
    tiles = K1_TILES.get(_padded(d)) or (default_blocks(lq, lk, d, group, dtype=dtype).block_q,)
    return [_blocks(lq, lk, d, group, dtype, bq) for bq in tiles]


def autotune(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    depth: int = 32,
    iters: int = 2,
    candidates: Iterable[BlockSizes] | None = None,
    use_cache: bool = True,
) -> BlockSizes:
    """Time `flash_attention` on q, k, v at each candidate tiling (default
    `candidate_blocks`) on their device and return, and cache, the fastest.
    A candidate that fails raises."""
    from .flash_attention import flash_attention

    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = h // hkv
    key = _key(q.device, b, h, lq, lk, d, q.dtype, causal, group)
    if use_cache:
        with _LOCK:
            hit = _load().get(key)
        if hit is not None:
            return _entry(hit)

    cands = list(candidates) if candidates is not None else candidate_blocks(lq, lk, d, group, q.dtype)
    best: tuple[float, BlockSizes] | None = None
    with torch.no_grad():
        for bs in cands:
            dt = chain_timer(
                lambda c, kk, vv, bs=bs: flash_attention(c, kk, vv, causal=causal, block_sizes=bs),
                q, k, v, depth=depth, iters=iters,
            )
            if best is None or dt < best[0]:
                best = (dt, bs)
    if use_cache:
        with _LOCK:
            _load()[key] = {**dataclasses.asdict(best[1]), "seconds_per_call": best[0]}
            _save()
    return best[1]


def autotune_for_model(
    cfg,
    batch_size: int,
    *,
    seq_len: int | None = None,
    causal: bool = True,
    dtype=None,
    device="cuda",
    **kw,
) -> BlockSizes:
    """Warm the cache for a model's self-attention shape: q, k, v of the
    model's geometry ([B, H, L, D], GQA-aware; L = seq_len, default the
    config's block_size or max_seq) drawn from a seeded generator on
    `device` (default the card), then `autotune`.  cfg: a GPTConfig or a
    LlamaConfig (`n_kv_head`).  The warm-up hooks (Trainer.warmup_autotune,
    InferenceEngine.warmup_autotune) call this."""
    d = cfg.head_dim
    h = cfg.n_head
    hkv = cfg.kv_heads if hasattr(cfg, "kv_heads") else getattr(cfg, "n_kv_head", None) or h
    length = seq_len or getattr(cfg, "block_size", None) or cfg.max_seq
    dtype = dtype or cfg.dtype
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((batch_size, h, length, d), generator=gen, device=device).to(dtype)
    k = torch.randn((batch_size, hkv, length, d), generator=gen, device=device).to(dtype)
    v = torch.randn((batch_size, hkv, length, d), generator=gen, device=device).to(dtype)
    return autotune(q, k, v, causal=causal, **kw)


def tuned_blocks(
    q_shape: tuple[int, int, int, int],
    kv_len: int,
    dtype,
    *,
    causal: bool = True,
    num_kv_heads: int | None = None,
    device=None,
) -> BlockSizes | None:
    """Cache-only lookup: the tuned tiling for this configuration on
    `device` (default the card where there is one, else the CPU), or None
    if it was never tuned there.

    num_kv_heads must be passed for GQA (the group is part of the key);
    None means MHA.  Where the exact group misses, larger groups are probed:
    a tiling tuned at a larger group is safe at a smaller one, as in the
    JAX package."""
    b, h, lq, d = q_shape
    group = h // (num_kv_heads or h)
    device = device if device is not None else _default_device()
    groups = [group] + [g for g in range(group + 1, h + 1) if h % g == 0]
    with _LOCK:
        cache = _load()
        for g in groups:
            hit = cache.get(_key(device, b, h, lq, kv_len, d, dtype, causal, g))
            if hit is not None:
                return _entry(hit)
    return None
