"""Timers for the port: data-dependent chains, interleaved A/B, CUDA graphs
and the card's bound.

Port of `flash_attention_tpu/utils/measure.py` (`chain_timer`,
`ab_compare`, same signatures and return values), with the timers that
`chip_smoke.py` and `tools/*_ab.py` share beside them (`time_ms`,
`graph_ms`, `floor_ms`).

* `chain_timer` times `c = f(c, *rest)` chained `depth` times, so that no
  call can be skipped or overlapped with its neighbours.  On CUDA tensors
  the chain is captured once in a CUDA graph, after one eager warm-up that
  also builds the kernels, and replayed between CUDA events: the host's
  time to enqueue a call (the Python wrapper, ctypes) is not counted.  On
  CPU tensors it takes `time.perf_counter` around the eager chain.  The
  device is always the tensors' own.
* Times drift between calls and between cards (a card set below 700 W runs
  slower under load), so a claim needs an interleaved A/B in one process:
  `ab_compare` times every variant, then the base again as
  `<base>+recheck`; the two base readings bound the drift, and a
  difference inside that band is noise.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Mapping

import torch

__all__ = ["ab_compare", "chain_timer", "floor_ms", "graph_ms", "time_ms"]

# Published peaks of one H100 SXM (data sheet; dense rates at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # fp32 FMA outside the tensor cores
# fp32-accurate products on the tensor cores: 3xTF32 splits each fp32
# operand into two TF32 halves and takes three TF32 passes a product (hi *
# hi, hi * lo, lo * hi) at TF32's dense 495 TFLOP/s.  One pass keeps about
# three decimal digits and misses the fp32 tiers (1e-5 forward, 1e-4
# backward), so this is the least time the card could take for fp32 work
# held to them.
TF32X3_FLOPS = 495e12 / 3


def time_ms(fn: Callable[[], Any], runs: int = 20, warmup: int = 3, inner: int = 1) -> float:
    """Median over `runs` of the ms per call of `inner` back-to-back calls
    of `fn` between two CUDA events (the host's enqueue included where it
    is longer than the device's work)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _capture(fn: Callable[[], Any], calls: int, warmup: int) -> torch.cuda.CUDAGraph:
    """`calls` calls of `fn` captured in one CUDA graph, after `warmup`
    eager calls; warm-up and capture share one side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def graph_ms(fn: Callable[[], Any], calls: int = 20, runs: int = 10) -> float:
    """Device ms a call: `calls` calls captured in one CUDA graph and
    replayed between two CUDA events (median of `runs`), so that the
    host's time to enqueue a call is not counted."""
    return time_ms(_capture(fn, calls, warmup=3).replay, runs=runs) / calls


def floor_ms(nbytes: float, flops: float = 0.0, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take, and what sets it: `nbytes` at
    3.35 TB/s or `flops` at the inputs' peak rate (989 TFLOP/s for bf16 and
    fp16; for fp32, 165 in 3xTF32 on the tensor cores or 67 outside them),
    whichever takes longer:
    (ms, "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _chain(f: Callable[..., torch.Tensor], first: torch.Tensor, rest: tuple, depth: int) -> torch.Tensor:
    c = first
    for _ in range(depth):
        c = f(c, *rest).to(c.dtype)
    return c


def chain_timer(
    f: Callable[..., torch.Tensor],
    *args: Any,
    depth: int = 64,
    iters: int = 3,
    reduce_best: bool = True,
) -> float:
    """Seconds per call of `f(carry, *rest)`, measured as a chain of `depth`
    calls, each fed the last one's result (cast to the carry's dtype).

    `f` must return a tensor of its first argument's shape.  Returns the
    best of `iters` timed chains (the right statistic under one-sided
    noise), else their mean, divided by `depth`.  On CUDA tensors the chain
    runs in a CUDA graph (see the module docstring); a function that
    cannot be captured raises RuntimeError with the reason, and is never
    timed eagerly in its place."""
    first, rest = args[0], args[1:]
    out = _chain(f, first, rest, 1)  # warm-up; builds the kernels on the card
    if out.shape != first.shape:
        raise ValueError(f"chain_timer: f returned shape {tuple(out.shape)} for a carry of {tuple(first.shape)}")
    samples = []
    if first.device.type == "cuda":
        try:
            graph = _capture(lambda: _chain(f, first, rest, depth), calls=1, warmup=0)
        except RuntimeError as exc:
            raise RuntimeError(f"chain_timer: f cannot be captured in a CUDA graph: {exc}") from exc
        graph.replay()  # warm
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            _chain(f, first, rest, depth)
            samples.append(time.perf_counter() - t0)
    agg = min(samples) if reduce_best else sum(samples) / len(samples)
    return agg / depth


def ab_compare(
    variants: Mapping[str, Callable[..., torch.Tensor]],
    *args: Any,
    depth: int = 64,
    iters: int = 3,
    base: str | None = None,
) -> dict[str, float]:
    """Interleaved A/B in one process: time every variant with
    `chain_timer`, then the first (or `base`) again as `<base>+recheck`.

    Returns {name: seconds_per_call}.  |base - base+recheck| is the drift
    band: a difference between variants inside it is noise."""
    names = list(variants)
    base = base or names[0]
    results: dict[str, float] = {}
    for name in names:
        results[name] = chain_timer(variants[name], *args, depth=depth, iters=iters)
    results[f"{base}+recheck"] = chain_timer(variants[base], *args, depth=depth, iters=iters)
    return results
