"""Memory and time profiling: memory reports, liveness, variable tables,
traces and FLOP counts.

Port of `flash_attention_tpu/utils/profiling.py`, with its names and
return values.  JAX reads its memory figures from XLA's compiled buffers;
PyTorch runs eagerly and has no compiler to ask, so here `memory_report`
and `liveness` run `fn` once under a `TorchDispatchMode` that sees every
operator and counts storage:

* each storage an operator creates adds its bytes while it lives (a
  `weakref.finalize` on the storage takes them off when it is freed);
  views share their base's storage and add nothing;
* `argument_bytes` are the inputs' storages, `output_bytes` the result's,
  and `temp_bytes` the peak over the run of the live bytes of every other
  storage the run created;
* the step of `liveness` is the operator's index in dispatch order, the
  port's counterpart of XLA's HLO instruction index.

The same function gives the same counts on the CPU and on the card: the
CUDA kernels allocate nothing themselves, their wrappers make every output
with `torch.empty`, which the mode sees.  On the card `memory_report` also
reads the caching allocator's peak (`torch.cuda.max_memory_allocated`
after `reset_peak_memory_stats`, less what was allocated when the run
began), which adds what the count cannot see: rounding to the allocator's
blocks and the memory of libraries (cuBLAS workspaces).

`trace` records a `torch.profiler` run into a Chrome trace; `device_time`
sums the device's busy time in such a run; `flops_estimate` counts FLOPs
with `torch.utils.flop_counter.FlopCounterMode`, which, as XLA's cost
analysis does not see inside a Pallas call, does not see inside the ctypes
kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import weakref
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "STEP_KINDS",
    "MemoryReport",
    "VariableRow",
    "compare_memory",
    "device_time",
    "flops_estimate",
    "format_variable_table",
    "liveness",
    "memory_report",
    "plot_liveness",
    "trace",
    "variable_table",
]


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    """Bytes by class for one run of a function.  `generated_code_bytes` is
    always 0: PyTorch runs eagerly and compiles no program for the call
    (the kernels' library is built once, outside any call).
    `allocator_peak_bytes` is the most the run added to the card's
    allocator (its peak over the run less what was allocated when the run
    began, so without the arguments), None on the CPU."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    generated_code_bytes: int = 0
    allocator_peak_bytes: int | None = None

    @property
    def peak_bytes(self) -> int:
        """Rough peak live footprint: args + outputs + temps."""
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    def __str__(self) -> str:
        mb = 1024 * 1024
        text = (
            f"args {self.argument_bytes / mb:.2f} MB | "
            f"out {self.output_bytes / mb:.2f} MB | "
            f"temp {self.temp_bytes / mb:.2f} MB | "
            f"code {self.generated_code_bytes / mb:.2f} MB"
        )
        if self.allocator_peak_bytes is not None:
            text += f" | allocator peak {self.allocator_peak_bytes / mb:.2f} MB"
        return text


def _storages(tree: Any) -> dict[int, int]:
    """{id: bytes} of the distinct storages of the tensors in `tree`."""
    out = {}
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and x.layout == torch.strided:
            st = x.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


class _StorageCounter(TorchDispatchMode):
    """Records, operator by operator, the storages the operators create and
    when each is freed: `events` holds (op index, storage id, +bytes) at
    creation and (op index, storage id, -bytes) when it is freed."""

    def __init__(self, known: dict[int, int]):
        super().__init__()
        self.known = set(known)
        self.events: list[tuple[int, int, int]] = []
        self.ops = 0

    def _freed(self, key: int, nbytes: int) -> None:
        self.events.append((self.ops, key, -nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_flatten(out)[0]:
            if isinstance(x, torch.Tensor) and x.layout == torch.strided:
                st = x.untyped_storage()
                key = id(st)
                if key not in self.known:
                    self.known.add(key)
                    self.events.append((self.ops, key, st.nbytes()))
                    weakref.finalize(st, self._freed, key, st.nbytes())
        self.ops += 1
        return out


def _run_counted(fn: Callable, args: tuple, kwargs: dict):
    """Run fn(*args, **kwargs) once, counting storages: (result, argument
    storages {id: bytes}, the counter)."""
    arguments = _storages((args, kwargs))
    counter = _StorageCounter(arguments)
    with counter:
        result = fn(*args, **kwargs)
    return result, arguments, counter


def memory_report(fn: Callable, *args: Any, **kwargs: Any) -> MemoryReport:
    """Run `fn(*args, **kwargs)` once and return its memory breakdown (see
    the module docstring)."""
    cuda = any(
        isinstance(x, torch.Tensor) and x.is_cuda for x in tree_flatten((args, kwargs))[0]
    )
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    result, arguments, counter = _run_counted(fn, args, kwargs)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated() - resident)
    outputs = {k: b for k, b in _storages(result).items() if k not in arguments}
    live = top = 0
    for _, key, nbytes in counter.events:
        if key not in outputs:
            live += nbytes
            top = max(top, live)
    return MemoryReport(
        argument_bytes=sum(arguments.values()),
        output_bytes=sum(outputs.values()),
        temp_bytes=top,
        generated_code_bytes=0,
        allocator_peak_bytes=peak,
    )


def compare_memory(fn_a: Callable, fn_b: Callable, *args: Any) -> tuple[MemoryReport, MemoryReport]:
    """Memory reports for two implementations of the same computation."""
    return memory_report(fn_a, *args), memory_report(fn_b, *args)


@dataclasses.dataclass(frozen=True)
class VariableRow:
    """One named tensor of a tree: a row of the per-variable size table."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    bytes: int


def _leaves(tree: Any, path: str) -> Iterator[tuple[str, Any]]:
    """(name, leaf) in the JAX package's order and spelling: dict keys
    sorted, as `params['blocks'][0]['w']`."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield path, tree


def _module_tree(module: torch.nn.Module) -> dict:
    """A module's parameters as a nested dict, dotted names split, numeric
    parts as list indices (blocks.0.attn.weight -> ['blocks'][0]['attn']
    ['weight'])."""
    tree: dict = {}
    for name, param in module.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = param

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node

    return lists(tree)


def variable_table(tree: Any, *, name: str = "") -> list[VariableRow]:
    """Per-variable size breakdown of a nested dict / list of tensors (torch
    or numpy), or of a module's parameters, largest first, each row named
    as the JAX package names it (`params['wte']`)."""
    if isinstance(tree, torch.nn.Module):
        tree = _module_tree(tree)
    rows = []
    for label, leaf in _leaves(tree, name):
        dtype = str(leaf.dtype).removeprefix("torch.")
        if isinstance(leaf, torch.Tensor):
            nbytes = leaf.numel() * leaf.element_size()
        else:
            nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        rows.append(VariableRow(label, tuple(leaf.shape), dtype, int(nbytes)))
    return sorted(rows, key=lambda r: -r.bytes)


def format_variable_table(rows: list[VariableRow], top: int = 20) -> str:
    mb = 1024 * 1024
    total = sum(r.bytes for r in rows)
    lines = [f"{'variable':48s} {'shape':>20s} {'dtype':>8s} {'MB':>9s}"]
    for r in rows[:top]:
        lines.append(f"{r.name[:48]:48s} {str(list(r.shape)):>20s} {r.dtype:>8s} {r.bytes / mb:9.2f}")
    if len(rows) > top:
        rest = sum(r.bytes for r in rows[top:])
        lines.append(f"{f'... {len(rows) - top} more':48s} {'':>20s} {'':>8s} {rest / mb:9.2f}")
    lines.append(f"{'TOTAL':48s} {'':>20s} {'':>8s} {total / mb:9.2f}")
    return "\n".join(lines)


def liveness(fn: Callable, *args: Any, **kwargs: Any) -> tuple[np.ndarray, np.ndarray]:
    """Live bytes over the run of `fn(*args, **kwargs)`: (steps, live
    bytes), step i being the i-th operator dispatched and its live bytes
    those of the arguments' storages and of every storage created so far
    and not yet freed, after that operator (the JAX package's curve over
    HLO instructions, counted as `memory_report` counts)."""
    _, arguments, counter = _run_counted(fn, args, kwargs)
    delta = np.zeros(counter.ops + 1, np.int64)
    for op, _, nbytes in counter.events:
        # a storage freed by operator i+1 (before it returns) was live
        # after operator i; frees between operators go to the next one
        delta[min(op, counter.ops)] += nbytes
    live = sum(arguments.values()) + np.cumsum(delta)[: max(counter.ops, 1)]
    return np.arange(len(live)), live


def plot_liveness(curves: dict[str, tuple], path: str, *, title: str = "live bytes over operators") -> None:
    """Write a liveness comparison plot (e.g. {'flash': ..., 'dense': ...}).
    matplotlib is imported here, so that the package needs it only for
    this."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    for label, (steps, live) in curves.items():
        ax.plot(steps, np.asarray(live) / (1024 * 1024), label=label)
    ax.set_xlabel("operator index (dispatch order)")
    ax.set_ylabel("live MB")
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler run (CPU activity, and the card's where there is
    one) around the block; on exit a Chrome trace goes to
    `log_dir/trace.json` (chrome://tracing, Perfetto).  Yields the
    profiler, for `device_time`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Kinds of device work in a training step, by kernel name (first match).
STEP_KINDS = (
    ("K1", re.compile(r"flash_fwd_ws_kernel")),
    ("K2/K3 + pre-pass", re.compile(r"flash_bwd_")),
    ("cuBLAS", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|cublas", re.I)),
    ("copies", re.compile(r"^mem(cpy|set)", re.I)),
)


def device_time(prof, steps: int) -> tuple[float, dict, dict] | None:
    """From a torch.profiler run over `steps` steps: device-busy ms a step
    (the union of the device's kernel and copy intervals), ms a step by kind
    (STEP_KINDS) and by kernel name; None when no device event was
    recorded.  Device-side copies of CPU ranges (user annotations such as
    the optimizer step's) span kernels and gaps, so only kernels, copies and
    sets count."""
    from torch.autograd import DeviceType

    cpu_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in cpu_names]
    if not dev:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):  # the union of the intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kinds = {name: 0.0 for name, _ in STEP_KINDS}
    kinds["elementwise and other"] = 0.0
    top: dict[str, float] = {}
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        kinds[next((name for name, rx in STEP_KINDS if rx.search(e.name)), "elementwise and other")] += ms
        top[e.name] = top.get(e.name, 0.0) + ms
    return busy / 1e3 / steps, kinds, top


def flops_estimate(fn: Callable, *args: Any) -> float | None:
    """FLOPs of `fn(*args)` as `FlopCounterMode` counts them (matrix
    products and convolutions), or None when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
