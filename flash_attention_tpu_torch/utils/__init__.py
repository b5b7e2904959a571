"""Host-side utilities for the CUDA port: timing, profiling, patching,
device discovery."""

from .devices import device_info
from .measure import ab_compare, chain_timer
from .patching import patch_function, unpatch_function
from .profiling import MemoryReport, compare_memory, flops_estimate, memory_report, trace

__all__ = [
    "MemoryReport",
    "ab_compare",
    "chain_timer",
    "compare_memory",
    "device_info",
    "flops_estimate",
    "memory_report",
    "patch_function",
    "trace",
    "unpatch_function",
]
