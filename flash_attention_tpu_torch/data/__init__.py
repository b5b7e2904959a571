"""Data layer: native tokenizer/sampler with NumPy fallback."""

from .loader import (
    CharTokenizer,
    batch_iterator,
    load_bin,
    load_native_library,
    sample_batch,
    save_bin,
    synthetic_corpus,
)

__all__ = [
    "CharTokenizer",
    "batch_iterator",
    "load_bin",
    "load_native_library",
    "sample_batch",
    "save_bin",
    "synthetic_corpus",
]
