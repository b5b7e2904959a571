"""Data loading: native char tokenizer + batch sampler with NumPy fallback.

Port of `flash_attention_tpu/data/loader.py`, which is plain numpy but
cannot be imported without JAX (its package's `__init__` imports the
Pallas kernels).  The same optional ctypes load of
`build/libfat_dataloader.so` (built by the repository's Makefile) with the
NumPy fallback, so both packages cut the same crops for a seed; only
`batch_iterator` differs, yielding torch tensors on a chosen device.
`synthetic_corpus` is the JAX demo's corpus generator (demo/train.py),
byte for byte.
"""

from __future__ import annotations

import ctypes
import logging
import pathlib

import numpy as np
import torch

from ..config import resolve_device

logger = logging.getLogger(__name__)

_LIB = None
_LIB_TRIED = False


def _candidate_paths() -> list[pathlib.Path]:
    root = pathlib.Path(__file__).resolve().parents[2]
    return [
        root / "build" / "libfat_dataloader.so",
        pathlib.Path(__file__).resolve().parent / "libfat_dataloader.so",
    ]


def load_native_library() -> ctypes.CDLL | None:
    """Load the native data loader, or None (NumPy fallback) if unbuilt."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    for path in _candidate_paths():
        if path.exists():
            try:
                lib = ctypes.CDLL(str(path))
                if lib.fat_dataloader_abi_version() != 1:
                    logger.warning("native dataloader ABI mismatch at %s", path)
                    continue
                u8 = ctypes.POINTER(ctypes.c_uint8)
                u16 = ctypes.POINTER(ctypes.c_uint16)
                lib.fat_build_vocab.argtypes = [u8, ctypes.c_uint64, u8]
                lib.fat_build_vocab.restype = ctypes.c_int
                lib.fat_encode.argtypes = [u8, ctypes.c_uint64, u8, ctypes.c_int, u16]
                lib.fat_decode.argtypes = [u16, ctypes.c_uint64, u8, ctypes.c_int, u8]
                lib.fat_sample_batch.argtypes = [
                    u16, ctypes.c_uint64, ctypes.c_uint64,
                    ctypes.c_int, ctypes.c_int, u16, u16,
                ]
                _LIB = lib
                logger.info("loaded native dataloader from %s", path)
                return _LIB
            except OSError as exc:  # pragma: no cover
                logger.warning("failed to load %s: %s", path, exc)
    logger.info(
        "native dataloader not built (tried %s); using NumPy fallback",
        [str(p) for p in _candidate_paths()],
    )
    return None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


class CharTokenizer:
    """Character-level tokenizer built from a corpus (NanoGPTTokenizer role)."""

    def __init__(self, text: str | bytes):
        data = text.encode() if isinstance(text, str) else bytes(text)
        arr = np.frombuffer(data, np.uint8)
        lib = load_native_library()
        if lib is not None:
            vocab = np.zeros(256, np.uint8)
            vs = lib.fat_build_vocab(_u8(arr), arr.size, _u8(vocab))
            self.vocab = vocab[:vs].copy()
        else:
            self.vocab = np.unique(arr)
        self._lut = np.zeros(256, np.uint16)
        self._lut[self.vocab] = np.arange(self.vocab.size, dtype=np.uint16)

    @property
    def vocab_size(self) -> int:
        return int(self.vocab.size)

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode() if isinstance(text, str) else bytes(text)
        arr = np.frombuffer(data, np.uint8)
        lib = load_native_library()
        if lib is not None:
            out = np.zeros(arr.size, np.uint16)
            lib.fat_encode(
                _u8(arr), arr.size, _u8(self.vocab), self.vocab_size, _u16(out)
            )
            return out
        return self._lut[arr]

    def decode(self, ids: np.ndarray) -> str:
        ids = np.asarray(ids, np.uint16)
        lib = load_native_library()
        if lib is not None:
            out = np.zeros(ids.size, np.uint8)
            lib.fat_decode(
                _u16(ids), ids.size, _u8(self.vocab), self.vocab_size, _u8(out)
            )
            return out.tobytes().decode(errors="replace")
        return self.vocab[np.clip(ids, 0, self.vocab_size - 1)].tobytes().decode(
            errors="replace"
        )


def save_bin(path, ids: np.ndarray) -> None:
    """Write token ids as a raw uint16 .bin (nanoGPT's train.bin format —
    the reference mmaps exactly this, demo/train.py:175-180).  Ids must fit
    uint16; a >=64k vocab (e.g. Llama-3 BPE) would otherwise silently wrap
    and corrupt the corpus."""
    arr = np.asarray(ids)
    if arr.size and (arr.min() < 0 or arr.max() > np.iinfo(np.uint16).max):
        raise ValueError(
            f"token ids outside uint16 range [{arr.min()}, {arr.max()}]: "
            "the .bin format stores uint16; use a <=65536-entry vocab"
        )
    arr.astype(np.uint16).tofile(str(path))


def load_bin(path) -> np.ndarray:
    """Memory-map a uint16 token .bin: corpora larger than RAM stream
    through sample_batch without a copy (np.memmap is contiguous, so the
    native sampler reads pages straight from the file cache)."""
    return np.memmap(str(path), dtype=np.uint16, mode="r")


def sample_batch(
    data: np.ndarray, seed: int, batch: int, block: int
) -> tuple[np.ndarray, np.ndarray]:
    """Random next-token crops: x [batch, block], y shifted by one
    (reference get_batch, demo/train.py:175-188).  Deterministic in seed."""
    data = np.ascontiguousarray(data, np.uint16)
    if data.size <= block:
        raise ValueError(
            f"corpus has {data.size} tokens but block={block} crops need at "
            "least block+1 tokens"
        )
    lib = load_native_library()
    if lib is not None:
        x = np.zeros((batch, block), np.uint16)
        y = np.zeros((batch, block), np.uint16)
        lib.fat_sample_batch(
            _u16(data), data.size, seed, batch, block, _u16(x), _u16(y)
        )
        return x.astype(np.int32), y.astype(np.int32)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, data.size - block - 1, size=batch)
    x = np.stack([data[s : s + block] for s in starts])
    y = np.stack([data[s + 1 : s + block + 1] for s in starts])
    return x.astype(np.int32), y.astype(np.int32)


def batch_iterator(data: np.ndarray, batch: int, block: int, *, seed: int = 0, device=None):
    """Infinite iterator of (x, y) torch.long batches on `device` for
    Trainer.fit: step i crops with seed + i.  device: default the card
    ("cuda", which raises here, at the call, without one); "cpu" when asked
    for."""
    device = resolve_device(device)

    def batches():
        step = 0
        while True:
            x, y = sample_batch(data, seed + step, batch, block)
            yield (
                torch.from_numpy(x).to(device=device, dtype=torch.long),
                torch.from_numpy(y).to(device=device, dtype=torch.long),
            )
            step += 1

    return batches()


def synthetic_corpus(n_chars: int = 200_000, seed: int = 0) -> str:
    """Deterministic pseudo-prose with word/sentence structure so a char LM
    has something to learn (bigram statistics, spaces, punctuation)."""
    rng = np.random.default_rng(seed)
    words = [
        "the", "of", "and", "to", "in", "attention", "is", "all", "you",
        "need", "flash", "tpu", "kernel", "memory", "chunk", "softmax",
        "query", "key", "value", "causal", "mask", "online", "block",
    ]
    out: list[str] = []
    total = 0
    while total < n_chars:
        sent_len = int(rng.integers(4, 12))
        sent = " ".join(rng.choice(words, sent_len))
        sent = sent.capitalize() + ". "
        out.append(sent)
        total += len(sent)
    return "".join(out)
