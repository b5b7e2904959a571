"""Inference engine: continuous batching over prefill and decode scans.

Port of `flash_attention_tpu/inference/engine.py`, for a `GPT` or a
`Llama` module:

  submit(prompt) -> request queue
  step():
    1. admit queued requests into free slots: same-bucket prompts are
       prefilled together (prefill_many, GPT only; with a custom prefill_fn
       one prompt per dispatch) and their first tokens sampled in one
       batch;
    2. one decode scan of up to `scan_steps` steps across all running
       slots, sampling on the device, then one host sync for the scan's
       [steps, slots] token block;
    3. retire finished requests (eos, max_new_tokens, cache full).

The engine takes the JAX engine's `kv_quant_dtype` (an int8 or fp8 KV
cache), `prefill_fn` and `decode_fn` (e.g. `prefill_fn=llama.prefill,
decode_fn=llama.decode_step` for a Llama, or `partial(decode_step,
attn_impl="paged")` for a GPT).  Options of the JAX engine that the port
does not have yet are absent from the constructor (chunked prefill,
scan_tokens_target, pipelined scans, speculative decoding, autotune
warm-up), so passing one is a TypeError.  The drain after each scan is
synchronous.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..quant.kv import QUANT_DTYPES
from . import kv_cache as kvc
from .model_runner import decode_step, prefill, prefill_many
from .sampling import sample_tokens


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    top_k: int | None = None
    top_p: float | None = None  # nucleus sampling (1.0 disables)
    eos_id: int | None = None
    # streaming: called with (request, token) as the scheduler accepts tokens
    on_token: Callable | None = None
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: float | None = None
    finish_time: float | None = None

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


def _quant_dtype(dtype: torch.dtype | str | None) -> torch.dtype | None:
    """A KV payload dtype given as a torch dtype or by its name."""
    if dtype is None or dtype in QUANT_DTYPES:
        return dtype
    by_name = {str(d).removeprefix("torch."): d for d in QUANT_DTYPES}
    if dtype not in by_name:
        raise ValueError(f"kv_quant_dtype must be one of {sorted(by_name)} or None, got {dtype!r}")
    return by_name[dtype]


def _buckets(max_len: int) -> list[int]:
    out, b = [], 64
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class InferenceEngine:
    """Continuous-batching engine over a `GPT` or `Llama` module."""

    def __init__(
        self,
        model: nn.Module,
        *,
        slots: int = 8,
        max_len: int | None = None,
        kv_quant_dtype: torch.dtype | str | None = None,
        rng_seed: int = 0,
        prefill_fn: Callable | None = None,
        decode_fn: Callable | None = None,
        scan_steps: int = 8,
        device=None,
    ):
        """model: the GPT or Llama to serve; its weights must already lie on
        `device` (default: the model's own device).  A "cuda" device without
        a card raises.  max_len: the cache's capacity per slot, default the
        config's block_size (GPT) or max_seq (Llama).  kv_quant_dtype: store
        the KV cache as int8 or fp8 payloads with per-token scales
        (torch.int8 / torch.float8_e4m3fn, or their names "int8" /
        "float8_e4m3fn").  prefill_fn(model, tokens, cache, slot, length) ->
        (cache, logits) replaces `prefill`, and then every prompt is admitted
        in a dispatch of its own (batched admission is GPT's
        `prefill_many`).  decode_fn(model, tokens, cache, active) -> (cache,
        logits) replaces `decode_step`, e.g. `functools.partial(decode_step,
        attn_impl="fused")`.  A Llama needs both (`llama.prefill`,
        `llama.decode_step`).  scan_steps:
        decode steps per scan, with one host sync per scan; 1 gives per-token
        stepping.  rng_seed seeds the engine's torch.Generator, which draws
        every sampled token."""
        if device is not None:
            want = resolve_device(device)
            if want.type != model.device.type or (want.index is not None and want != model.device):
                raise ValueError(f"model weights are on {model.device}, engine asked for {want}")
        self.device = model.device
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.max_len = max_len or getattr(self.cfg, "block_size", None) or self.cfg.max_seq
        kv_heads = self.cfg.kv_heads if hasattr(self.cfg, "kv_heads") else self.cfg.n_kv_head
        self.cache = kvc.init_cache(
            self.cfg.n_layer, slots, kv_heads, self.max_len, self.cfg.head_dim,
            dtype=self.cfg.dtype, quant_dtype=_quant_dtype(kv_quant_dtype), device=model.device,
        )
        self._prefill = prefill_fn or prefill
        # batched same-bucket admission: the GPT path only
        self._batched_admission = prefill_fn is None
        self._decode = decode_fn or decode_step
        self.buckets = _buckets(self.max_len)
        self.scan_steps = max(1, scan_steps)
        self.queue: deque[Request] = deque()
        self.running: dict[int, Request] = {}  # slot -> request
        self.finished: list[Request] = []
        # Next input token of every slot, kept on the device between scans.
        self._next_tokens_dev = torch.zeros(slots, dtype=torch.int32, device=model.device)
        # (active, temps, topks, topps, sampling, use_top_p), rebuilt when the
        # running set changes.
        self._slot_cfg = None
        self._uid = 0
        self._gen = torch.Generator(device=model.device).manual_seed(rng_seed)
        self.stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict:
        return {"decode_steps": 0, "prefills": 0, "prefill_dispatches": 0, "tokens_out": 0}

    # ------------------------------------------------------------- public API

    def submit(
        self,
        prompt: list[int],
        *,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        eos_id: int | None = None,
        on_token: Callable | None = None,
    ) -> int:
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        self._uid += 1
        self.queue.append(
            Request(
                uid=self._uid,
                prompt=list(prompt),
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                eos_id=eos_id,
                on_token=on_token,
                submit_time=time.time(),
            )
        )
        return self._uid

    def run(self, progress: Callable[[dict], None] | None = None) -> list[Request]:
        """Drive until queue and running set are drained; returns the
        finished requests."""
        while self.queue or self.running:
            self.step()
            if progress:
                progress(self.stats)
        return self.finished

    def step(self) -> None:
        """One scheduler step: admit, then one decode scan and its drain."""
        self._admit()
        if self.running:
            self._decode_all()

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    # ---------------------------------------------------------------- private

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_len {self.max_len}")

    def _admit(self) -> None:
        # Rounds repeat while requests finish on their first token and
        # free their slot for the next queued prompt.
        while self._admit_round():
            pass

    def _admit_round(self) -> bool:
        """Fill free slots, batching same-bucket prompts into one prefill
        (batch sizes are powers of two).  Returns True if a slot was freed
        again by a request that finished on its first token."""
        free = [s for s in range(self.slots) if s not in self.running]
        batch: list[tuple[int, Request, int, int]] = []
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            n = len(req.prompt)
            if n >= self.max_len:
                req.prompt = req.prompt[-(self.max_len - 1):]
                n = len(req.prompt)
            batch.append((slot, req, n, self._bucket_len(n)))
        refreed = False
        groups: dict[int, list] = {}
        for item in batch:
            groups.setdefault(item[3], []).append(item)
        for bucket, items in groups.items():
            while items:
                # the largest power of two, or one prompt a dispatch
                m = 1 << (len(items).bit_length() - 1) if self._batched_admission else 1
                chunk, items = items[:m], items[m:]
                # Right-pad with the last token; logits come from the true
                # last position and the cache length is set directly.
                toks = np.zeros((m, bucket), np.int64)
                for i, (slot, req, n, _) in enumerate(chunk):
                    toks[i, :n] = req.prompt
                    toks[i, n:] = req.prompt[-1]
                toks_dev = torch.from_numpy(toks).to(self.device)
                slot_list = [it[0] for it in chunk]
                len_list = [it[2] for it in chunk]
                if m == 1:
                    self.cache, logits = self._prefill(self.model, toks_dev[0], self.cache, slot_list[0], len_list[0])
                    logits = logits[None]
                else:
                    self.cache, logits = prefill_many(self.model, toks_dev, self.cache, slot_list, len_list)
                self.stats["prefill_dispatches"] += 1
                first_dev, first_host = self._first_tokens([it[1] for it in chunk], logits)
                self._next_tokens_dev[torch.as_tensor(slot_list, device=self.device)] = first_dev.to(torch.int32)
                for i, (slot, req, n, _) in enumerate(chunk):
                    if not self._finish_admission(slot, req, int(first_host[i])):
                        refreed = True
        return refreed and bool(self.queue)

    def _first_tokens(self, reqs: list[Request], logits: torch.Tensor):
        """Sample every admitted request's first token in one batch:
        logits [m, vocab] -> (device tokens [m], host tokens [m])."""
        temps = np.array([r.temperature for r in reqs], np.float32)
        if (temps > 0.0).any():
            vocab = logits.shape[-1]
            topks = np.array([r.top_k if r.top_k is not None else vocab for r in reqs], np.int64)
            use_top_p = any(r.top_p is not None and r.top_p < 1.0 for r in reqs)
            topps = (
                torch.tensor([r.top_p if r.top_p is not None else 1.0 for r in reqs], device=self.device)
                if use_top_p
                else None
            )
            toks = sample_tokens(
                logits, self._gen,
                torch.from_numpy(temps).to(self.device),
                torch.from_numpy(topks).to(self.device),
                topps,
            )
        else:
            toks = torch.argmax(logits, dim=-1)
        return toks, toks.cpu().numpy()

    def _finish_admission(self, slot: int, req: Request, tok: int) -> bool:
        """Record the prompt's first token and move the request into the
        running set.  Returns False if it already finished (eos, or
        max_new_tokens <= 1)."""
        req.first_token_time = time.time()
        req.output.append(tok)
        if req.on_token is not None:
            req.on_token(req, tok)
        self._slot_cfg = None
        self.stats["prefills"] += 1
        self.stats["tokens_out"] += 1
        if (req.eos_id is not None and tok == req.eos_id) or req.max_new_tokens <= 1:
            req.finish_time = time.time()
            self.finished.append(req)
            return False
        self.running[slot] = req
        return True

    def _slot_config(self):
        if self._slot_cfg is None:
            active = np.zeros((self.slots,), bool)
            temps = np.zeros((self.slots,), np.float32)
            topks = np.full((self.slots,), self.cfg.vocab_size, np.int64)
            topps = np.ones((self.slots,), np.float32)
            for s, req in self.running.items():
                active[s] = True
                temps[s] = req.temperature
                if req.top_k is not None:
                    topks[s] = req.top_k
                if req.top_p is not None:
                    topps[s] = req.top_p
            dev = self.device
            self._slot_cfg = (
                torch.from_numpy(active).to(dev),
                torch.from_numpy(temps).to(dev),
                torch.from_numpy(topks).to(dev),
                torch.from_numpy(topps).to(dev),
                bool((temps > 0).any()),
                bool((topps < 1.0).any()),
            )
        return self._slot_cfg

    def _scan_length(self) -> int:
        """Steps for the next scan: never past every running request's
        remaining budget, and, under a shallow queue (an arrival burst),
        only up to the nearest predictable retirement, so that the queued
        request is admitted sooner.  Powers of two."""
        rems = [r.max_new_tokens - len(r.output) for r in self.running.values()]
        max_rem = max(max(rems), 1)
        steps = max(1, min(self.scan_steps, 1 << (max_rem - 1).bit_length()))
        shallow = 0 < len(self.queue) <= max(2, self.slots // 4)
        if shallow:
            rem = min(rems)
            if rem < steps:
                steps = max(1, 1 << (max(rem, 1).bit_length() - 1))
        return steps

    def _decode_all(self) -> None:
        """Generate up to scan_steps tokens per running slot, sampling on the
        device, with one host sync at the end of the scan.  Requests that
        finish mid-scan over-generate until it ends; the surplus is dropped
        when the block is drained."""
        active, temps, topks, topps, sampling, use_top_p = self._slot_config()
        steps = self._scan_length()
        toks = self._next_tokens_dev
        block = []
        for _ in range(steps):
            self.cache, logits = self._decode(self.model, toks, self.cache, active)
            if sampling:
                nxt = sample_tokens(logits, self._gen, temps, topks, topps if use_top_p else None)
            else:
                nxt = torch.argmax(logits, dim=-1)
            toks = nxt.to(torch.int32)
            block.append(toks)
        self._next_tokens_dev = toks
        self.stats["decode_steps"] += steps
        slot_reqs = list(self.running.items())
        self._drain_tokens(torch.stack(block).cpu().numpy(), steps, slot_reqs)

    def _drain_tokens(self, toks: np.ndarray, steps: int, slot_reqs) -> None:
        """Host bookkeeping for one scan's [steps, slots] token block:
        append tokens, stream callbacks, retire finished requests."""
        done: list[int] = []
        for slot, req in slot_reqs:
            finished = False
            for step in range(steps):
                tok = int(toks[step, slot])
                req.output.append(tok)
                if req.on_token is not None:
                    req.on_token(req, tok)
                self.stats["tokens_out"] += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                cache_full = len(req.prompt) + len(req.output) >= self.max_len
                if len(req.output) >= req.max_new_tokens or hit_eos or cache_full:
                    finished = True
                    break
            if finished:
                req.finish_time = time.time()
                self.finished.append(req)
                done.append(slot)
        for slot in done:
            del self.running[slot]
        if done:
            self._slot_cfg = None
