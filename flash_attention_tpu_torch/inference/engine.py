"""Inference engine: continuous batching over prefill and decode scans.

Port of `flash_attention_tpu/inference/engine.py`, for a `GPT` or a
`Llama` module:

  submit(prompt) -> request queue
  step():
    1. admit queued requests into free slots: same-bucket prompts are
       prefilled together (prefill_many, GPT only; with a custom prefill_fn
       one prompt per dispatch) and their first tokens sampled in one
       batch; with `chunk_prefill`, a longer prompt is admitted one chunk
       per step instead (`prefill_chunk`), between decode scans;
    2. one decode scan of up to `scan_steps` steps across the running
       slots, sampling on the device; with a draft model, greedy slots
       take a round of speculative decoding instead
       (`speculative_decode_loop`) and sampled slots the scan;
    3. drain the scan's [steps, slots] token block on the host and retire
       finished requests (eos, max_new_tokens, cache full).  With
       `pipeline_scans` the drain of one scan waits until the next scan's
       launches are enqueued.

The constructor takes every option of the JAX engine's, `model` in place of
its `params` + `cfg` and `draft_model` in place of `draft_params` +
`draft_cfg`: `kv_quant_dtype` (an int8 or fp8 KV cache), `prefill_fn` and
`decode_fn` (e.g. `prefill_fn=llama.prefill, decode_fn=llama.decode_step`
for a Llama, or `partial(decode_step, attn_impl="paged")` for a GPT),
`chunk_prefill` / `prefill_chunk_fn`, `scan_tokens_target`,
`pipeline_scans` (default False, where the JAX engine's is True) and the
speculative options `draft_model`, `spec_k`, `spec_adaptive`,
`spec_min_accept`, `spec_retrial_every` and `spec_reopen_margin`.
`warmup_autotune` tunes the flash-attention tiles of whole-prompt prefill
at each bucket, as the JAX engine's does.  Stats keep the JAX
engine's keys and meanings, and add `prefill_dispatches` (whole-prompt
target prefills), `draft_dispatches` (draft prefills at admission, at a
chunked prompt's end and for resyncs) and `decode_scans` (regular scans).
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
from .model_runner import decode_step, prefill, prefill_chunk, prefill_many
from .sampling import sample, sample_tokens
from .speculative import gather_tokens, speculative_decode_loop


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


def _padded(seqs: list[list[int]], width: int) -> np.ndarray:
    """Token rows [len(seqs), width], each right-padded with its last
    token (prefill takes the logits at the true last position and sets the
    cache length directly)."""
    toks = np.zeros((len(seqs), width), np.int64)
    for i, seq in enumerate(seqs):
        toks[i, : len(seq)] = seq
        toks[i, len(seq):] = seq[-1]
    return toks


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


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
        scan_tokens_target: int | None = None,
        chunk_prefill: int | None = None,
        prefill_chunk_fn: Callable | None = None,
        draft_model: nn.Module | None = None,
        spec_k: int = 4,
        spec_adaptive: bool = False,
        spec_min_accept: float | None = None,
        spec_retrial_every: int = 128,
        spec_reopen_margin: float | None = None,
        pipeline_scans: bool = False,
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
        `llama.decode_step`).  rng_seed seeds the engine's torch.Generator,
        which draws every sampled token.

        scan_steps: decode steps per scan, with one host drain per scan; 1
        gives per-token stepping.  scan_tokens_target: cap each scan so that
        running slots x steps stays at or under this many tokens (steps a
        power of two); None keeps scan_steps.

        chunk_prefill: admit a prompt longer than this in chunks of this
        many tokens, one chunk per scheduler step between decode scans, so
        that a long prompt does not hold up the running streams.  A custom
        prefill_fn needs a matching `prefill_chunk_fn(model, tokens, cache,
        slot, start, length)` (e.g. `llama.prefill_chunk`); without one,
        chunk_prefill raises ValueError.  Chunks run the dense offset
        attention, not the flash kernel.

        draft_model: a GPT that drafts for speculative decoding (the GPT
        path only: with prefill_fn or decode_fn it raises ValueError).  Its
        cache is unquantized, in the draft's dtype.  Routing is per slot:
        greedy requests decode through `speculative_decode_loop` (the draft
        proposes spec_k tokens, the target verifies them in one forward),
        sampled ones through the regular scan.  Greedy outputs equal the
        plain engine's (exactly in fp32; see speculative.py).
        spec_adaptive: keep an EMA (0.7 old, 0.3 new) of the tokens a
        speculative iteration emits and retreat to the regular scan when it
        falls below spec_min_accept (default 0.6 * (spec_k + 1)), or at once
        when one of the first two rounds emits under half of it; after a
        retreat admissions skip the draft prefill and scans are pipelined
        (when pipeline_scans is on).  spec_retrial_every: after a retreat,
        one speculative trial round (resyncing the draft's stale slots
        first) every that many regular scans; the gate re-opens if the
        trial's mean clears spec_min_accept + spec_reopen_margin (default
        0.1 * (spec_k + 1)), and each failed trial doubles the wait.  0
        makes the retreat permanent.

        pipeline_scans: enqueue the next scan's launches before draining the
        previous scan's tokens: on the card the token block goes to a
        pinned host buffer with a non-blocking copy and an event, and the
        host waits on that event only after the next scan is enqueued, so
        the copy and the bookkeeping overlap the device's work.  A request
        that finishes is seen one scan late (its surplus tokens are
        dropped).  Speculative rounds are never pipelined.  Default False,
        where the JAX engine's default is True: its reason was the dispatch
        latency of the TPU's remote runtime, and on the H100 the default
        waits for the card's measurements.  Greedy outputs do not depend
        on it.  On the CPU the same code runs and the copy is synchronous.
        """
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
        self.scan_tokens_target = scan_tokens_target

        self.chunk_prefill = chunk_prefill
        self._prefill_chunk = prefill_chunk_fn or (prefill_chunk if prefill_fn is None else None)
        if chunk_prefill is not None and self._prefill_chunk is None:
            raise ValueError("chunk_prefill with a custom prefill_fn needs prefill_chunk_fn")

        self.draft_model = draft_model
        self.spec_k = spec_k
        self.spec_adaptive = spec_adaptive
        self.spec_min_accept = spec_min_accept if spec_min_accept is not None else 0.6 * (spec_k + 1)
        self.spec_retrial_every = max(0, spec_retrial_every)
        self.spec_reopen_margin = spec_reopen_margin if spec_reopen_margin is not None else 0.1 * (spec_k + 1)
        self._n_spec_iters = max(1, self.scan_steps // (spec_k + 1))
        self.reset_spec_state()
        if draft_model is not None:
            if prefill_fn is not None or decode_fn is not None:
                raise ValueError("speculative decoding is wired for the GPT path only")
            if draft_model.device != model.device:
                raise ValueError(f"draft weights are on {draft_model.device}, the model's on {model.device}")
            dcfg = draft_model.cfg
            self.draft_cache = kvc.init_cache(
                dcfg.n_layer, slots, dcfg.kv_heads, self.max_len, dcfg.head_dim, dtype=dcfg.dtype,
                device=model.device,
            )
            # Slots whose draft cache lags the target's (they decoded through
            # the regular scan): re-prefilled before their next speculative
            # round, which would otherwise propose from stale rows.
            self._draft_stale: set[int] = set()

        self.queue: deque[Request] = deque()
        self.running: dict[int, Request] = {}  # slot -> request
        self.prefilling: dict[int, list] = {}  # slot -> [request, next position]
        self.finished: list[Request] = []
        # Next input token of every slot, kept on the device between scans.
        self._next_tokens_dev = torch.zeros(slots, dtype=torch.int32, device=model.device)
        # (decode slots, active, temps, topks, topps, sampling, use_top_p),
        # rebuilt when the running set or the slots a scan decodes change.
        self._slot_cfg = None
        # A scan whose token block is still on its way to the host
        # (pipeline_scans): (host tokens, copy event or None, steps, slot_reqs).
        self._pending = None
        self.pipeline_scans = pipeline_scans
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
        """Drive until the queue, the prefilling and running sets and the
        pending scan are drained; returns the finished requests."""
        while self.queue or self.running or self.prefilling or self._pending is not None:
            self.step()
            if progress:
                progress(self.stats)
        return self.finished

    def step(self) -> None:
        """One scheduler step: admit, advance the chunked prefills, one
        decode round.  With a pending scan (pipeline_scans), the round's
        launches are enqueued first and the pending scan drained after them;
        a speculative trial round appends tokens on the host at once, so
        the pending scan, whose tokens come first, is drained before it."""
        self._admit()
        self._advance_prefills()
        prev, self._pending = self._pending, None
        if prev is not None and self._spec_trial_due():
            self._drain_pending(prev)
            prev = None
        if self.running:
            self._decode_all()
        if prev is not None:
            self._drain_pending(prev)

    def warmup_autotune(self, buckets: list[int] | None = None) -> None:
        """Tune the attention tiles of the engine's whole-prompt prefill
        shapes (b=1, the model's heads) on the engine's device and cache
        them (kernels/autotune.py), so that prefill's flash_attention uses
        the winners.  One sweep per bucket per device, kept in the cache
        file; batched prefill_many shapes keep the defaults (the batch is
        part of the key).

        buckets: bucket lengths to tune; default every admission bucket of
        at least MIN_BLOCK (shorter prompts take dense attention on the
        CPU)."""
        from ..kernels.autotune import autotune_for_model
        from ..kernels.block_sizes import MIN_BLOCK

        for bucket in buckets if buckets is not None else self.buckets:
            if bucket >= MIN_BLOCK:
                autotune_for_model(self.cfg, 1, seq_len=bucket, device=self.device)

    def reset_stats(self) -> None:
        self.stats = self._zero_stats()

    def reset_spec_state(self) -> None:
        """Restore the adaptive speculation gate to its optimistic start
        (after a warm-up run that tripped the retreat)."""
        self._spec_accept_ema = float(self.spec_k + 1)
        self._spec_enabled = True
        self._scans_since_retreat = 0
        self._spec_retrial_interval = self.spec_retrial_every

    # ---------------------------------------------------------------- private

    def _count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_len {self.max_len}")

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self) -> None:
        # Rounds repeat while requests finish on their first token and
        # free their slot for the next queued prompt.
        while self._admit_round():
            pass

    def _admit_round(self) -> bool:
        """Fill free slots, batching same-bucket prompts into one prefill
        (batch sizes are powers of two); a prompt longer than chunk_prefill
        joins the prefilling set instead.  Returns True if a slot was freed
        again by a request that finished on its first token."""
        free = [s for s in range(self.slots) if s not in self.running and s not in self.prefilling]
        batch: list[tuple[int, Request, int, int]] = []
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            n = len(req.prompt)
            if n >= self.max_len:
                req.prompt = req.prompt[-(self.max_len - 1):]
                n = len(req.prompt)
            if self.chunk_prefill is not None and n > self.chunk_prefill:
                self.prefilling[slot] = [req, 0]
                continue
            batch.append((slot, req, n, self._bucket_len(n)))
        refreed = False
        groups: dict[int, list] = {}
        for item in batch:
            groups.setdefault(item[3], []).append(item)
        for bucket, items in groups.items():
            while items:
                # the largest power of two, or one prompt a dispatch
                m = _pow2_floor(len(items)) if self._batched_admission else 1
                chunk, items = items[:m], items[m:]
                toks_dev = self._to_dev(_padded([it[1].prompt for it in chunk], bucket))
                slot_list = [it[0] for it in chunk]
                len_list = [it[2] for it in chunk]
                if m == 1:
                    self.cache, logits = self._prefill(self.model, toks_dev[0], self.cache, slot_list[0], len_list[0])
                    logits = logits[None]
                else:
                    self.cache, logits = prefill_many(self.model, toks_dev, self.cache, slot_list, len_list)
                self.stats["prefill_dispatches"] += 1
                if self.draft_model is not None and self._spec_enabled:
                    self._draft_prefill(toks_dev, slot_list, len_list)
                    self._count("draft_prefills")
                    self._draft_stale.difference_update(slot_list)
                elif self.draft_model is not None:
                    # Retreated: the draft cache's only reader is a future
                    # trial round, which resyncs stale slots itself.
                    self._draft_stale.update(slot_list)
                first_dev, first_host = self._first_tokens([it[1] for it in chunk], logits)
                self._next_tokens_dev[torch.as_tensor(slot_list, device=self.device)] = first_dev.to(torch.int32)
                for i, (slot, req, n, _) in enumerate(chunk):
                    if not self._finish_admission(slot, req, int(first_host[i])):
                        refreed = True
        return refreed and bool(self.queue)

    def _draft_prefill(self, toks_dev: torch.Tensor, slot_list: list[int], len_list: list[int]) -> None:
        """Prefill the draft cache's slots with bucket-padded rows [m, T]
        (one dispatch, batched when m > 1)."""
        if len(slot_list) == 1:
            self.draft_cache, _ = prefill(self.draft_model, toks_dev[0], self.draft_cache, slot_list[0], len_list[0])
        else:
            self.draft_cache, _ = prefill_many(self.draft_model, toks_dev, self.draft_cache, slot_list, len_list)
        self._count("draft_dispatches")

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
            toks = sample_tokens(logits, self._gen, self._to_dev(temps), self._to_dev(topks), topps)
        else:
            toks = torch.argmax(logits, dim=-1)
        return toks, toks.cpu().numpy()

    def _finish_admission(self, slot: int, req: Request, tok: int) -> bool:
        """Record the prompt's first token and move the request into the
        running set (whole-prompt and chunked admission alike; the caller
        samples the token and updates the device's token carry).  Returns
        False if it already finished (eos, or max_new_tokens <= 1)."""
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

    def _advance_prefills(self) -> None:
        """One chunk for every prefilling slot; a prompt whose last chunk
        ran samples its first token and joins the running set."""
        c = self.chunk_prefill
        for slot in list(self.prefilling):
            req, pos = self.prefilling[slot]
            n = len(req.prompt)
            # The fixed-width final chunk must not cross the capacity (the
            # cache write would clamp its start and overwrite real rows with
            # padding): shift it back to end at max_len.  The rows it covers
            # again are rewritten with their own tokens.
            start = min(pos, self.max_len - c)
            valid = min(c, n - start)
            toks = np.full((c,), req.prompt[-1], np.int64)
            toks[:valid] = req.prompt[start:start + valid]
            self.cache, logits = self._prefill_chunk(self.model, self._to_dev(toks), self.cache, slot, start, valid)
            self._count("prefill_chunks")
            pos = start + valid
            if pos < n:
                self.prefilling[slot][1] = pos
                continue
            del self.prefilling[slot]
            if self.draft_model is not None and self._spec_enabled:
                # the draft is small: one whole-prompt prefill at the end
                self._draft_prefill(self._to_dev(_padded([req.prompt], self._bucket_len(n))), [slot], [n])
                self._count("draft_prefills")
                self._draft_stale.discard(slot)
            elif self.draft_model is not None:
                self._draft_stale.add(slot)
            tok = int(sample(logits[None], self._gen, temperature=req.temperature, top_k=req.top_k,
                             top_p=req.top_p)[0])
            self._next_tokens_dev[slot] = tok
            self._finish_admission(slot, req, tok)

    def _resync_draft_slots(self, slots: list[int]) -> None:
        """Re-prefill the draft cache's stale slots among `slots` from their
        accepted history, prompt + output[:-1] (the last output token rides
        in the token carry), batched by bucket through prefill_many.
        speculative_decode_loop needs both caches to hold the same history."""
        stale = sorted(self._draft_stale & set(slots))
        groups: dict[int, list] = {}
        for slot in stale:
            req = self.running[slot]
            hist = req.prompt + req.output[:-1]
            groups.setdefault(self._bucket_len(len(hist)), []).append((slot, hist))
        for bucket, items in groups.items():
            while items:
                m = _pow2_floor(len(items))
                chunk, items = items[:m], items[m:]
                toks_dev = self._to_dev(_padded([h for _, h in chunk], bucket))
                self._draft_prefill(toks_dev, [s for s, _ in chunk], [len(h) for _, h in chunk])
                self._count("draft_resyncs", len(chunk))
        self._draft_stale.clear()

    def _spec_trial_due(self) -> bool:
        """True when the next decode round is a speculative trial: retreated
        under spec_adaptive, with trials on and the backoff interval
        elapsed."""
        return (
            self.draft_model is not None
            and self.spec_adaptive
            and not self._spec_enabled
            and self.spec_retrial_every > 0
            and self._scans_since_retreat >= self._spec_retrial_interval
        )

    def _decode_speculative(self, slots: list[int], trial: bool = False) -> None:
        """One round of the draft-verify loop for the given (greedy) slots;
        the other slots are masked inactive, so the rows the round writes
        for them lie past their lengths.  trial: a re-trial after a retreat,
        which re-opens the gate only if this round's mean clears
        spec_min_accept + spec_reopen_margin and else doubles the wait
        before the next."""
        self._resync_draft_slots(slots)
        active = np.zeros((self.slots,), bool)
        active[slots] = True
        self.cache, self.draft_cache, toks_dev, counts_dev = speculative_decode_loop(
            self.model, self.cache, self.draft_model, self.draft_cache, self._next_tokens_dev,
            self._n_spec_iters, k=self.spec_k, active=self._to_dev(active),
        )
        toks = toks_dev.cpu().numpy()  # [iters, S, k + 1]
        counts = counts_dev.cpu().numpy()  # [iters, S]
        self.stats["decode_steps"] += int(counts.shape[0]) * (self.spec_k + 1)
        self._count("spec_rounds")
        got = counts[:, slots]
        if trial:
            round_mean = float(got.mean()) if got.size else 0.0
            self._count("spec_trials")
            self._scans_since_retreat = 0
            if round_mean >= self.spec_min_accept + self.spec_reopen_margin:
                self._spec_enabled = True
                self._spec_accept_ema = round_mean
                self.stats["spec_accept_ema"] = round(round_mean, 3)
                self.stats["spec_reopened_at_round"] = self.stats["spec_rounds"]
            else:
                self._spec_retrial_interval *= 2
        elif self.spec_adaptive:
            round_mean = float(got.mean()) if got.size else None
            if round_mean is not None:
                self._spec_accept_ema = 0.7 * self._spec_accept_ema + 0.3 * round_mean
            self.stats["spec_accept_ema"] = round(self._spec_accept_ema, 3)
            # A draft under half the threshold in its first two rounds
            # cannot lift the EMA from its optimistic start in time: retreat
            # at once (a trial round can still re-open the gate).
            catastrophic = (
                round_mean is not None and self.stats["spec_rounds"] <= 2 and round_mean < 0.5 * self.spec_min_accept
            )
            if self._spec_accept_ema < self.spec_min_accept or catastrophic:
                self._spec_enabled = False
                self._scans_since_retreat = 0
                self.stats["spec_disabled_at_round"] = self.stats["spec_rounds"]
        done: list[int] = []
        next_toks = self._next_tokens_dev.cpu().numpy().copy()
        for slot in slots:
            req = self.running[slot]
            emitted = gather_tokens(toks, counts, slot)
            finished = False
            for tok in emitted:
                req.output.append(tok)
                if req.on_token is not None:
                    req.on_token(req, tok)
                self.stats["tokens_out"] += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                cache_full = len(req.prompt) + len(req.output) >= self.max_len - self.spec_k - 1
                if len(req.output) >= req.max_new_tokens or hit_eos or cache_full:
                    finished = True
                    break
            if finished:
                req.finish_time = time.time()
                self.finished.append(req)
                done.append(slot)
            elif emitted:
                next_toks[slot] = emitted[-1]
        # A slot that finished mid-round keeps stale lengths; its next
        # admission's prefill resets them.
        self._next_tokens_dev = self._to_dev(next_toks)
        for slot in done:
            del self.running[slot]
        if done:
            self._slot_cfg = None

    def _slot_config(self, decode_slots: list[int]):
        if self._slot_cfg is None or self._slot_cfg[0] != decode_slots:
            active = np.zeros((self.slots,), bool)
            temps = np.zeros((self.slots,), np.float32)
            topks = np.full((self.slots,), self.cfg.vocab_size, np.int64)
            topps = np.ones((self.slots,), np.float32)
            for s in decode_slots:
                req = self.running[s]
                active[s] = True
                temps[s] = req.temperature
                if req.top_k is not None:
                    topks[s] = req.top_k
                if req.top_p is not None:
                    topps[s] = req.top_p
            self._slot_cfg = (
                list(decode_slots),
                self._to_dev(active),
                self._to_dev(temps),
                self._to_dev(topks),
                self._to_dev(topps),
                bool((temps > 0).any()),
                bool((topps < 1.0).any()),
            )
        return self._slot_cfg[1:]

    def _scan_length(self, decode_slots: list[int]) -> int:
        """Steps for the next scan: never past every decoding request's
        remaining budget, at most scan_tokens_target // slots when that is
        set, and, under a shallow queue (an arrival burst) or while prompts
        are prefilling, only up to the nearest predictable retirement, so
        that the waiting request is admitted sooner.  Powers of two."""
        rems = [self.running[s].max_new_tokens - len(self.running[s].output) for s in decode_slots]
        max_rem = max(max(rems), 1)
        steps = max(1, min(self.scan_steps, 1 << (max_rem - 1).bit_length()))
        if self.scan_tokens_target is not None:
            cap = max(1, self.scan_tokens_target // max(len(decode_slots), 1))
            steps = min(steps, _pow2_floor(cap))
        shallow = 0 < len(self.queue) + len(self.prefilling) <= max(2, self.slots // 4)
        if shallow or self.prefilling:
            rem = min(rems)
            if rem < steps:
                steps = _pow2_floor(max(rem, 1))
        return steps

    def _decode_all(self) -> None:
        """Generate up to scan_steps tokens per running slot.  With a draft
        model (and the gate open, or a trial due), greedy slots take a
        speculative round and sampled slots the regular scan.  The scan
        samples on the device; its token block is drained on the host at
        the end, or, pipelined, during the next step.  Requests that finish
        mid-scan over-generate until it ends; the surplus is dropped when
        the block is drained."""
        trial = self._spec_trial_due()
        if self.draft_model is not None and (self._spec_enabled or trial):
            greedy = [s for s, r in self.running.items() if r.temperature <= 0.0]
            sampled = [s for s, r in self.running.items() if r.temperature > 0.0]
            if greedy:
                self._decode_speculative(greedy, trial=trial)
            if not sampled:
                return
            decode_slots = sampled
        else:
            decode_slots = list(self.running)
            if self.draft_model is not None and not self._spec_enabled:
                self._scans_since_retreat += 1  # toward the next trial
        active, temps, topks, topps, sampling, use_top_p = self._slot_config(decode_slots)
        steps = self._scan_length(decode_slots)
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
        if self.draft_model is not None and len(decode_slots) < len(self.running):
            # The scan's last tokens are garbage for the slots outside it
            # (the greedy ones of a mixed batch): keep their carry.
            idx = torch.as_tensor(decode_slots, device=self.device)
            carry = self._next_tokens_dev.clone()
            carry[idx] = toks[idx]
            self._next_tokens_dev = carry
        else:
            self._next_tokens_dev = toks
        if self.draft_model is not None:
            # Regular scans advance only the target cache.
            self._draft_stale.update(decode_slots)
        self.stats["decode_steps"] += steps
        self._count("decode_scans")
        slot_reqs = [(s, self.running[s]) for s in decode_slots]
        host, copied = self._copy_to_host(torch.stack(block))
        # Pipelined only when no speculative round can come in between.
        if (self.draft_model is None or not self._spec_enabled) and self.pipeline_scans:
            self._pending = (host, copied, steps, slot_reqs)
            self._count("pipelined_scans")
        else:
            self._drain_pending((host, copied, steps, slot_reqs))

    @staticmethod
    def _copy_to_host(block: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Start the copy of a token block to the host: on the card into a
        pinned buffer, non-blocking, with an event recorded after it; a CPU
        block is already there."""
        if not block.is_cuda:
            return block, None
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _drain_pending(self, pending) -> None:
        host, copied, steps, slot_reqs = pending
        if copied is not None:
            copied.synchronize()
        self._drain_tokens(host.numpy(), steps, slot_reqs)

    def _drain_tokens(self, toks: np.ndarray, steps: int, slot_reqs) -> None:
        """Host bookkeeping for one scan's [steps, slots] token block:
        append tokens, stream callbacks, retire finished requests."""
        done: list[int] = []
        for slot, req in slot_reqs:
            if req.finish_time is not None:
                # retired at the previous drain while this scan was in
                # flight (pipelined): its tokens are surplus
                continue
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
