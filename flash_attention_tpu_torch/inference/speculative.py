"""Speculative decoding: a small draft model proposes, the target verifies.

Port of `flash_attention_tpu/inference/speculative.py`.  Greedy
speculative decoding with a draft window of k emits what target-only greedy
decoding emits (the accept test compares the draft's tokens with the
target's own argmax at every prefix), while the target runs once per up to
k + 1 emitted tokens.

Exactness: the verify step scores C rows in one product where decode
scores one row at a time; the arithmetic and its order are the same
(`model_runner._offset_attention`), but the reductions round differently,
so in bf16 a step whose top-2 logits lie within rounding of each other can
pick the other token.  In fp32 the equality holds in practice (the tests
pin it on weights whose top-2 gaps are wide).

Each iteration, on the device with no host sync: k + 1 chained draft decode
steps (the last one only writes d_k's K/V, so that a fully accepted window
leaves the draft's history complete), one `verify_step` over the k + 1
rows [cur, d_1 .. d_k], the consecutive-prefix acceptance, and the rollback
as a lengths update (the rows past the accepted point stay in the caches,
hidden by the length mask, and later writes overwrite them).  A Python
loop over the iterations takes the place of the JAX package's `lax.scan`.

Capacity: the caller leaves n_iters * (k + 1) rows of headroom below
max_len; decode_step stops advancing at the capacity, which would degrade
the proposals near it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import kv_cache as kvc
from .model_runner import decode_step, verify_step

PAD = -1


@torch.no_grad()
def speculative_decode_loop(
    target: nn.Module,
    target_cache: kvc.KVCache,
    draft: nn.Module,
    draft_cache: kvc.KVCache,
    first_tokens: torch.Tensor,
    n_iters: int,
    k: int = 4,
    active: torch.Tensor | None = None,
) -> tuple[kvc.KVCache, kvc.KVCache, torch.Tensor, torch.Tensor]:
    """Greedy speculative decoding of `n_iters` iterations with a draft
    window of `k`, for two GPTs (`target`, `draft`).

    Preconditions: both caches hold the same accepted history with equal
    `lengths`, and `first_tokens` [S] is each slot's last accepted token,
    written to neither cache yet (the next step writes it, as in
    `decode_loop`).  The draft cache must be at least as long as the
    target's (checked).

    `active` [S] bool masks the slots that take part (None: all).  An
    inactive slot computes garbage, its lengths never move, and every row
    the iteration writes for it lies at or past its length, so its real
    context is untouched: the engine runs greedy slots here while sampled
    slots decode through the regular scan.

    Returns (target_cache, draft_cache, tokens [n_iters, S, k + 1] int32,
    counts [n_iters, S] int32): iteration i emitted tokens[i, s,
    :counts[i, s]] for slot s and PAD after them; each count lies in
    [1, k + 1].  Both caches are updated in place.
    """
    if draft_cache.max_len < target_cache.max_len:
        raise ValueError(
            f"draft cache max_len {draft_cache.max_len} < target {target_cache.max_len}: the shared lengths would "
            "exceed the draft cache and corrupt its attention mask"
        )
    cur = first_tokens.to(torch.int32)
    s = cur.shape[0]
    idx = torch.arange(k + 1, device=cur.device)[None, :]
    toks, counts = [], []
    for _ in range(n_iters):
        l0 = target_cache.lengths.clone()
        # Draft: k + 1 chained steps from cur; steps 1..k propose d_1..d_k,
        # step k + 1 only writes d_k's K/V into the draft cache.
        drafts, tok = [], cur
        for _ in range(k + 1):
            draft_cache, logits = decode_step(draft, tok, draft_cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(tok)
        d = torch.stack(drafts[:k], dim=1)  # [S, k]
        # Verify: one target forward over [cur, d_1 .. d_k]; row i's argmax
        # is the target's next token after the first i proposals.
        target_cache, logits_v = verify_step(target, torch.cat([cur[:, None], d], dim=1), target_cache)
        t = torch.argmax(logits_v, dim=-1).to(torch.int32)  # [S, k + 1]
        # a[s]: the number of leading proposals equal to the target's tokens
        a = torch.cumprod((d == t[:, :k]).to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        bonus = torch.gather(t, 1, a[:, None].long())[:, 0]
        d_pad = torch.cat([d, torch.zeros((s, 1), dtype=torch.int32, device=d.device)], dim=1)
        out = torch.where(idx < a[:, None], d_pad, torch.where(idx == a[:, None], bonus[:, None], PAD))
        # Rollback: rows l0 .. l0 + a hold [cur, d_1 .. d_a] in both caches.
        new_len = torch.clamp(l0 + a + 1, max=target_cache.max_len - 1).to(torch.int32)
        if active is not None:
            new_len = torch.where(active, new_len, l0)
        target_cache.lengths.copy_(new_len)
        draft_cache.lengths.copy_(new_len)
        cur = bonus
        toks.append(out.to(torch.int32))
        counts.append(a + 1)
    return target_cache, draft_cache, torch.stack(toks), torch.stack(counts)


def gather_tokens(toks, counts, slot: int, limit: int | None = None) -> list[int]:
    """Host side: one slot's emitted tokens, its [n_iters, k + 1] padded
    rows flattened (truncated to `limit` tokens when given).  toks and
    counts are numpy arrays or tensors."""
    toks = (toks.cpu().numpy() if isinstance(toks, torch.Tensor) else np.asarray(toks))[:, slot, :]
    counts = (counts.cpu().numpy() if isinstance(counts, torch.Tensor) else np.asarray(counts))[:, slot]
    out: list[int] = []
    for row, n in zip(toks, counts):
        out.extend(int(x) for x in row[: int(n)])
    return out if limit is None else out[:limit]
