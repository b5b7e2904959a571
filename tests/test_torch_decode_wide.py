"""The wide decode kernels (head dims above 256: `csrc/decode_wide.cuh`,
`paged_attention.uses_wide_kernel`).  Their plan in plain PyTorch
(`paged_attention_group_ref` at the chunk and cluster `decode_cluster_split`
gives: block c of a cluster walks chunks c, c + cluster, ..., then the
cluster's merge in rank order) against the JAX package's `paged_attention`
in Pallas interpret mode (K5's scoring) and its `decode_attention_fused` /
einsum `decode_attention` (K6's, q pre-scaled and rounded to its dtype), at
d 384, 512, 768 and 1024, groups 1, 4 and 16, fp32, bf16 (over bf16, int8
and fp8 pages) and fp16 q, with lengths of one token, a chunk's edge, a
cluster's span of chunks and the whole capacity; then their routing, passes,
stage and split.  Inputs are numpy from a seed; fp8 payloads cross as uint8
views.  The slots and the capacity are small (4 slots of 256 tokens): the
JAX kernel runs interpreted."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import from_jax, n, randn, t, torch_cache
from flash_attention_tpu.inference import kv_cache as jkvc
from flash_attention_tpu.quant import kv as jq
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
jpa = importlib.import_module("flash_attention_tpu.inference.paged_attention")
tda = importlib.import_module("flash_attention_tpu_torch.inference.decode_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

# (q dtype, payload)
PAYLOADS = {"fp32": (jnp.float32, None), "bf16": (jnp.bfloat16, None), "bf16-int8": (jnp.bfloat16, jnp.int8),
            "bf16-fp8": (jnp.bfloat16, jnp.float8_e4m3fn), "fp16": (jnp.float16, None)}
# fp32: the JAX package's quantized-page tolerance (tests/test_paged_attention.py);
# 16-bit: P and the output are rounded to q's dtype at other points
TOL = {"fp32": (5e-5, 1e-4), "16-bit": (2e-2, 0.0)}
# (head dim, q heads, KV heads, payload): every head dim at groups 1, 4 and
# 16, each payload at each group; d 1024 at group 4 (hq8 hkv2, the timed
# layout) on bf16 and fp32
CASES = [
    (384, 2, 2, "fp32"), (384, 8, 2, "bf16-int8"), (384, 16, 1, "fp16"),
    (512, 2, 2, "bf16"), (512, 8, 2, "bf16-fp8"), (512, 16, 1, "fp32"),
    (768, 2, 2, "bf16-int8"), (768, 8, 2, "fp16"), (768, 16, 1, "bf16"),
    (1024, 2, 2, "bf16-fp8"), (1024, 8, 2, "bf16"), (1024, 8, 2, "fp32"), (1024, 16, 1, "bf16-int8"),
    (1024, 2, 2, "fp16"),
]
CASE_IDS = [f"d{d}-hq{hq}-hkv{hkv}-{payload}" for d, hq, hkv, payload in CASES]
SLOTS = 4
PAGE = 16
CAPACITY = 256


def _tol(payload: str) -> tuple[float, float]:
    return TOL["fp32" if payload == "fp32" else "16-bit"]


def _split(hq, hkv, d, payload, paged):
    """The wide plan of these cases: a card that holds every pair's cluster
    of 3 at once but not of 4, so that clusters are 3 blocks (not a power of
    two) and each block walks up to 3 chunks of one stage."""
    _, quant = PAYLOADS[payload]
    itemsize = 1 if quant is not None else jnp.dtype(PAYLOADS[payload][0]).itemsize
    tokens = tpa.wide_tokens(d, itemsize)
    passes, _ = tpa.wide_passes(hq // hkv)
    pairs = SLOTS * hkv * passes
    resident = {1: 3 * pairs, 2: 2 * pairs, 3: pairs, 4: pairs - 1}
    unit = PAGE if paged else tokens
    cluster, chunk, walks = tpa.decode_cluster_split(CAPACITY, pairs, unit, resident, paged, tokens)
    assert cluster == 3 and chunk == max(tokens, unit) and cluster * chunk * walks >= CAPACITY
    return cluster, chunk


def _lengths(chunk: int) -> np.ndarray:
    """Tokens read a sequence: one, a chunk and one more (the second block's
    first token), a cluster's span of chunks (each block one whole chunk),
    the whole capacity (every block walks)."""
    return np.array([1, chunk + 1, 3 * chunk, CAPACITY], np.int32)


def _pages(hq, hkv, d, payload, seed=0):
    """q and pages in the payload's dtypes (quantized with the JAX package's
    quantize_tokens), a permuted page table over more pages than the
    sequences use."""
    qdt, quant = PAYLOADS[payload]
    pps = CAPACITY // PAGE
    n_pages = SLOTS * pps + 3
    rng = np.random.default_rng(seed)
    q = jnp.asarray(randn(seed, SLOTS, hq, d), qdt)
    kp, vp = (jnp.asarray(randn(seed + i, hkv, n_pages, PAGE, d)) for i in (1, 2))
    pi = rng.permutation(n_pages)[: SLOTS * pps].reshape(SLOTS, pps).astype(np.int32)
    if quant is None:
        return q, pi, (kp.astype(qdt), vp.astype(qdt), None, None)
    kq, ks = jq.quantize_tokens(kp, quant)
    vq, vs = jq.quantize_tokens(vp, quant)
    return q, pi, (kq, vq, ks, vs)


@pytest.mark.parametrize("d,hq,hkv,payload", CASES, ids=CASE_IDS)
def test_k5_wide_plan_matches_jax_paged_kernel(d, hq, hkv, payload):
    """The wide K5's plan (chunks of one stage in whole pages of 16, clusters
    of 3) against JAX's paged kernel (interpret mode) over a permuted page
    table, and the port's plain K5 (CPU tensors take it, launching
    nothing)."""
    q, pi, pages = _pages(hq, hkv, d, payload, seed=d + hq)
    cluster, chunk = _split(hq, hkv, d, payload, True)
    lengths = _lengths(chunk)
    jout = jpa.paged_attention(q, pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=4, k_scales=pages[2], v_scales=pages[3])
    kp, vp, ks, vs = (None if a is None else from_jax(a) for a in pages)
    tq = from_jax(q)
    assert tpa.uses_wide_kernel(tq.dtype, d, hq // hkv) and not tpa.uses_group_kernel(tq.dtype, d, hq // hkv)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_group_ref(tq, kp, vp, t(lengths), t(pi), cluster=cluster, chunk=chunk, k_scales=ks,
                                        v_scales=vs)
    plain = tpa.paged_attention(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), atol=atol, rtol=rtol)


def _jax_cache(hkv, d, payload, lengths, seed=20):
    """A one-layer JAX cache of CAPACITY tokens in the payload's dtypes,
    filled by its own prefill_write/decode_write: the current token of slot
    s at lengths[s]."""
    qdt, quant = PAYLOADS[payload]
    slots, fill = len(lengths), max(lengths) + 1
    c = jkvc.init_cache(1, slots, hkv, CAPACITY, d, dtype=qdt, quant_dtype=quant)
    for s in range(slots):
        c = jkvc.prefill_write(c, 0, jnp.int32(s), jnp.asarray(randn(seed + s, hkv, fill, d)),
                               jnp.asarray(randn(seed + s + 5, hkv, fill, d)))
    pos = jnp.asarray(lengths, jnp.int32)
    k_new, v_new = (jnp.asarray(randn(seed + i, slots, hkv, d)) for i in (9, 8))
    c = jkvc.decode_write(c, 0, k_new, v_new, pos)
    return dataclasses.replace(c, lengths=pos)


@pytest.mark.parametrize("d,hq,hkv,payload", CASES, ids=CASE_IDS)
def test_k6_wide_plan_matches_jax_fused(d, hq, hkv, payload):
    """The wide K6's plan (q pre-scaled and rounded to its dtype, lengths +
    1, chunks of one stage over the slot-major cache's page view, clusters
    of 3) against JAX's `decode_attention_fused` (its einsum fallback at
    these head dims), or on an fp8 cache, whose P the JAX kernel rounds to
    fp8, against JAX's einsum `decode_attention`, the function both compute;
    and the port's plain K6.  Cache lengths 0 (one token read) up to the
    capacity less one."""
    qdt, quant = PAYLOADS[payload]
    cluster, chunk = _split(hq, hkv, d, payload, False)
    jc = _jax_cache(hkv, d, payload, tuple(int(x) - 1 for x in _lengths(chunk)), seed=d + hkv)
    q = jnp.asarray(randn(d + 34, SLOTS, hq, d), qdt)
    if quant == jnp.float8_e4m3fn:
        jout = jda.decode_attention(q, jc, 0)
    else:
        jout = jda.decode_attention_fused(q, jc, 0, block=64)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    tq = from_jax(q)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_group_ref(tq, kp, vp, tc.lengths + 1, pi, cluster=cluster, chunk=chunk, k_scales=ks,
                                        v_scales=vs, prescale_q=True)
    plain = tda.decode_attention_fused(tq, tc, 0)
    assert KERNEL_LAUNCHES == before
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "q_dtype,d,group,want",
    [
        (torch.bfloat16, 384, 1, True),  # every head dim above 256 ...
        (torch.bfloat16, 1024, 4, True),
        (torch.float32, 512, 16, True),  # ... at every q dtype ...
        (torch.float16, 896, 71, True),  # ... and every group
        (torch.bfloat16, 256, 1, False),  # D256: the group tiles
        (torch.float32, 128, 4, False),
        (torch.bfloat16, 128, 16, False),  # the whole-group kernel
        (torch.float16, 32, 16, False),
    ],
)
def test_wide_kernel_routing(q_dtype, d, group, want):
    """Which decode configurations run the wide kernels: every head dim
    above 256, whatever q's dtype and the group; no configuration runs both
    the wide and the whole-group kernels."""
    assert tpa.uses_wide_kernel(q_dtype, d, group) is want
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for hd in tpa.HEAD_DIMS:
            for g in (1, 4, 9, 16, 71):
                assert not (tpa.uses_wide_kernel(dt, hd, g) and tpa.uses_group_kernel(dt, hd, g))


@pytest.mark.parametrize("group,want", [(1, (1, 1)), (4, (1, 4)), (8, (1, 8)), (12, (2, 6)), (16, (2, 8)),
                                        (71, (9, 8))])
def test_wide_passes(group, want):
    """A group runs in passes of at most 8 q heads, as even as they go,
    every pass live."""
    passes, rows = tpa.wide_passes(group)
    assert (passes, rows) == want
    assert rows <= tpa.WIDE_MAX_ROWS and passes * rows >= group > (passes - 1) * rows


@pytest.mark.parametrize("d,itemsize,want", [(384, 1, 32), (512, 2, 32), (512, 4, 32), (640, 1, 32), (1024, 2, 32),
                                             (1024, 4, 16)])
def test_wide_tokens(d, itemsize, want):
    """A stage's tokens: padded rows of 512 or 1024 columns filling a 64 KB
    slot, at most 32 (16 for fp32 at 1024)."""
    assert tpa.wide_tokens(d, itemsize) == want
    assert want * (512 if d <= 512 else 1024) * itemsize <= tpa.WIDE_SLOT_BYTES


RES_H100 = {c: 132 // c for c in range(1, 9)}  # one block an SM on 132 SMs
RES_15 = {**RES_H100, 8: 15}  # only 15 clusters of 8 fit at once


@pytest.mark.parametrize(
    "capacity,pairs,unit,resident,paged,tokens,want",
    [
        (2048, 16, 128, RES_H100, True, 32, (8, 128, 2)),  # hq8 hkv2 8 slots, K5 over pages of 128
        (2048, 16, 32, RES_H100, False, 32, (8, 32, 8)),  # the same through K6 (its unit is the stage)
        (2048, 16, 128, RES_15, True, 32, (7, 128, 3)),  # clusters of 8 need a second wave: 7
        (2048, 16, 16, RES_15, False, 16, (7, 16, 19)),  # fp32 at 1024: stages of 16
        (128, 8, 128, RES_H100, True, 32, (1, 128, 1)),  # one chunk: one block
        (4096, 512, 16, RES_H100, True, 32, (1, 32, 128)),  # more pairs than SMs: clusters of 1
        (131072, 8, 16, RES_H100, True, 32, (8, 32, 512)),  # 1024 page ids a block, the most it stages
        (131072, 1024, 16, RES_H100, True, 32, (8, 32, 512)),  # the page ids ask for clusters of 8
        (131072, 1024, 16, RES_H100, False, 32, (1, 32, 4096)),  # K6 stages none
    ],
)
def test_decode_wide_split_choice(capacity, pairs, unit, resident, paged, tokens, want):
    """The wide kernels' split (cluster, chunk, walks): the largest cluster
    of 1 to 8 (not only powers of two) whose clusters all fit the card at
    once and leave each block a chunk; chunks of one stage in whole units;
    the capacity covered; K5's page ids within what a block stages."""
    cluster, chunk, walks = tpa.decode_cluster_split(capacity, pairs, unit, resident, paged, tokens)
    assert (cluster, chunk, walks) == want
    assert chunk % unit == 0 and cluster * chunk * walks >= capacity > cluster * chunk * (walks - 1)
    assert cluster <= tpa.CLUSTER_MAX and (not paged or walks * chunk // unit <= tpa.CLUSTER_MAX_PAGES)
    with pytest.raises(NotImplementedError, match="page ids"):
        tpa.decode_cluster_split(262144, 8, 16, RES_H100, True, 32)
