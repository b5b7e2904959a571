"""What the decode kernels' CPU tests share (not a test module): the q
dtypes and payloads they run, q and pages or a one-layer JAX cache made
from a seed, the whole-group kernels' plans (`decode_cluster_split` at the
stage `group_tokens` gives) with the lengths on their edges, and the
whole-group plan checks against the JAX package, which the test files
test_torch_decode_group_k5*.py, _k6.py and _fp32*.py run over their share of
the cases (split by width so that no file holds the tier-1 run up)."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import from_jax, n, randn, t, torch_cache
from flash_attention_tpu.inference import kv_cache as jkvc
from flash_attention_tpu.quant import kv as jq
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
jpa = importlib.import_module("flash_attention_tpu.inference.paged_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

# (q dtype, payload): fp32 q over fp32 pages, fp16 q over fp16, int8 and fp8
PAYLOADS = {"fp32": (jnp.float32, None), "fp16": (jnp.float16, None), "fp16-int8": (jnp.float16, jnp.int8),
            "fp16-fp8": (jnp.float16, jnp.float8_e4m3fn)}
# fp32: the JAX package's quantized-page tolerance (tests/test_paged_attention.py);
# fp16: the 16-bit tier (P and the output are rounded to fp16 at other points)
TOL = {"fp32": (5e-5, 1e-4), "fp16": (2e-2, 0.0)}

# The whole-group kernels' configurations: q's dtype and the payload
GROUP_PAYLOADS = {"bf16": (jnp.bfloat16, None), "fp16": (jnp.float16, None), "bf16-int8": (jnp.bfloat16, jnp.int8),
                  "fp16-fp8": (jnp.float16, jnp.float8_e4m3fn)}
# the fp32 whole-group kernel's (csrc/decode_group_fp32.cuh): fp32 q over
# fp32, int8 and fp8 pages
GROUP_FP32_PAYLOADS = {"fp32": (jnp.float32, None), "fp32-int8": (jnp.float32, jnp.int8),
                       "fp32-fp8": (jnp.float32, jnp.float8_e4m3fn)}
# the narrow kernel's (csrc/decode_narrow.cuh, head dims 8-32 at groups of
# up to 8): every q dtype over its own dtype, int8 and fp8 pages
NARROW_PAYLOADS = {f"{q}{'-' + c if c else ''}": (qdt, quant)
                   for q, qdt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16), ("fp16", jnp.float16))
                   for c, quant in (("", None), ("int8", jnp.int8), ("fp8", jnp.float8_e4m3fn))}
ALL_PAYLOADS = {**PAYLOADS, **GROUP_PAYLOADS, **GROUP_FP32_PAYLOADS, **NARROW_PAYLOADS}
# (q heads, KV heads): groups 12 (one padded row tile), 16 (SantaCoder's
# multi-query), 48 (StarCoder's, 3 row tiles), 71 (Falcon-7B's, 5 row tiles:
# 8 warps) and 24 / 2 (a group of 12 on two KV heads)
GROUP_CASES = [(12, 1), (16, 1), (48, 1), (71, 1), (24, 2)]

# The whole-group plan over a capacity of 512 tokens in chunks of one stage
# (`group_tokens`: 128 tokens, or 64 for a 16-bit payload at D256 and for
# fp32 pages at D128, 32 for fp32 pages at D256; pages of 16), clusters of 2
# (`decode_cluster_split` on a card that holds every pair's cluster of 2 at
# once but not of 3), so that each block walks 2 (4, 8) chunks.  Lengths
# (current token included, `plan_lengths`): 0 and 1, a chunk's edges (127,
# 129, or 63, 65, or 31, 33), a cluster's edge (each block one whole
# chunk), a block's later chunk partly live (400), the whole capacity.
GROUP_CAPACITY = 512
# (q heads, KV heads, head dim) of the whole-group plan tests: every
# GROUP_CASES entry at D64 / D128; at 8, 16, 32 (run at 32) and 256 a padded
# row tile (12), several row tiles (71: 5 at 128 q heads a pass, 3 passes at
# D256) and two KV heads (24 / 2)
GROUP_CASES_D64_D128 = [(hq, hkv, d) for d in (64, 128) for hq, hkv in GROUP_CASES]
GROUP_CASES_D32_D256 = [(hq, hkv, d) for d in (8, 16, 32, 256) for hq, hkv in ((12, 1), (71, 1), (24, 2))]


def dim_ids(cases) -> list[str]:
    return [f"hq{hq}-hkv{hkv}-{d}" for hq, hkv, d in cases]


def make_pages(hq, hkv, d, payload, batch=3, page_size=16, pps=4, seed=0):
    """q and pages in the payload's dtypes (quantized with the JAX package's
    quantize_tokens), a permuted page table over more pages than the
    sequences use."""
    qdt, quant = ALL_PAYLOADS[payload]
    n_pages = batch * pps + 3
    rng = np.random.default_rng(seed)
    q = jnp.asarray(randn(seed, batch, hq, d), qdt)
    kp, vp = (jnp.asarray(randn(seed + i, hkv, n_pages, page_size, d)) for i in (1, 2))
    pi = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    if quant is None:
        return q, pi, (kp.astype(qdt), vp.astype(qdt), None, None)
    kq, ks = jq.quantize_tokens(kp, quant)
    vq, vs = jq.quantize_tokens(vp, quant)
    return q, pi, (kq, vq, ks, vs)


def jax_cache(hkv, d, payload, lengths=(0, 31, 100), max_len=128, seed=20):
    """A one-layer JAX cache in the payload's dtypes, filled by its own
    prefill_write/decode_write: the current token of slot s at lengths[s]."""
    qdt, quant = ALL_PAYLOADS[payload]
    slots, fill = len(lengths), max(lengths) + 1
    c = jkvc.init_cache(1, slots, hkv, max_len, d, dtype=qdt, quant_dtype=quant)
    for s in range(slots):
        c = jkvc.prefill_write(c, 0, jnp.int32(s), jnp.asarray(randn(seed + s, hkv, fill, d)),
                               jnp.asarray(randn(seed + s + 5, hkv, fill, d)))
    pos = jnp.asarray(lengths, jnp.int32)
    k_new, v_new = (jnp.asarray(randn(seed + i, slots, hkv, d)) for i in (9, 8))
    c = jkvc.decode_write(c, 0, k_new, v_new, pos)
    return dataclasses.replace(c, lengths=pos)


def plan_lengths(chunk: int) -> tuple:
    """Lengths (current token included) on a whole-group plan's edges: 0 and
    1, a stage's (a chunk's) edges, a cluster's span (each block one whole
    chunk), a block's later chunk partly live, the whole capacity."""
    return (0, 1, chunk - 1, chunk + 1, 2 * chunk, 400, GROUP_CAPACITY)


def group_split(hq, hkv, d, payload, capacity, unit, paged):
    """The whole-group plan's (cluster, chunk, walks) for bf16 / fp16 q at
    a stage of `group_tokens`, and the lengths on its edges.  K6 (`unit`
    None) takes the stage as its unit."""
    tokens = tpa.group_tokens(d, 2 if GROUP_PAYLOADS[payload][1] is None else 1)
    passes, _ = tpa.group_passes(hq // hkv, tpa.group_max_rows(torch.bfloat16, d))
    lengths = plan_lengths(tokens)
    pairs = len(lengths) * hkv * passes
    split = tpa.decode_cluster_split(capacity, pairs, unit or tokens, {1: 2 * pairs, 2: pairs, 3: pairs - 1}, paged,
                                     tokens)
    assert split == (2, tokens, capacity // (2 * tokens))  # 2 blocks a cluster, chunks of one stage
    return split, lengths


def fp32_split(hq, hkv, d, payload, capacity, unit, paged):
    """The fp32 whole-group plan's (cluster, chunk, walks) at a stage of
    `group_tokens` (64 tokens for fp32 pages at D128, 32 at D256, 128
    otherwise) on a card that holds every pair's cluster of 2 at once but
    not of 3, and the stage's tokens.  K6 (`unit` None) takes the stage as
    its unit."""
    tokens = tpa.group_tokens(d, 4 if payload == "fp32" else 1)
    passes, _ = tpa.group_passes(hq // hkv, tpa.group_max_rows(torch.float32, d))
    pairs = len(plan_lengths(tokens)) * hkv * passes
    split = tpa.decode_cluster_split(capacity, pairs, unit or tokens, {1: 2 * pairs, 2: pairs, 3: pairs - 1}, paged,
                                     tokens)
    assert split[:2] == (2, tokens)  # 2 blocks a cluster, chunks of one stage
    return split, tokens


def check_k5_group_plan(hq, hkv, d, payload):
    """The whole-group K5's plan with bf16 / fp16 q against JAX's paged
    kernel (test_k5_group_plan_matches_jax_paged_kernel says how)."""
    (cluster, chunk, _), lengths = group_split(hq, hkv, d, payload, GROUP_CAPACITY, 16, True)
    batch = len(lengths)
    q, pi, pages = make_pages(hq, hkv, d, payload, batch=batch, pps=GROUP_CAPACITY // 16, seed=d)
    lengths = np.array(lengths, np.int32)
    jout = jpa.paged_attention(q, pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=8, k_scales=pages[2], v_scales=pages[3])
    kp, vp, ks, vs = (None if a is None else from_jax(a) for a in pages)
    tq = from_jax(q)
    assert tpa.uses_group_kernel(tq.dtype, d, hq // hkv)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_group_ref(tq, kp, vp, t(lengths), t(pi), cluster=cluster, chunk=chunk, k_scales=ks,
                                        v_scales=vs)
    plain = tpa.paged_attention(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = TOL["fp16"]
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), atol=atol, rtol=rtol)


def check_k6_group_plan(hq, hkv, d, payload):
    """The whole-group K6's plan with bf16 / fp16 q against JAX's fused
    decode (test_k6_group_plan_matches_jax_fused says how)."""
    qdt, quant = GROUP_PAYLOADS[payload]
    (cluster, chunk, _), lengths = group_split(hq, hkv, d, payload, GROUP_CAPACITY, None, False)
    jc = jax_cache(hkv, d, payload, lengths=tuple(max(x - 1, 0) for x in lengths), max_len=GROUP_CAPACITY)
    q = jnp.asarray(randn(34, len(lengths), hq, d), qdt)
    if quant == jnp.float8_e4m3fn:
        jout = jda.decode_attention(q, jc, 0)
    else:
        jout = jda.decode_attention_fused(q, jc, 0, block=64)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    got = tpa.paged_attention_group_ref(from_jax(q), kp, vp, tc.lengths + 1, pi, cluster=cluster, chunk=chunk,
                                        k_scales=ks, v_scales=vs, prescale_q=True)
    atol, rtol = TOL["fp16"]
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)


def check_k5_group_fp32_plan(hq, hkv, d, payload):
    """The fp32 whole-group K5's plan against JAX's paged kernel
    (test_k5_group_fp32_plan_matches_jax_paged_kernel says how)."""
    (cluster, chunk, _), tokens = fp32_split(hq, hkv, d, payload, GROUP_CAPACITY, 16, True)
    lengths = np.array(plan_lengths(tokens), np.int32)
    q, pi, pages = make_pages(hq, hkv, d, payload, batch=len(lengths), pps=GROUP_CAPACITY // 16, seed=d + 1)
    jout = jpa.paged_attention(q, pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=8, k_scales=pages[2], v_scales=pages[3])
    kp, vp, ks, vs = (None if a is None else from_jax(a) for a in pages)
    tq = from_jax(q)
    assert tq.dtype == torch.float32 and tpa.uses_group_kernel(tq.dtype, d, hq // hkv)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_group_ref(tq, kp, vp, t(lengths), t(pi), cluster=cluster, chunk=chunk, k_scales=ks,
                                        v_scales=vs)
    plain = tpa.paged_attention(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = TOL["fp32"]
    np.testing.assert_allclose(n(got), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got), n(plain), atol=atol, rtol=rtol)


def check_k6_group_fp32_plan(hq, hkv, d, payload):
    """The fp32 whole-group K6's plan against JAX's fused or einsum decode
    (test_k6_group_fp32_plan_matches_jax_fused says how)."""
    (cluster, chunk, _), tokens = fp32_split(hq, hkv, d, payload, GROUP_CAPACITY, None, False)
    lengths = plan_lengths(tokens)
    jc = jax_cache(hkv, d, payload, lengths=tuple(max(x - 1, 0) for x in lengths), max_len=GROUP_CAPACITY)
    q = jnp.asarray(randn(35, len(lengths), hq, d), jnp.float32)
    if GROUP_FP32_PAYLOADS[payload][1] is None:
        jout = jda.decode_attention_fused(q, jc, 0, block=64)
    else:
        jout = jda.decode_attention(q, jc, 0)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    got = tpa.paged_attention_group_ref(from_jax(q), kp, vp, tc.lengths + 1, pi, cluster=cluster, chunk=chunk,
                                        k_scales=ks, v_scales=vs, prescale_q=True)
    atol, rtol = TOL["fp32"]
    np.testing.assert_allclose(n(got), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
