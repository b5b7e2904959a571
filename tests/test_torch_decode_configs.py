"""The decode kernels' configurations beyond head dims 64/128, fp32/bf16 q
and GQA groups of up to 8: head dims 8, 16, 32, 256 and 512, groups 2-71
(multi-query attention), fp16 q over fp16, int8 and fp8 pages.  The
kernels' arithmetic in plain PyTorch (`paged_attention_split_ref`: K5's
scoring, and K6's with `prescale_q=True`) against the JAX package's
`paged_attention` in Pallas interpret mode and its `decode_attention_fused`
(interpret mode up to d = 128, its own einsum fallback above); the
whole-group kernels' routing, split and plan limits (their plans against
the JAX package are in test_torch_decode_group_k5.py, _k6.py and
_fp32.py); then the slice: a 2-layer multi-query GPT's chained decode steps
through attn_impl="paged" and "fused" against the JAX package's, and their
greedy tokens.  Inputs are numpy from a seed; fp8 payloads cross as uint8
views.  fp16 is compared at the module level only: the JAX package's
prefill computes fp16 in bf16."""

import dataclasses
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_cases import PAYLOADS, TOL, c_instantiated_width, jax_cache, make_pages
from _torch_port import JAX_CFG, TORCH_CFG, from_jax, jax_tree, n, numpy_params, randn, t, torch_cache
from flash_attention_tpu.inference import kv_cache as jkvc
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES
from flash_attention_tpu_torch.models import gpt as tgpt

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
jpa = importlib.import_module("flash_attention_tpu.inference.paged_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

# (q heads, KV heads, head dim): multi-query at SantaCoder's D128 and at a
# narrow head; Gemma's D256 under one KV head; a group of 12 at D512; groups
# of 2 at the narrowest heads; Falcon-7B's 71 q heads on one KV head
CASES = [(16, 1, 128), (16, 1, 32), (8, 1, 256), (24, 2, 512), (4, 2, 8), (4, 2, 16), (71, 1, 64)]
CASE_IDS = [f"hq{hq}-hkv{hkv}-d{d}" for hq, hkv, d in CASES]
CHUNK = 32  # two pages of 16: the kernels' splits, most of them empty for short sequences


def _tol(payload: str) -> tuple[float, float]:
    return TOL["fp32" if payload == "fp32" else "fp16"]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", CASES, ids=CASE_IDS)
def test_k5_split_arithmetic_matches_jax_paged_kernel(hq, hkv, d, payload):
    """K5's chunk-and-merge arithmetic against JAX's paged kernel (interpret
    mode) at lengths of one token, a split's edge and the whole capacity."""
    q, pi, pages = make_pages(hq, hkv, d, payload)
    lengths = np.array([1, CHUNK + 1, 64], np.int32)
    kw = dict(k_scales=pages[2], v_scales=pages[3])
    jout = jpa.paged_attention(q, pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=2, **kw)
    kp, vp, ks, vs = (None if a is None else from_jax(a) for a in pages)
    tq = from_jax(q)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_split_ref(tq, kp, vp, t(lengths), t(pi), chunk=CHUNK, k_scales=ks, v_scales=vs)
    plain = tpa.paged_attention(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(plain.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("hq,hkv,d", CASES, ids=CASE_IDS)
def test_k6_split_arithmetic_matches_jax_fused(hq, hkv, d, payload):
    """K6's arithmetic (q pre-scaled and rounded to its dtype, lengths + 1)
    over the slot-major cache's page view against JAX's
    `decode_attention_fused`: its kernel in interpret mode up to d = 128,
    its einsum fallback above.  On an fp8 cache the JAX kernel rounds P to
    fp8 before its PV product (pv_dtype, decode_attention.py:361), which the
    port does not, so there K6 is held against JAX's einsum
    `decode_attention`, the function both compute."""
    qdt, quant = PAYLOADS[payload]
    jc = jax_cache(hkv, d, payload)
    q = jnp.asarray(randn(33, 3, hq, d), qdt)
    if quant == jnp.float8_e4m3fn:
        jout = jda.decode_attention(q, jc, 0)
    else:
        jout = jda.decode_attention_fused(q, jc, 0, block=64)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    got = tpa.paged_attention_split_ref(from_jax(q), kp, vp, tc.lengths + 1, pi, chunk=CHUNK, k_scales=ks,
                                        v_scales=vs, prescale_q=True)
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "group,want",
    [(1, (1, 1)), (4, (1, 4)), (8, (1, 8)), (12, (2, 6)), (16, (2, 8)), (18, (3, 6)), (48, (6, 8)), (71, (9, 8))],
)
def test_group_tiles(group, want):
    """A GQA group runs in tiles of at most 8 q heads, as even as they go
    (the launcher passes both to the kernels and sizes the workspace from
    them): every head in one tile, no tile empty."""
    tiles, rows = tpa.group_tiles(group)
    assert (tiles, rows) == want
    assert rows <= tpa.MAX_ROWS and tiles * rows >= group > (tiles - 1) * rows


def test_group_tiles_cover_every_group():
    """What the kernels' entry points check of the (tiles, rows) they are
    given holds for every group up to 1024 q heads a KV head: the rows
    cover the group with no tile empty, and no more tiles than groups of
    MAX_ROWS need."""
    for group in range(1, 1025):
        tiles, rows = tpa.group_tiles(group)
        assert 1 <= rows <= min(tpa.MAX_ROWS, group)
        assert tiles * rows >= group > (tiles - 1) * rows
        assert tiles == -(-group // tpa.MAX_ROWS)


@pytest.mark.parametrize("d,itemsize,want", [(64, 4, 128), (128, 4, 64), (64, 2, 128), (128, 2, 128), (64, 1, 128),
                                             (128, 1, 128), (256, 2, 64), (256, 1, 128), (32, 2, 128), (32, 1, 128),
                                             (8, 1, 128), (256, 4, 32), (32, 4, 128), (16, 4, 128), (8, 4, 128)])
def test_group_tokens(d, itemsize, want):
    """A stage's tokens: rows filling 32 KB of K, at most 128 (64 for fp32
    pages at D128 and 16-bit pages at D256, whose rows are 512 bytes; 32 for
    fp32 pages at D256, 1 KB rows); the kernels' layouts take the same
    (GroupLayout::kTok, GroupLayout32::kTok; D32's at d = 8-32)."""
    assert tpa.group_tokens(d, itemsize) == want
    assert want * d * itemsize <= tpa.GROUP_STAGE_BYTES and want <= tpa.GROUP_TOKENS


@pytest.mark.parametrize("q_dtype,d,want", [(torch.float32, 128, 64), (torch.float32, 64, 128),
                                            (torch.bfloat16, 128, 128), (torch.float16, 64, 128),
                                            (torch.bfloat16, 256, 32), (torch.float16, 256, 32),
                                            (torch.bfloat16, 32, 128), (torch.float16, 8, 128),
                                            (torch.float32, 256, 32), (torch.float32, 32, 128),
                                            (torch.float32, 16, 128), (torch.float32, 8, 128)])
def test_group_max_rows(q_dtype, d, want):
    """A pass holds at most 128 q heads, 64 for fp32 q at D128 (a row tile's
    head dim split over two warps, 4 row tiles a block), 32 for fp32 q at
    D256 (over four warps, 2 row tiles) and for bf16 / fp16 q at D256 (2 row
    tiles: q's fragments for 256 columns beside a column slice's
    accumulators); group 71 runs in two passes of 48 at 64, in three of 32 at
    32."""
    assert tpa.group_max_rows(q_dtype, d) == want
    assert tpa.group_passes(71, want) == {128: (1, 80), 64: (2, 48), 32: (3, 32)}[want]


@pytest.mark.parametrize(
    "q_dtype,d,group,want",
    [
        (torch.bfloat16, 128, 16, True),  # SantaCoder's layer
        (torch.float16, 64, 16, True),  # Falcon-40B's group in fp16
        (torch.bfloat16, 64, 9, True),  # the smallest group above 8
        (torch.bfloat16, 64, 71, True),  # Falcon-7B
        (torch.bfloat16, 128, 8, False),  # a group of up to 8: the group tiles
        (torch.float16, 64, 1, False),
        (torch.float32, 128, 16, True),  # fp32 q: the 3xTF32 whole-group kernel
        (torch.float32, 64, 71, True),
        (torch.float32, 128, 8, False),  # fp32 q at a group of up to 8: the group tiles
        (torch.float32, 32, 16, True),  # fp32 q at D8-32 and D256: the 3xTF32 whole-group kernel too
        (torch.float32, 16, 24, True),
        (torch.float32, 8, 71, True),
        (torch.float32, 256, 10, True),  # RecurrentGemma-2B's layer
        (torch.float32, 256, 48, True),
        (torch.float32, 32, 8, False),  # at a group of up to 8 still the group tiles
        (torch.float32, 8, 4, False),
        (torch.float32, 256, 8, False),
        (torch.float32, 512, 16, False),  # above 256 the wide kernels
        (torch.bfloat16, 32, 16, True),  # bf16 / fp16 q at D32 (d 8-32): the whole-group kernel at 32
        (torch.bfloat16, 16, 16, True),
        (torch.bfloat16, 256, 16, True),  # D256: the whole-group kernel; above it the wide kernels
        (torch.float32, 256, 16, True),
        (torch.float16, 1024, 16, False),
    ],
)
def test_group_kernel_routing(q_dtype, d, group, want):
    """Which decode configurations run the whole-group kernels: a group
    above 8 at head dims 8-256, with bf16 / fp16 q (decode_group.cuh) or
    fp32 q (decode_group_fp32.cuh), and nothing else."""
    assert tpa.uses_group_kernel(q_dtype, d, group) is want


@pytest.mark.parametrize("group,want", [(9, (1, 16)), (16, (1, 16)), (48, (1, 48)), (71, (1, 80)), (128, (1, 128)),
                                        (129, (2, 80)), (200, (2, 112)), (1024, (8, 128))])
def test_group_passes(group, want):
    """A group runs in passes of at most 128 q heads (a multiple of 16, as
    even as they go), every pass live: one pass for every real model."""
    passes, rows = tpa.group_passes(group)
    assert (passes, rows) == want
    assert rows % 16 == 0 and rows <= tpa.GROUP_MAX_ROWS and passes * rows >= group > (passes - 1) * rows


CSRC = Path(tpa.__file__).resolve().parents[1] / "csrc"


def _c_int(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_group_plan_mirrors_the_kernels(q_dtype):
    """`uses_group_kernel`'s head dims and `group_max_rows`'s limits are
    the C side's, which no CPU run can ask: for every q dtype the head dims
    that decode.cuh's instantiated_width pads (decode.cu's group_head_dim;
    its `if (...) return ...;` lines read as Python and run for d 1-1100)
    and the widths it pads them to (`decode_width`), each width among
    decode.cu's dispatch cases of q's dtype (group_width
    for bf16 / fp16, group32_width for fp32) and the instantiations of its
    header (decode_group.cuh, decode_group_fp32.cuh); the rows of a pass as
    kGMaxRows, kGMaxRowsD256, kGMaxRows32D128 and kGMaxRows32D256."""
    decode_cu = (CSRC / "decode.cu").read_text()
    group = (CSRC / "decode_group.cuh").read_text()
    group32 = (CSRC / "decode_group_fp32.cuh").read_text()
    c_width = c_instantiated_width()
    width = {d: c_width(d) for d in range(1, 1101) if c_width(d)}
    assert set(tpa.GROUP_HEAD_DIMS[q_dtype]) == set(width)
    assert all(tpa.decode_width(d) == w for d, w in width.items())
    assert "bool group_head_dim(int d) { return instantiated_width(d) != 0; }" in decode_cu
    if q_dtype == torch.float32:
        cases = {int(x) for x in re.findall(r"case (\d+): return group32_launch_width<\1>", decode_cu)}
        built = {int(x) for x in re.findall(r"FA_GROUP32_ROWS\(X, (\d+), (?:true|false)\)", group32)}
    else:
        cases = {int(x) for x in re.findall(r"case (\d+): return group_launch_width<T, \1>", decode_cu)}
        built = {int(x) for x in re.findall(r"FA_GROUP_ROWS\(X, T, (\d+), (?:true|false)\)", group)}
    assert set(width.values()) == cases == built
    assert tpa.GROUP_MAX_ROWS == _c_int(group, "kGWarps") * 16
    assert tpa.GROUP_MAX_ROWS_D256 == _c_int(group, "kGMaxRowsD256")
    assert tpa.GROUP_MAX_ROWS_FP32_D128 == _c_int(group32, "kGMaxRows32D128")
    assert tpa.GROUP_MAX_ROWS_FP32_D256 == _c_int(group32, "kGMaxRows32D256")


MQA_JAX_CFG = dataclasses.replace(JAX_CFG, n_head=16, n_embd=256, n_kv_head=1)
MQA_TORCH_CFG = dataclasses.replace(TORCH_CFG, n_head=16, n_embd=256, n_kv_head=1)
SLOTS, MAX_LEN = 3, 256


def _mqa_models(scale: float = 1.0):
    tree = numpy_params(seed=3, scale=scale, cfg=MQA_JAX_CFG)
    return jax_tree(tree), tgpt.params_from_jax(tree, MQA_TORCH_CFG, device="cpu")


def _mqa_caches():
    args = (MQA_JAX_CFG.n_layer, SLOTS, MQA_JAX_CFG.kv_heads, MAX_LEN, MQA_JAX_CFG.head_dim)
    return jkvc.init_cache(*args, dtype=jnp.float32), tkvc.init_cache(*args, dtype=torch.float32, device="cpu")


def _prefilled(jp, tm):
    prompt = np.arange(1, 41, dtype=np.int32) % MQA_JAX_CFG.vocab_size
    jc, tc = _mqa_caches()
    for slot, p in ((0, prompt), (1, prompt[:7])):
        jc, _ = jmr.prefill(jp, jnp.asarray(p), MQA_JAX_CFG, jc, jnp.int32(slot))
        tc, _ = tmr.prefill(tm, t(p), tc, slot)
    return jc, tc


@pytest.mark.parametrize("attn_impl", ["paged", "fused"])
def test_mqa_chained_decode_steps_match_jax(attn_impl):
    """The slice at multi-query width: a 2-layer GPT with 16 q heads on one
    KV head (head dim 16), 8 teacher-forced decode steps after prefills of
    40 and 7 tokens, slot 2 inactive; the port's attn_impl path against the
    JAX package's, at 1e-4 as the chained decode steps of
    tests/test_torch_inference.py."""
    jp, tm = _mqa_models()
    jc, tc = _prefilled(jp, tm)
    active = np.array([True, True, False])
    feed = np.random.default_rng(7).integers(0, MQA_JAX_CFG.vocab_size, (8, SLOTS)).astype(np.int32)
    for step in range(8):
        jc, jl = jmr.decode_step(jp, jnp.asarray(feed[step]), MQA_JAX_CFG, jc, jnp.asarray(active),
                                 attn_impl=attn_impl)
        tc, tl = tmr.decode_step(tm, t(feed[step]), tc, t(active), attn_impl=attn_impl)
        np.testing.assert_allclose(n(tl)[:2], np.asarray(jl)[:2], atol=1e-4, rtol=0)
    assert n(tc.lengths).tolist() == [48, 15, 0]


@pytest.mark.parametrize("attn_impl", ["paged", "fused"])
def test_mqa_greedy_tokens_match_jax(attn_impl):
    """Greedy decoding (decode_loop, 12 steps) through the multi-query
    slice: the port's tokens equal the JAX package's, on the tests' weights
    x25 (their top-2 logit gaps sit far above fp32's order of summation)."""
    jp, tm = _mqa_models(scale=25.0)
    jc, tc = _prefilled(jp, tm)
    first = np.array([5, 9, 11], np.int32)
    _, jt = jmr.decode_loop(jp, MQA_JAX_CFG, jc, jnp.asarray(first), 12, attn_impl=attn_impl)
    _, tt = tmr.decode_loop(tm, tc, t(first), 12, attn_impl=attn_impl)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
