"""The decode kernels at head dims that run inside a wider instantiation:
every multiple of 16 from 48 to 1024 that is not 64 or a multiple of 128
(Phi-2's 80, GPT-NeoX-20B's 96, MPT-30B's 112, StableLM-2-12B's 160), run
at `paged_attention.decode_width` with the columns past d zero-filled.  The
host's routing and plan against what `csrc/decode.cu` admits, read from the
source; the plain versions of the kernels' plans (`paged_attention_split_ref`
for the group tiles, `paged_attention_group_ref` for the whole-group and the
wide kernels) against the JAX package's decode entry points
`decode_attention_paged` / `decode_attention_fused`, which at these head
dims take the JAX package's einsum; the slice: a 2-layer GPT at d = 80 and
a multi-query one at d = 96 through `decode_step(attn_impl="paged" |
"fused")` against the JAX package's; and the head dims that still raise.
Inputs are numpy from a seed; fp8 payloads cross as uint8 views."""

import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_cases import ALL_PAYLOADS, TOL, c_instantiated_width, jax_cache
from _torch_port import JAX_CFG, TORCH_CFG, from_jax, jax_tree, n, numpy_params, randn, t, torch_cache
from flash_attention_tpu.inference import kv_cache as jkvc
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES
from flash_attention_tpu_torch.models import gpt as tgpt

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
tda = importlib.import_module("flash_attention_tpu_torch.inference.decode_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

CSRC = Path(tpa.__file__).resolve().parents[1] / "csrc"
DIMS = (48, 80, 96, 112, 160, 192, 320)
WIDTH = {48: 64, 80: 128, 96: 128, 112: 128, 160: 256, 192: 256, 320: 512}
Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _c_predicate(text: str, signature: str):
    """A one-line C function `bool name(int d) { return <expr>; }` of
    decode.cu as a Python predicate of d."""
    body = re.search(re.escape(signature) + r" \{ return (.*?); \}", text).group(1)
    expr = body.replace("||", " or ").replace("&&", " and ")
    return lambda d: bool(eval(expr, {"d": d}))


def test_head_dims_mirror_what_the_kernels_admit():
    """`HEAD_DIMS` is what decode.cu's entry points admit, for every d from
    1 to 1100: the narrow kernel's (narrow_head_dim), the group tiles'
    (launch_decode: instantiated_width from 48), the whole-group kernels'
    (group_head_dim) and the wide kernel's (wide_head_dim); every head dim
    of `HEAD_DIMS` routes, at every q dtype and group, to a kernel whose
    entry point admits it, at the width `decode_width` gives; and the split
    kernel's workspace rows are D + 2 floats wide, as the host sizes them
    (`decode_width(d) + 2`), in its writes and in its merge."""
    decode_cu = (CSRC / "decode.cu").read_text()
    decode_cuh = (CSRC / "decode.cuh").read_text()
    narrow = _c_predicate(decode_cu, "bool narrow_head_dim(int d)")
    wide = _c_predicate(decode_cu, "bool wide_head_dim(int d)")
    width = c_instantiated_width()
    rule = re.search(r"const int width = head_dim >= (\d+) \? instantiated_width\(head_dim\) : 0;", decode_cu)
    tiles = lambda d: width(d) if d >= int(rule.group(1)) else 0  # noqa: E731
    admitted = {d for d in range(1, 1101) if narrow(d) or tiles(d) or width(d) or wide(d)}
    assert admitted == set(tpa.HEAD_DIMS)
    assert set(tpa.HEAD_DIMS) == {8, 16, 32} | set(range(48, 1025, 16))
    for d in tpa.HEAD_DIMS:
        for q_dtype in Q_DTYPES:
            for group in (1, 4, 8, 9, 16, 71):
                if tpa.uses_wide_kernel(q_dtype, d, group):
                    assert wide(d) and tpa.decode_width(d) == (512 if d <= 512 else 1024)
                elif tpa.uses_group_kernel(q_dtype, d, group):
                    assert width(d) == tpa.decode_width(d) and group > tpa.MAX_ROWS
                elif tpa.uses_narrow_kernel(q_dtype, d, group):
                    assert narrow(d) and group <= tpa.MAX_ROWS
                else:
                    assert tiles(d) == tpa.decode_width(d) and group <= tpa.MAX_ROWS
    kernel = decode_cuh[decode_cuh.index("decode_kernel(const DecodeParams p)"):]
    assert "(d + 2)" not in kernel and kernel.count("(D + 2)") == 6
    assert "float* part = live > 1 ? p.ws + (pair * p.splits + split) * p.rows * (D + 2)" in kernel
    assert "const float* parts = p.ws + pair * p.splits * p.rows * (D + 2);" in kernel
    assert "rows * (decode_width(d) + 2)" in inspect.getsource(tpa._launch_decode)


def _resident(kind, index, q_code, kv_code, d, rows, paged):
    """A card that holds 16 clusters of every size at once."""
    return {c: 16 for c in tpa.CLUSTER_SIZES[kind]}


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("q_dtype", Q_DTYPES, ids=["fp32", "bf16", "fp16"])
def test_routing_and_plan(d, q_dtype, monkeypatch):
    """Which kernel, at which width, with which split: groups of up to 8
    at d 48-240 the group tiles (`cluster_plan` None; `decode_split` as at
    any width), a group of 16 the
    whole-group kernel at the width's stage and pass limits (`group_tokens`,
    `group_max_rows`: an fp32 cache at d 80 takes D128's 64 tokens), d 320
    the wide kernel at D512's stage, for every group."""
    monkeypatch.setattr(tpa, "_resident_clusters", _resident)
    w = WIDTH[d]
    assert tpa.decode_width(d) == w
    for payload, itemsize in ((q_dtype, q_dtype.itemsize), (torch.int8, 1)):
        if w <= 256:
            assert tpa.group_tokens(d, itemsize) == tpa.group_tokens(w, itemsize)
        for group in (1, 4, 16):
            plan = tpa.cluster_plan(q_dtype, payload, d, group, 2048, 16, 8, True, 0)
            if d > 256:
                tokens = tpa.wide_tokens(w, itemsize)
                assert plan[0] == "wide" and plan[1:3] == tpa.wide_passes(group)
            elif group > tpa.MAX_ROWS:
                tokens = tpa.group_tokens(w, itemsize)
                assert plan[0] == "group"
                assert plan[1:3] == tpa.group_passes(group, tpa.group_max_rows(q_dtype, w))
                assert tpa.group_max_rows(q_dtype, d) == tpa.group_max_rows(q_dtype, w)
            else:
                assert plan is None  # the group tiles: decode_split, which no head dim changes
                continue
            cluster, chunk, walks = plan[3:]
            assert (cluster, chunk, walks) == tpa.decode_cluster_split(2048, 8 * plan[1], 16,
                                                                       _resident(plan[0], 0, 0, 0, d, 0, True),
                                                                       True, tokens)
            assert cluster * chunk * walks >= 2048


# (head dim, q heads, KV heads, payload): at each head dim groups 1, 4 and
# 16, each with two of fp32, bf16, bf16 over int8 and fp16 over fp8 pages,
# taken in turn so that each head dim meets all four
PAYLOAD_TURNS = ("fp32", "bf16", "bf16-int8", "fp16-fp8")
CASES = [(d, group * hkv, hkv, PAYLOAD_TURNS[(j + k + i) % 4])
         for j, d in enumerate(DIMS) for k, (group, hkv) in enumerate(((1, 2), (4, 2), (16, 1)))
         for i in (0, 2)]
CASE_IDS = [f"d{d}-hq{hq}-hkv{hkv}-{payload}" for d, hq, hkv, payload in CASES]
MAX_LEN = 256


def _plan(hq, hkv, d, payload, paged, lengths):
    """The kernels' split of these cases on a card that holds 3 clusters of
    each size a pair: (ref, keyword arguments) of the plan's plain version,
    `paged_attention_split_ref` with the group tiles' chunk or
    `paged_attention_group_ref` with the cluster kernel's."""
    qdt, quant = ALL_PAYLOADS[payload]
    q_dtype = from_jax(jnp.zeros((), qdt)).dtype
    itemsize = 1 if quant is not None else q_dtype.itemsize
    group, pairs = hq // hkv, len(lengths) * hkv
    unit = 16 if paged else None
    if tpa.uses_wide_kernel(q_dtype, d, group):
        tokens, passes = tpa.wide_tokens(d, itemsize), tpa.wide_passes(group)[0]
    elif tpa.uses_group_kernel(q_dtype, d, group):
        tokens = tpa.group_tokens(d, itemsize)
        passes = tpa.group_passes(group, tpa.group_max_rows(q_dtype, d))[0]
    else:
        chunk, _ = tpa.decode_split(MAX_LEN, pairs * tpa.group_tiles(group)[0], unit or tpa.DECODE_TILE, 4)
        return tpa.paged_attention_split_ref, dict(chunk=chunk)
    resident = {c: 3 * pairs * passes for c in (1, 2, 4)}
    cluster, chunk, _ = tpa.decode_cluster_split(MAX_LEN, pairs * passes, unit or tokens, resident, paged, tokens)
    return tpa.paged_attention_group_ref, dict(cluster=cluster, chunk=chunk)


def _lengths(hq, hkv, d, payload):
    """Cache lengths (the current token excluded) on the plan's edges: 0, a
    chunk's last token and the next chunk's first, and the capacity's last."""
    _, kw = _plan(hq, hkv, d, payload, False, (0, 0, 0, 0))
    chunk = kw["chunk"]
    return tuple(min(x, MAX_LEN - 1) for x in (0, chunk - 1, chunk, MAX_LEN - 1))


@pytest.mark.parametrize("d,hq,hkv,payload", CASES, ids=CASE_IDS)
def test_k5_plan_matches_jax_decode_attention_paged(d, hq, hkv, payload):
    """K5's plan in plain PyTorch over the page view of a one-layer cache
    (pages of 16) against the JAX package's `decode_attention_paged` on the
    same cache, at lengths on the plan's chunk edges; also the port's own
    `decode_attention_paged` on the CPU (the plain version, no launch)."""
    qdt, _ = ALL_PAYLOADS[payload]
    lengths = _lengths(hq, hkv, d, payload)
    jc = jax_cache(hkv, d, payload, lengths=lengths, max_len=MAX_LEN, seed=d)
    q = jnp.asarray(randn(d + 1, len(lengths), hq, d), qdt)
    jout = np.asarray(jda.decode_attention_paged(q, jc, 0, page_size=16), np.float32)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, 16)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, 16, device="cpu")
    ref, kw = _plan(hq, hkv, d, payload, True, lengths)
    tq = from_jax(q)
    before = dict(KERNEL_LAUNCHES)
    got = ref(tq, kp, vp, tc.lengths + 1, pi, k_scales=ks, v_scales=vs, **kw)
    entry = tda.decode_attention_paged(tq, tc, 0, page_size=16)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = TOL["fp32" if payload.startswith("fp32") else "fp16"]
    np.testing.assert_allclose(n(got.float()), jout, atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(entry.float()), jout, atol=atol, rtol=rtol)


@pytest.mark.parametrize("d,hq,hkv,payload", CASES, ids=CASE_IDS)
def test_k6_plan_matches_jax_decode_attention_fused(d, hq, hkv, payload):
    """K6's plan in plain PyTorch (q pre-scaled and rounded to its dtype)
    over the slot-major layer's view against the JAX package's
    `decode_attention_fused` on the same cache, at lengths on the plan's
    chunk edges; also the port's own `decode_attention_fused` on the CPU."""
    qdt, _ = ALL_PAYLOADS[payload]
    lengths = _lengths(hq, hkv, d, payload)
    jc = jax_cache(hkv, d, payload, lengths=lengths, max_len=MAX_LEN, seed=d + 2)
    q = jnp.asarray(randn(d + 3, len(lengths), hq, d), qdt)
    jout = np.asarray(jda.decode_attention_fused(q, jc, 0), np.float32)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    ref, kw = _plan(hq, hkv, d, payload, False, lengths)
    tq = from_jax(q)
    got = ref(tq, kp, vp, tc.lengths + 1, pi, k_scales=ks, v_scales=vs, prescale_q=True, **kw)
    entry = tda.decode_attention_fused(tq, tc, 0)
    atol, rtol = TOL["fp32" if payload.startswith("fp32") else "fp16"]
    np.testing.assert_allclose(n(got.float()), jout, atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(entry.float()), jout, atol=atol, rtol=rtol)


# the slice: a 2-layer GPT with 2 heads of 80 (Phi-2's head dim), and one
# with 16 q heads of 96 on one KV head (a group of 16: the whole-group
# kernel on the card)
SLICES = {
    "d80": dict(n_head=2, n_embd=160),
    "d96-group16": dict(n_head=16, n_embd=1536, n_kv_head=1),
}
SLOTS = 3


def _slice(name: str, scale: float = 1.0):
    jcfg = dataclasses.replace(JAX_CFG, **SLICES[name])
    tcfg = dataclasses.replace(TORCH_CFG, **SLICES[name])
    tree = numpy_params(seed=5, scale=scale, cfg=jcfg)
    jp, tm = jax_tree(tree), tgpt.params_from_jax(tree, tcfg, device="cpu")
    args = (jcfg.n_layer, SLOTS, jcfg.kv_heads, MAX_LEN, jcfg.head_dim)
    jc, tc = jkvc.init_cache(*args, dtype=jnp.float32), tkvc.init_cache(*args, dtype=torch.float32, device="cpu")
    prompt = np.arange(1, 41, dtype=np.int32) % jcfg.vocab_size
    for slot, p in ((0, prompt), (1, prompt[:7])):
        jc, _ = jmr.prefill(jp, jnp.asarray(p), jcfg, jc, jnp.int32(slot))
        tc, _ = tmr.prefill(tm, t(p), tc, slot)
    return jcfg, jp, tm, jc, tc


@pytest.mark.parametrize("attn_impl", ["paged", "fused"])
@pytest.mark.parametrize("name", SLICES)
def test_slice_decode_steps_match_jax(name, attn_impl):
    """8 teacher-forced decode steps after prefills of 40 and 7 tokens, slot
    2 inactive: the port's `decode_step(attn_impl=...)` logits against the
    JAX package's at 1e-4 (the fp32 tier of the chained decode steps of
    tests/test_torch_inference.py)."""
    jcfg, jp, tm, jc, tc = _slice(name)
    assert tm.cfg.head_dim in (80, 96) and tm.cfg.head_dim in tpa.HEAD_DIMS
    active = np.array([True, True, False])
    feed = np.random.default_rng(11).integers(0, jcfg.vocab_size, (8, SLOTS)).astype(np.int32)
    for step in range(8):
        jc, jl = jmr.decode_step(jp, jnp.asarray(feed[step]), jcfg, jc, jnp.asarray(active), attn_impl=attn_impl)
        tc, tl = tmr.decode_step(tm, t(feed[step]), tc, t(active), attn_impl=attn_impl)
        np.testing.assert_allclose(n(tl)[:2], np.asarray(jl)[:2], atol=1e-4, rtol=0)
    assert n(tc.lengths).tolist() == [48, 15, 0]


@pytest.mark.parametrize("attn_impl", ["paged", "fused"])
@pytest.mark.parametrize("name", SLICES)
def test_slice_greedy_tokens_match_jax(name, attn_impl):
    """Greedy decoding (decode_loop, 8 steps) through the slice: the port's
    tokens equal the JAX package's, on the tests' weights x25 (their top-2
    logit gaps sit far above fp32's order of summation)."""
    jcfg, jp, tm, jc, tc = _slice(name, scale=25.0)
    first = np.array([5, 9, 11], np.int32)
    _, jt = jmr.decode_loop(jp, jcfg, jc, jnp.asarray(first), 8, attn_impl=attn_impl)
    _, tt = tmr.decode_loop(tm, tc, t(first), 8, attn_impl=attn_impl)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))


@pytest.mark.parametrize("d", [24, 40, 1040, 4])
@pytest.mark.parametrize("entry", ["paged_decode", "fused_decode"])
def test_other_head_dims_raise_before_any_launch(d, entry):
    """d = 24 and 40 (an 8-bit row of 24 or 40 bytes is not whole 16-byte
    pieces), 1040 (past the 1024 that caps the port) and 4 (below 8) raise
    NotImplementedError, naming what is taken, before any launch: before
    the launcher looks at the tensors' device."""
    q = torch.zeros(2, 4, d)
    payload = torch.zeros(2, 2, 16, d, dtype=torch.int8)
    scales = torch.ones(2, 2, 16)
    lengths = torch.tensor([3, 5], dtype=torch.int32)
    pi = torch.zeros(2, 1, dtype=torch.int32) if entry == "paged_decode" else None
    before = dict(KERNEL_LAUNCHES)
    with pytest.raises(NotImplementedError, match="every multiple of 16 from 48 to 1024"):
        tpa._launch_decode(entry, q, payload, payload, scales, scales, lengths, pi, sm_scale=0.125, len_add=1)
    assert KERNEL_LAUNCHES == before
