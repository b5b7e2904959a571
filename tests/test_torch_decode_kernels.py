"""Decode kernels' plain versions against the JAX package: K5
(`paged_attention`, plain route = `paged_attention_ref`) against JAX's
`paged_attention` in Pallas interpret mode and its reference; the page view
of the cache; the quantized einsum `decode_attention` (K6's plain version)
and `decode_attention_paged` / `decode_attention_fused` on the same cache
contents as JAX's `decode_attention`.  Inputs are numpy from a seed; fp8
payloads cross as uint8 views."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, from_jax, n, randn, t, torch_cache
from flash_attention_tpu.inference import kv_cache as jkvc
from flash_attention_tpu.quant import kv as jq
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
jpa = importlib.import_module("flash_attention_tpu.inference.paged_attention")
tda = importlib.import_module("flash_attention_tpu_torch.inference.decode_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

QUANT = {None: None, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}

# fp32 tolerance of the JAX package's own quantized-page test
# (tests/test_paged_attention.py): atol 5e-5, rtol 1e-4.
ATOL, RTOL = 5e-5, 1e-4


def _pages(quant, batch=4, hq=8, hkv=2, d=64, page_size=16, pps=8, seed=0):
    """q, a permuted page table over more pages than the sequences use, and
    pages (quantized with the JAX package's quantize_tokens when `quant`)."""
    n_pages = batch * pps + 3
    rng = np.random.default_rng(seed)
    q = randn(seed, batch, hq, d)
    kp, vp = randn(seed + 1, hkv, n_pages, page_size, d), randn(seed + 2, hkv, n_pages, page_size, d)
    pi = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    if quant is None:
        return q, pi, (jnp.asarray(kp), jnp.asarray(vp), None, None)
    kq, ks = jq.quantize_tokens(jnp.asarray(kp), QUANT[quant])
    vq, vs = jq.quantize_tokens(jnp.asarray(vp), QUANT[quant])
    return q, pi, (kq, vq, ks, vs)


def _torch_pages(pages):
    return tuple(None if a is None else from_jax(a) for a in pages)


@pytest.mark.parametrize("quant", QUANT)
def test_paged_matches_jax_kernel_and_reference(quant):
    """Ragged lengths including 0 (counts as 1) and 1, a permuted page
    table, GQA (8 q heads on 2 KV heads)."""
    q, pi, pages = _pages(quant)
    lengths = np.array([1, 17, 100, 0], np.int32)
    kw = dict(k_scales=pages[2], v_scales=pages[3])
    jout = jpa.paged_attention(jnp.asarray(q), pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=2, **kw)
    jref = jpa.paged_attention_ref(jnp.asarray(q), pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi), **kw)
    kp, vp, ks, vs = _torch_pages(pages)
    before = dict(KERNEL_LAUNCHES)
    tout = tpa.paged_attention(t(q), kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # the plain route launches nothing
    assert tout.shape == q.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(n(tout), np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(n(tout), np.asarray(jref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quant", QUANT)
def test_paged_garbage_past_length_does_not_leak(quant):
    """NaN in every page slot past a sequence's length (payload, or scales
    for a quantized cache) leaves the output finite and unchanged."""
    q, pi, pages = _pages(quant, batch=2, pps=4)
    lengths = np.array([5, 40], np.int32)
    kp, vp, ks, vs = _torch_pages(pages)
    clean = tpa.paged_attention(t(q), kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    page_size = kp.shape[2]
    for b, length in enumerate(lengths):
        for j, page in enumerate(pi[b]):
            start = max(0, int(length) - j * page_size)
            if start >= page_size:
                continue
            if quant is None:
                kp[:, page, start:] = float("nan")
                vp[:, page, start:] = float("nan")
            else:
                ks[:, page, start:] = float("nan")
                vs[:, page, start:] = float("nan")
    dirty = tpa.paged_attention(t(q), kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)


def _jax_cache(quant, lengths=(0, 16, 139), hkv=2, max_len=256, d=64, n_layer=2, seed=20):
    """A JAX cache filled by its own prefill_write/decode_write with ragged
    lengths: the current token of slot s sits at lengths[s], and every slot
    holds data (garbage to the mask) up to the longest length."""
    slots, fill = len(lengths), max(lengths) + 1
    c = jkvc.init_cache(n_layer, slots, hkv, max_len, d, dtype=jnp.float32, quant_dtype=QUANT[quant])
    for layer in range(n_layer):
        for s in range(slots):
            c = jkvc.prefill_write(c, layer, jnp.int32(s), jnp.asarray(randn(seed + 10 * layer + s, hkv, fill, d)),
                                   jnp.asarray(randn(seed + 10 * layer + s + 5, hkv, fill, d)))
    pos = jnp.asarray(lengths, jnp.int32)
    c = jkvc.decode_write(c, 1, jnp.asarray(randn(seed + 99, slots, hkv, d)),
                          jnp.asarray(randn(seed + 98, slots, hkv, d)), pos)
    return dataclasses.replace(c, lengths=pos)


@pytest.mark.parametrize("quant", QUANT)
def test_page_view_and_identity_indices_match_jax(quant):
    jc = _jax_cache(quant)
    tc = torch_cache(jc)
    for a, b in zip(tkvc.page_view(tc, 1, 64), jkvc.page_view(jc, 1, 64)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape
        raw = bits if a.element_size() == 1 else n
        np.testing.assert_array_equal(raw(a), raw(b))
    k_pages = tkvc.page_view(tc, 1, 64)[0]
    assert k_pages.data_ptr() == tc.k[1].data_ptr()  # a view, not a copy
    np.testing.assert_array_equal(n(tkvc.identity_page_indices(3, 256, 64, device="cpu")),
                                  np.asarray(jkvc.identity_page_indices(3, 256, 64)))
    with pytest.raises(ValueError, match="page_size"):
        tkvc.page_view(tc, 0, 100)


@pytest.mark.parametrize("impl", ["einsum", "paged", "fused"])
@pytest.mark.parametrize("quant", QUANT)
def test_decode_attention_matches_jax_einsum(quant, impl):
    """Every decode path's plain route against JAX's einsum
    `decode_attention` on the same cache contents, GQA 8 on 2, fp32."""
    jc = _jax_cache(quant)
    tc = torch_cache(jc)
    q = randn(30, 3, 8, 64)
    jout = jda.decode_attention(jnp.asarray(q), jc, 1)
    fn = {"einsum": tda.decode_attention, "paged": tda.decode_attention_paged, "fused": tda.decode_attention_fused}
    tout = fn[impl](t(q), tc, 1)
    assert tout.shape == q.shape
    np.testing.assert_allclose(n(tout), np.asarray(jout), atol=ATOL, rtol=RTOL)


def test_jax_fused_kernel_interpret_small_case():
    """One small case of JAX's fused kernel in interpret mode (int8, MHA)
    against the port's fused decode (plain route).  atol 1e-2: the TPU kernel
    rounds P to bf16 before its PV product for an int8 cache (pv_dtype,
    decode_attention.py:361), the port to q's dtype (fp32 here).  The same
    cache with fp8 payloads measures that defect: JAX's fused fp8 output lies
    further from its own einsum than the port's does."""
    small = dict(lengths=(0, 70), hkv=4, max_len=128, d=32, seed=40)
    jc = _jax_cache("int8", **small)
    q = randn(41, 2, 4, 32)
    jout = jda.decode_attention_fused(jnp.asarray(q), jc, 1, block=64)
    tout = tda.decode_attention_fused(t(q), torch_cache(jc), 1)
    print(f"int8 cache, fp32 q: |JAX fused - port fused| = {np.abs(n(tout) - np.asarray(jout)).max():.3e}")
    np.testing.assert_allclose(n(tout), np.asarray(jout), atol=1e-2, rtol=0)

    jc8 = _jax_cache("fp8", **small)
    ref = np.asarray(jda.decode_attention(jnp.asarray(q), jc8, 1))
    jax_fused_err = np.abs(np.asarray(jda.decode_attention_fused(jnp.asarray(q), jc8, 1, block=64)) - ref).max()
    port_fused_err = np.abs(n(tda.decode_attention_fused(t(q), torch_cache(jc8), 1)) - ref).max()
    print(f"fp8 cache, fp32 q: |JAX fused - JAX einsum| = {jax_fused_err:.3e}, "
          f"|port fused - JAX einsum| = {port_fused_err:.3e}")
    assert port_fused_err <= ATOL < jax_fused_err


def test_decode_launchers_raise_without_a_card():
    """K5/K6's launcher never falls back: what the kernels do not take (a
    head dim other than 8, 16, 32, 64 or a multiple of 128 up to 1024, or
    int8 q) raises before any launch; what they take (d 32, a GQA group of
    18, fp16 q, and the whole-group and wide entry points) passes validation
    and stops at the device: CPU tensors raise."""
    q, pi, pages = _pages("int8")
    kp, vp, ks, vs = _torch_pages(pages)
    lengths = t(np.array([3, 4, 5, 6], np.int32))

    def launch(q, kp, vp, ks, vs):
        return tpa._launch_decode("paged_decode", q, kp, vp, ks, vs, lengths, t(pi), sm_scale=0.125, len_add=0)

    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        launch(t(q), kp, vp, ks, vs)
    for d in (96, 1040):  # neither JAX kernel runs 96; 1040 is past the port's 1024
        qd = torch.zeros(4, 8, d)
        kd = torch.zeros(kp.shape[:-1] + (d,), dtype=torch.int8)
        with pytest.raises(NotImplementedError, match="head dims"):
            launch(qd, kd, kd, ks, vs)
    with pytest.raises(TypeError, match="float32/bfloat16/float16"):
        launch(t(q).to(torch.int8), kp, vp, ks, vs)
    q18 = t(randn(1, 4, 18, 64))
    for args in ((t(q)[..., :32], kp[..., :32], vp[..., :32], ks, vs),  # head dim 32
                 (q18, kp[:1], vp[:1], ks[:1], vs[:1]),  # a GQA group of 18 q heads
                 (t(q).half(), kp, vp, ks, vs)):  # fp16 q
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            launch(*args)
    # the whole-group entry points (a group above 8, bf16 / fp16 q and the
    # 3xTF32 kernel's fp32 q, D64 / D128): K5 over pages and K6 over one
    # slot-major layer
    slots = lengths.shape[0]
    for qdt in (torch.bfloat16, torch.float16, torch.float32):
        qg = q18.to(qdt)
        assert tpa.uses_group_kernel(qg.dtype, 64, 18)
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            launch(qg, kp[:1], vp[:1], ks[:1], vs[:1])
        layer = torch.zeros(1, slots, 128, 64, dtype=torch.int8)
        scales = torch.ones(1, slots, 128)
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            tpa._launch_decode("fused_decode", qg.expand(slots, -1, -1), layer, layer, scales, scales, lengths, None,
                               sm_scale=0.125, len_add=1)
    # the wide entry points (head dims above 256, every q dtype and group):
    # K5 over pages and K6 over one slot-major layer at d 384 and 1024
    for d, qdt in ((384, torch.float32), (1024, torch.bfloat16), (640, torch.float16)):
        qw = torch.zeros(slots, 8, d, dtype=qdt)
        pages = torch.zeros(kp.shape[:-1] + (d,), dtype=torch.int8)
        assert tpa.uses_wide_kernel(qw.dtype, d, 4)
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            launch(qw, pages, pages, ks, vs)
        layer = torch.zeros(2, slots, 128, d, dtype=torch.int8)
        scales = torch.ones(2, slots, 128)
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            tpa._launch_decode("fused_decode", qw, layer, layer, scales, scales, lengths, None, sm_scale=0.125,
                               len_add=1)


# Sequence lengths (current token included) against a split of `chunk`
# tokens over a capacity of 128: every split but one empty, a split's
# edges, ragged.
def _split_lengths(case: str, chunk: int) -> np.ndarray:
    return {
        "one-split": np.array([0, 1, 1, 0]),
        "edges": np.array([chunk - 1, chunk, chunk + 1, 128]),
        "ragged": np.array([1, 17, 100, 127]),
    }[case].astype(np.int32)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("case", ["one-split", "edges", "ragged"])
@pytest.mark.parametrize("quant", [None, "bf16", "int8", "fp8"])
def test_split_merge_matches_jax_paged_reference(quant, case, chunk):
    """The decode kernels' chunk-and-merge arithmetic in plain PyTorch
    (`paged_attention_split_ref`, K5's scoring) against JAX's
    `paged_attention_ref` and the port's, on a permuted page table over
    more pages than the sequences use, GQA 8/2, pages of 16 tokens, chunks
    of one or two pages: fp32 at the JAX package's quantized-page tolerance
    (atol 5e-5, rtol 1e-4); bf16 q and pages at the bf16 tier (atol 2e-2),
    since P and the output are rounded to bf16 at other points."""
    q, pi, pages = _pages(None if quant == "bf16" else quant, seed=chunk)
    lengths = _split_lengths(case, chunk)
    kw = dict(k_scales=pages[2], v_scales=pages[3])
    if quant == "bf16":
        q = jnp.asarray(q, jnp.bfloat16)
        pages = tuple(None if a is None else jnp.asarray(a, jnp.bfloat16) for a in pages)
    jref = jpa.paged_attention_ref(jnp.asarray(q), pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi), **kw)
    kp, vp, ks, vs = _torch_pages(pages)
    tq = from_jax(q)
    got = tpa.paged_attention_split_ref(tq, kp, vp, t(lengths), t(pi), chunk=chunk, k_scales=ks, v_scales=vs)
    plain = tpa.paged_attention_ref(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = (2e-2, 0) if quant == "bf16" else (ATOL, RTOL)
    np.testing.assert_allclose(n(got.float()), np.asarray(jref, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), atol=atol, rtol=rtol)


@pytest.mark.parametrize("lengths", [(0, 16, 139), (31, 32, 63)], ids=["ragged", "edges"])
@pytest.mark.parametrize("quant", QUANT)
def test_split_merge_k6_matches_jax_einsum(quant, lengths):
    """K6's chunk-and-merge over the slot-major cache: the split reference
    over `page_view(cache, layer, max_len)` (one page per slot) and its
    identity table, with K6's pre-scaled q and lengths + 1, against JAX's
    einsum `decode_attention` on the same cache contents, chunks of 32 over
    a capacity of 256 (so most splits are empty), GQA 8/2, fp32."""
    jc = _jax_cache(quant, lengths=lengths)
    tc = torch_cache(jc)
    q = randn(33, 3, 8, 64)
    jout = jda.decode_attention(jnp.asarray(q), jc, 1)
    kp, vp, ks, vs = tkvc.page_view(tc, 1, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    got = tpa.paged_attention_split_ref(t(q), kp, vp, tc.lengths + 1, pi, chunk=32, k_scales=ks, v_scales=vs,
                                        prescale_q=True)
    np.testing.assert_allclose(n(got), np.asarray(jout), atol=ATOL, rtol=RTOL)


def test_split_merge_gives_nan_no_way_in():
    """NaN in every row past the lengths (scales of a quantized cache)
    leaves the chunk-and-merge output finite and equal to the clean one."""
    q, pi, pages = _pages("int8", batch=2, pps=4)
    lengths = np.array([5, 40], np.int32)
    kp, vp, ks, vs = _torch_pages(pages)
    clean = tpa.paged_attention_split_ref(t(q), kp, vp, t(lengths), t(pi), chunk=16, k_scales=ks, v_scales=vs)
    for b, length in enumerate(lengths):
        for j, page in enumerate(pi[b]):
            start = max(0, int(length) - j * kp.shape[2])
            ks[:, page, start:] = float("nan")
            vs[:, page, start:] = float("nan")
    dirty = tpa.paged_attention_split_ref(t(q), kp, vp, t(lengths), t(pi), chunk=16, k_scales=ks, v_scales=vs)
    assert torch.isfinite(dirty).all() and torch.equal(dirty, clean)


@pytest.mark.parametrize(
    "capacity,pairs,unit,want",
    [
        (1024, 96, 128, (128, 8)),  # GPT-2 serving: 8 slots x 12 heads, K5 pages of 128
        (1024, 96, 16, (128, 8)),  # the same through K6 (its unit is the ring tile), or pages of 16
        (1024, 96, 32, (128, 8)),  # pages of 32: 4 pages a chunk
        (1024, 384, 16, (512, 2)),  # 32 slots x 12 heads
        (4096, 128, 16, (512, 8)),  # Llama-shaped: 16 slots x 8 KV heads
        (1024, 12, 16, (64, 16)),  # one sequence: the smallest chunk, a ring tile per warp
        (1024, 4096, 128, (1024, 1)),  # many sequences: one block each
        (65536, 8, 16, (1024, 64)),  # a long capacity: at most 64 splits
    ],
)
def test_decode_split_choice(capacity, pairs, unit, want):
    """The host's split (chunk, splits) for 132 SMs: whole units, the
    capacity covered, at most 64 splits."""
    chunk, splits = tpa.decode_split(capacity, pairs, unit, 132)
    assert (chunk, splits) == want
    assert chunk % unit == 0 and chunk * splits >= capacity > chunk * (splits - 1) and splits <= tpa.MAX_SPLITS


# What the card holds at once of the whole-group kernel's clusters, by
# cluster size: shaped like an H100's (132 SMs; cudaOccupancyMaxActiveClusters
# read 15 clusters of 8 at D128 with one block an SM, and 132 of 2, 62 of 4,
# 30 of 8 at D64 with two), the sizes not read filled in by one (D128) or two
# (D64) blocks an SM.
RESIDENT_D128 = {1: 132, 2: 66, 4: 30, 8: 15}
RESIDENT_D64 = {1: 264, 2: 132, 4: 62, 8: 30}


@pytest.mark.parametrize(
    "capacity,pairs,unit,resident,paged,want,tokens",
    [
        (2048, 8, 128, RESIDENT_D128, True, (8, 128, 2), 128),  # SantaCoder's layer, K5: a page of 128 a chunk
        (2048, 8, 128, RESIDENT_D128, False, (8, 128, 2), 128),  # the same through K6 (its unit is the stage)
        (2048, 64, 128, RESIDENT_D64, True, (2, 128, 8), 128),  # Falcon-40B's layer: 64 clusters of 4 do not fit
        (2048, 64, 128, RESIDENT_D64, False, (2, 128, 8), 128),
        (1024, 8, 16, RESIDENT_D128, True, (8, 128, 1), 128),  # pages of 16: 8 pages a chunk
        (128, 8, 128, RESIDENT_D128, True, (1, 128, 1), 128),  # one chunk: one block
        (4096, 512, 16, RESIDENT_D64, True, (1, 128, 32), 128),  # many pairs: clusters of 1, 32 chunks a block
        (131072, 8, 16, RESIDENT_D128, True, (8, 128, 128), 128),  # 1024 page ids a block, the most it stages
        (131072, 1024, 16, RESIDENT_D64, True, (8, 128, 128), 128),  # the page ids ask for clusters of 8
        (131072, 1024, 16, RESIDENT_D64, False, (1, 128, 1024), 128),  # K6 stages none
        # an fp32 cache at D128 (fp32 q): stages of 64 tokens; K6 takes a chunk of one stage, K5 a page of 128
        (2048, 8, 128, RESIDENT_D128, True, (8, 128, 2), 64),  # SantaCoder's layer in fp32, K5
        (2048, 8, 64, RESIDENT_D128, False, (8, 64, 4), 64),  # ... and K6: 4 chunks of 64 a block
        (2048, 8, 16, RESIDENT_D128, True, (8, 64, 4), 64),  # pages of 16: 4 pages a chunk
        (131072, 8, 16, RESIDENT_D128, True, (8, 64, 256), 64),  # 1024 page ids a block
    ],
)
def test_decode_group_split_choice(capacity, pairs, unit, resident, paged, want, tokens):
    """The whole-group kernels' split (`decode_cluster_split` at their
    stage, `group_tokens`: 128 tokens, 64 for an fp32 cache at D128): the
    largest cluster of up to 8 whose clusters all fit the card at once and
    leave each block a chunk; chunks of one stage in whole units; the
    capacity covered; K5's page ids within what a block stages."""
    cluster, chunk, walks = tpa.decode_cluster_split(capacity, pairs, unit, resident, paged, tokens)
    assert (cluster, chunk, walks) == want
    assert chunk % unit == 0 and cluster * chunk * walks >= capacity > cluster * chunk * (walks - 1)
    assert cluster <= tpa.CLUSTER_MAX and (not paged or walks * chunk // unit <= tpa.CLUSTER_MAX_PAGES)
    with pytest.raises(NotImplementedError, match="page ids"):
        tpa.decode_cluster_split(262144, 8, 16, RESIDENT_D128, True, tokens)


def test_decode_split_gives_two_waves_at_the_serving_shape():
    """At GPT-2 serving's shape (8 slots x 12 heads, contexts 485-534 of
    1024) the live blocks fill 132 SMs at least twice over."""
    chunk, _ = tpa.decode_split(1024, 96, 128, 132)
    live = sum(-(-n // chunk) for n in range(486, 536, 7)) * 12 * 8 / len(range(486, 536, 7))
    assert live >= 2 * 132
    with pytest.raises(NotImplementedError, match="at most"):
        tpa.decode_split(1 << 20, 8, 1, 132)


def test_identity_table_is_made_once():
    a = tda.identity_table(3, 256, 64, torch.device("cpu"))
    assert a is tda.identity_table(3, 256, 64, torch.device("cpu"))
    np.testing.assert_array_equal(n(a), n(tkvc.identity_page_indices(3, 256, 64, device="cpu")))
