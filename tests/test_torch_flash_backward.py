"""Flash attention backward: the port's autograd Functions, which take the
plain backward (`flash_attention_bwd_reference`) on CPU tensors, against
`jax.grad` of the JAX package's flash_attention (Pallas in interpret mode),
same numpy inputs and cotangents, fp32, 1e-4 (the source repo's backward
tier).

K2/K3 themselves run only on the card (`python3 chip_smoke.py` holds them
against this plain backward there)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, randn, t
from flash_attention_tpu.kernels import block_sizes as jbs
from flash_attention_tpu_torch.kernels import block_sizes as tbs
from flash_attention_tpu_torch.kernels.vanilla import vanilla_attention

# The packages' kernels/__init__ re-export functions named like the modules.
jfa = importlib.import_module("flash_attention_tpu.kernels.flash_attention")
tfa = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
tkv = importlib.import_module("flash_attention_tpu_torch.quant.kv")


def _segment_ids(b, length, n_seg=3):
    return np.repeat(np.arange(n_seg, dtype=np.int32), -(-length // n_seg))[None, :length].repeat(b, 0)


def _inputs(b, hq, hkv, lq, lk, d=16, seed=0):
    return (
        randn(seed, b, hq, lq, d),
        randn(seed + 1, b, hkv, lk, d),
        randn(seed + 2, b, hkv, lk, d),
        randn(seed + 3, b, hq, lq, d),  # the output cotangent
    )


def _torch_grads(q, k, v, do, **kw):
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    tfa.flash_attention(qt, kt, vt, **kw).backward(t(do))
    return qt.grad, kt.grad, vt.grad


def _jax_grads(q, k, v, do, **kw):
    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


# (id, (b, hq, hkv, lq, lk[, d]), torch kwargs, jax kwargs).  The plain
# backward runs at the CUDA kernels' tiles by default (dK/dV: 64 query rows
# against 128 KV rows; dQ: 128 query rows against 64 KV rows), whose block
# skips the causal rule and the window decide.
CASES = [
    ("L128", (1, 2, 2, 128, 128), {}, {}),
    ("L200", (1, 2, 2, 200, 200), {}, {}),
    ("L384", (1, 2, 2, 384, 384), {}, {}),
    ("L40-dense", (1, 2, 2, 40, 40), {}, {}),
    ("gqa-hq4-hkv2", (1, 4, 2, 200, 200), {}, {}),
    ("lq<lkv", (1, 2, 2, 128, 384), {}, {}),
    ("non-causal", (1, 2, 2, 200, 200), dict(causal=False), dict(causal=False)),
    ("window", (1, 2, 2, 384, 384), dict(window=100), dict(window=100)),
    ("segments", (2, 2, 1, 200, 200), "segments", "segments"),
    ("block_sizes", (1, 2, 2, 300, 300), dict(block_sizes=tbs.BlockSizes(128, 256)),
     dict(block_sizes=jbs.BlockSizes(128, 256))),
    ("num_chunks", (1, 2, 2, 256, 256), dict(num_chunks_q=2, num_chunks_kv=2),
     dict(num_chunks_q=2, num_chunks_kv=2)),
    ("tiles-gqa-8-2-d64", (1, 8, 2, 300, 300, 64), {}, {}),
    ("tiles-ragged-q129-kv257-d64", (1, 4, 4, 129, 257, 64), {}, {}),
    ("tiles-window-d64", (1, 4, 2, 257, 257, 64), dict(window=100), dict(window=100)),
    ("tiles-segments-d64", (2, 4, 1, 200, 200, 64), "segments", "segments"),
    ("tiles-d128-non-causal", (1, 2, 2, 200, 200, 128), dict(causal=False), dict(causal=False)),
]


@pytest.mark.parametrize("shape,kw_t,kw_j", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_grads_match_jax(shape, kw_t, kw_j):
    b, hq, hkv, lq, lk, *d = shape
    q, k, v, do = _inputs(b, hq, hkv, lq, lk, *d)
    if kw_t == "segments":
        ids = _segment_ids(b, lq)
        kw_t, kw_j = dict(segment_ids=t(ids)), dict(segment_ids=jnp.asarray(ids))
    got = _torch_grads(q, k, v, do, **kw_t)
    want = _jax_grads(q, k, v, do, **kw_j)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


def test_lse_cotangent_matches_jax():
    """flash_attention_with_lse is differentiable in both outputs: the lse
    cotangent shifts di (JAX `_flash_lse_bwd_rule`); the plain backward runs
    at the CUDA kernels' tiles."""
    q, k, v, do = _inputs(1, 4, 2, 200, 200, seed=5)
    dlse = randn(9, 1, 4, 200)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(qt, kt, vt)
    torch.autograd.backward((o, lse), (t(do), t(dlse)))
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ["lq>lkv", "segment-without-keys"])
def test_fully_masked_rows_give_finite_grads(case):
    """A query row that sees no key has lse = -inf; the plain backward (as
    K2/K3) gives it P = 0 instead of exp2(-inf + inf) = NaN.  The
    reference leaves such rows' forward undefined, so only finiteness is
    pinned."""
    if case == "lq>lkv":
        q, k, v, do = _inputs(1, 2, 2, 200, 136, seed=11)
        kw = {}
    else:
        q, k, v, do = _inputs(1, 2, 2, 200, 200, seed=12)
        q_ids = _segment_ids(1, 200)
        kv_ids = np.where(q_ids == 1, 2, q_ids)  # segment 1 has no keys
        kw = dict(segment_ids=(t(q_ids), t(kv_ids)))
    out = tfa.flash_attention(*(t(x) for x in (q, k, v)), **kw)
    assert torch.isfinite(out).all()
    for g in _torch_grads(q, k, v, do, **kw):
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("block", [(64, 64), (128, 32), (32, 128)])
def test_plain_backward_tiling_does_not_change_result(block):
    """Any tiling of the plain backward gives dense attention's grads."""
    q, k, v, do = _inputs(1, 2, 1, 150, 150, seed=13)
    bs = tbs.BlockSizes(block_q=block[0], block_kv=block[1])
    got = _torch_grads(q, k, v, do, block_sizes=bs)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    vanilla_attention(qt, kt.repeat_interleave(2, 1), vt.repeat_interleave(2, 1), sm_scale=0.25).backward(t(do))
    for g, w in zip(got, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(n(g), n(w), atol=1e-5, rtol=0)


def test_backward_on_cpu_counts_no_kernel_launch():
    q, k, v, do = _inputs(1, 2, 2, 128, 128)
    before = dict(tfa.KERNEL_LAUNCHES)
    _torch_grads(q, k, v, do)
    assert tfa.KERNEL_LAUNCHES == before


def test_forward_records_a_graph_only_when_grad_is_needed():
    q, k, v, _ = (t(x) for x in _inputs(1, 2, 2, 128, 128))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    assert type(tfa.flash_attention(q, k, v).grad_fn).__name__ == "_FlashBackward"


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_backward_kernel_fits_in_shared_memory(dtype, kernel, head_dim):
    """Every instantiation of the bf16/fp16 backward (dtype, kernel, head
    dim) fits an H100 block's 227 KB; the 2-byte types share a layout.  The
    pinned tiles and each slot's streamed tiles are a lower bound."""
    used = tbs.backward_smem_bytes(head_dim, kernel)
    streamed = 3 if kernel == "dkv" else 2
    tiles = 2 * tbs.KERNEL_BWD_PINNED + tbs.backward_stages(head_dim, kernel) * streamed * tbs.KERNEL_BWD_STREAM
    assert tiles * head_dim * 2 <= used <= tbs.SMEM_PER_BLOCK == 232_448


def test_d256_dkv_kernel_fits_in_shared_memory():
    """K2's bf16/fp16 kernel at head dim 256 (DkvCfg<256>): K and V pinned
    at 64 rows (64 KB) and three ring slots of 32-row qs, q and dO tiles (48
    KB each) fit an H100 block's 227 KB; two 64-row slots would not."""
    assert tbs.backward_tiles(256, "dkv") == (64, 32) and tbs.backward_stages(256, "dkv") == 3
    used = tbs.backward_smem_bytes(256, "dkv")
    assert (2 * 64 + 3 * 3 * 32) * 256 * 2 <= used <= tbs.SMEM_PER_BLOCK
    assert (2 * 64 + 2 * 3 * 64) * 256 * 2 > tbs.SMEM_PER_BLOCK


def test_d256_dq_kernel_fits_in_shared_memory():
    """K3's bf16/fp16 kernel at head dim 256 (DqCfg<256>): qs and dO pinned
    at 64 rows (64 KB) and two ring slots of 64-row K and V tiles (64 KB
    each) fit an H100 block's 227 KB, with the slots' KV segment ids, the
    barriers and the alignment slack counted as DqCfg lays them out; a
    third 64-row slot, or four, would not."""
    assert tbs.backward_tiles(256, "dq") == (64, 64) and tbs.backward_stages(256, "dq") == 2
    used = tbs.backward_smem_bytes(256, "dq")
    assert used == 2 * 64 * 256 * 2 + 2 * (2 * 64 * 256 * 2 + 64 * 4) + (1 + 2 * 2) * 8 + 1024 == 198_184
    assert used <= tbs.SMEM_PER_BLOCK
    assert (2 * 64 + 3 * 2 * 64) * 256 * 2 > tbs.SMEM_PER_BLOCK
    assert (2 * 64 + 4 * 2 * 64) * 256 * 2 > tbs.SMEM_PER_BLOCK


@pytest.mark.parametrize("with_dlse", [False, True], ids=["di", "di-minus-dlse"])
def test_prep_di_matches_the_jax_backward_rules(with_dlse, monkeypatch):
    """The pre-pass's plain di is the di that the JAX package's backward
    rules hand to their kernels (`_flash_bwd_rule`, and `_flash_lse_bwd_rule`
    with the lse cotangent): captured by standing in for `_bwd_dkv` and
    `_bwd_dq`, fp32, 1e-5 (64 products summed in another order)."""
    b, h, length, d = 2, 3, 40, 64
    q, k, v, o = (randn(31 + i, b, h, length, d) for i in range(4))
    do = randn(35, b, h, length, d)
    lse = randn(36, b, h, length)
    dlse = randn(37, b, h, length)
    seen = []

    def capture(params, q, k, v, do, lse, di):
        seen.append(np.asarray(di))
        zeros = jnp.zeros_like(q)
        return (zeros, zeros) if len(seen) % 2 else zeros

    monkeypatch.setattr(jfa, "_bwd_dkv", capture)
    monkeypatch.setattr(jfa, "_bwd_dq", capture)
    res = tuple(jnp.asarray(x) for x in (q, k, v, o, lse))
    if with_dlse:
        jfa._flash_lse_bwd_rule(None, res, (jnp.asarray(do), jnp.asarray(dlse)))
    else:
        jfa._flash_bwd_rule(None, res, jnp.asarray(do))
    assert len(seen) == 2 and np.array_equal(seen[0], seen[1])
    di, _ = tfa.flash_attention_bwd_prep_reference(t(q), t(o), t(do), dlse=t(dlse) if with_dlse else None)
    assert di.dtype == torch.float32 and tuple(di.shape) == (b, h, length)
    np.testing.assert_allclose(n(di), seen[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_prep_qs_matches_the_jax_recompute_p(dtype):
    """The pre-pass's plain qs is the qs that `_recompute_p` makes: with K
    the identity and lse 0 the JAX kernel's P is exp2(qs) entry by entry,
    which tells apart qs values one 16-bit ulp apart; and qs is rounded to
    q's dtype, as the forward kernel rounds it."""
    rows = d = 64
    sm_scale = d ** -0.5
    q = randn(41, rows, d) * 4
    jdt = getattr(jnp, dtype)
    params = jfa._Params(sm_scale=sm_scale, causal=False, q_len=rows, kv_len=d, blocks=jbs.BlockSizes())
    p, _, _ = jfa._recompute_p(
        params, jnp.asarray(q, jdt)[None], jnp.eye(d, dtype=jdt)[None], jnp.zeros((1, 1, rows), jnp.float32),
        0, 0, rows, d, rows, d, False, False,
    )
    qt = t(q).to(getattr(torch, dtype))
    _, qs = tfa.flash_attention_bwd_prep_reference(qt, qt, qt, sm_scale=sm_scale)
    assert qs.dtype == qt.dtype
    np.testing.assert_allclose(n(torch.exp2(qs.float())), np.asarray(p), rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [16, 96, 160, 256, 288, 520])
def test_padded_head_dim_grads_match_jax(d):
    """The CUDA route's padding on the plain versions: q/k/v zero-padded to
    D64, D128, D256, D512 or D1024 with `torch.nn.functional.pad`, the autograd Function there
    with the true sm_scale, out sliced back.  Autograd slices the grads back;
    out, lse and the q/k/v grads (out and lse cotangents) against
    `jax.grad` of the JAX package at d itself: fp32, forward 1e-5, backward
    1e-4."""
    q, k, v, do = _inputs(1, 4, 2, 200, 200, d=d, seed=51)
    dlse = randn(55, 1, 4, 200)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v)
        return jnp.sum(o * do) + jnp.sum(lse * dlse), (o, lse)

    (_, (jo, jl)), want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dp = tfa.padded_head_dim(d)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(*(tfa._pad_head_dim(x, dp) for x in (qt, kt, vt)), sm_scale=d ** -0.5)
    o = o[..., :d]
    np.testing.assert_allclose(n(o), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(lse), np.asarray(jl), atol=1e-5, rtol=0)
    torch.autograd.backward((o, lse), (t(do), t(dlse)))
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want):
        assert g.shape[-1] == d
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("entry", ["flash_attention", "with_lse", "segments"])
@pytest.mark.parametrize("d", [16, 96, 160, 256, 288, 520])
def test_cuda_route_launches_padded_head_dims(d, entry, monkeypatch):
    """On the CUDA route the entry points hand the kernels' launchers q/k/v
    (and dO) padded to D64, D128, D256, D512 or D1024, with sm_scale from the true d, and slice
    the results back.  The launchers are stood in for by recorders that run
    the plain versions, so no card is needed; the results are held against
    JAX at d (fp32, forward 1e-5, backward 1e-4)."""
    seen = []

    def launch(q, k, v, spec, segs, need_lse):
        seen.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1], spec.sm_scale))
        return tfa.flash_attention_reference(q, k, v, causal=spec.causal, sm_scale=spec.sm_scale,
                                             window=spec.window, segment_ids=segs, block_sizes=spec.blocks)

    def launch_bwd(q, k, v, o, lse, do, dlse, spec, segs):
        seen.append(("bwd", q.shape[-1], k.shape[-1], v.shape[-1], do.shape[-1], spec.sm_scale))
        return tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse=dlse, causal=spec.causal,
                                                 sm_scale=spec.sm_scale, window=spec.window, segment_ids=segs,
                                                 block_sizes=spec.blocks)

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_launch", launch)
    monkeypatch.setattr(tfa, "_launch_bwd", launch_bwd)
    q, k, v, do = _inputs(2, 4, 2, 130, 130, d=d, seed=61)
    kw_t = kw_j = {}
    if entry == "segments":
        ids = _segment_ids(2, 130)
        kw_t, kw_j = dict(segment_ids=t(ids)), dict(segment_ids=jnp.asarray(ids))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    if entry == "with_lse":
        out, _ = tfa.flash_attention_with_lse(qt, kt, vt)
        jfn = lambda *a: jfa.flash_attention_with_lse(*a)[0]  # noqa: E731
    else:
        out = tfa.flash_attention(qt, kt, vt, **kw_t)
        jfn = functools.partial(jfa.flash_attention, **kw_j)
    out.backward(t(do))
    dp = next(p for p in (64, 128, 256, 512, 1024) if d <= p)
    assert seen == [("fwd", dp, dp, dp, d ** -0.5), ("bwd", dp, dp, dp, dp, d ** -0.5)]
    want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    assert out.shape == q.shape
    np.testing.assert_allclose(n(out), np.asarray(want), atol=1e-5, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("entry", ["flash_attention", "with_lse", "kv_quant"])
def test_cuda_route_raises_above_head_dim_1024(entry, monkeypatch):
    """No public model config has a head dim above 256: every kernel is
    built for padded head dims 64 to 1024, and on the CUDA route D1040
    raises before any launch (the real launchers check the head dim before
    they build or load the kernels, so no card is needed to see it)."""
    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    before = dict(tfa.KERNEL_LAUNCHES)
    q = torch.zeros(1, 4, 130, 1040)
    kv = torch.zeros(1, 2, 130, 1040)
    with pytest.raises(NotImplementedError, match="1040"):
        if entry == "flash_attention":
            tfa.flash_attention(q, kv, kv)
        elif entry == "with_lse":
            tfa.flash_attention_with_lse(q, kv, kv)
        else:
            tkv.flash_attention_kv_quant(q, tkv.quantize_kv(kv, kv))
    assert tfa.KERNEL_LAUNCHES == before


# Where each C entry point takes its head dim (the index in its arguments).
_HEAD_DIM_ARG = {
    "fa_flash_fwd": 13, "fa_flash_fwd_kv_quant": 15, "fa_flash_bwd_prep": 10, "fa_flash_bwd_dkv": 17,
    "fa_flash_bwd_dq": 16,
}
# Where the backward's entry points take qs (written by the pre-pass, read by
# the wgmma K2 / K3).
_QS_ARG = {"fa_flash_bwd_prep": 4, "fa_flash_bwd_dkv": 6, "fa_flash_bwd_dq": 6}


@pytest.mark.parametrize(
    "d,dtype,fwd,prep,dkv,dq,k4",
    [
        # bf16/fp16 at 256: the wgmma K1, K2, K3 and K4
        (256, torch.bfloat16, ("flash_fwd_d256", "fa_flash_fwd"), ("flash_bwd_prep_d256", "fa_flash_bwd_prep"),
         ("flash_bwd_dkv_d256", "fa_flash_bwd_dkv"), ("flash_bwd_dq_d256", "fa_flash_bwd_dq"),
         ("flash_fwd_kv_quant_d256", "fa_flash_fwd_kv_quant")),
        (160, torch.float16, ("flash_fwd_d256", "fa_flash_fwd"), ("flash_bwd_prep_d256", "fa_flash_bwd_prep"),
         ("flash_bwd_dkv_d256", "fa_flash_bwd_dkv"), ("flash_bwd_dq_d256", "fa_flash_bwd_dq"),
         ("flash_fwd_kv_quant_d256", "fa_flash_fwd_kv_quant")),
        # fp32 at 256: the 3xTF32 K1, K4, K2 and K3 through the plain entry
        # points
        (256, torch.float32, ("flash_fwd_d256_fp32", "fa_flash_fwd"), ("flash_bwd_prep_d256", "fa_flash_bwd_prep"),
         ("flash_bwd_dkv_d256_fp32", "fa_flash_bwd_dkv"), ("flash_bwd_dq_d256_fp32", "fa_flash_bwd_dq"),
         ("flash_fwd_kv_quant_d256_fp32", "fa_flash_fwd_kv_quant")),
        # 257-512 and 513-1024, bf16/fp16: the wide wgmma K1, K4, K2 and K3,
        # keys of their own
        *((d, dtype, ("flash_fwd_wide", "fa_flash_fwd"), ("flash_bwd_prep_wide", "fa_flash_bwd_prep"),
           ("flash_bwd_dkv_wide", "fa_flash_bwd_dkv"), ("flash_bwd_dq_wide", "fa_flash_bwd_dq"),
           ("flash_fwd_kv_quant_wide", "fa_flash_fwd_kv_quant"))
          for d, dtype in ((288, torch.bfloat16), (520, torch.float16), (1024, torch.bfloat16))),
        # fp32 there: the 3xTF32 K1, K4, K2 and K3 under "_wide_fp32"
        *((d, torch.float32, ("flash_fwd_wide_fp32", "fa_flash_fwd"), ("flash_bwd_prep_wide", "fa_flash_bwd_prep"),
           ("flash_bwd_dkv_wide_fp32", "fa_flash_bwd_dkv"), ("flash_bwd_dq_wide_fp32", "fa_flash_bwd_dq"),
           ("flash_fwd_kv_quant_wide_fp32", "fa_flash_fwd_kv_quant"))
          for d in (512, 1024)),
        # fp32 up to 128: K1, K4, K2 and K3 (the 3xTF32 kernels) under
        # "_fp32", the pre-pass under its plain key, all through the plain
        # entry points
        *((d, torch.float32, ("flash_fwd_fp32", "fa_flash_fwd"), ("flash_bwd_prep", "fa_flash_bwd_prep"),
           ("flash_bwd_dkv_fp32", "fa_flash_bwd_dkv"), ("flash_bwd_dq_fp32", "fa_flash_bwd_dq"),
           ("flash_fwd_kv_quant_fp32", "fa_flash_fwd_kv_quant"))
          for d in (64, 96)),
    ],
    ids=["bf16-256", "fp16-160", "fp32-256", "bf16-288", "fp16-520", "bf16-1024", "fp32-512", "fp32-1024", "fp32-64",
         "fp32-96"],
)
def test_cuda_route_reaches_each_kernel(d, dtype, fwd, prep, dkv, dq, k4, monkeypatch):
    """The real launchers on the CUDA route, with the kernel library's C
    entry points stood in for by a recorder (`_call`), so no card is needed:
    each kernel of the forward (K1, and K1 with lse), the backward
    (pre-pass, K2, K3) and K4 reaches the C entry point and the
    KERNEL_LAUNCHES key `_route` names for its dtype and padded head dim,
    with that head dim (257-512 padded to 512, 513-1024 to 1024) in its
    arguments, once each (up to 128 padded to 64 or 128).  The backward is
    handed a qs buffer for bf16/fp16, whose wgmma K2 and K3 read it at
    every head dim, and none for fp32."""
    calls, qs_args = [], []

    def record(entry, device, *args):
        calls.append((entry, args[_HEAD_DIM_ARG[entry]]))
        if entry in _QS_ARG:
            qs_args.append(args[_QS_ARG[entry]])

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(tkv, "_call", record)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    dp = tfa.padded_head_dim(d)
    q = torch.zeros(1, 4, 130, d, dtype=dtype, requires_grad=True)
    k, v = (torch.zeros(1, 2, 130, d, dtype=dtype, requires_grad=True) for _ in range(2))
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tfa.flash_attention(q, k, v)
    assert out.shape == q.shape
    out.backward(torch.zeros_like(out))
    tfa.flash_attention_with_lse(q.detach(), k.detach(), v.detach())
    tkv.flash_attention_kv_quant(q.detach(), tkv.quantize_kv(k.detach(), v.detach()))
    want = [fwd, prep, dkv, dq, fwd, k4]
    assert calls == [(entry, dp) for _, entry in want]
    has_qs = dtype != torch.float32
    assert qs_args == [0 if has_qs else None] * 3
    counts = {key: tfa.KERNEL_LAUNCHES[key] - before[key] for key in tfa.KERNEL_LAUNCHES}
    assert counts == {key: sum(key == w for w, _ in want) for key in tfa.KERNEL_LAUNCHES}


@pytest.mark.parametrize("kernel", ["k1", "k1_lse", "k4_int8", "k4_fp8"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
def test_fp32_forward_counts_under_its_own_keys(kernel, d, dtype, monkeypatch):
    """K1 (with and without lse) and K4 (int8 and fp8 K/V) on the CUDA
    route, the C entry points stood in for by a recorder: fp32 at padded
    head dims 64 and 128 counts one launch under "flash_fwd_fp32" or
    "flash_fwd_kv_quant_fp32" and nothing under the plain keys, and
    bf16 / fp16 never count under the "_fp32" keys; every launch goes
    through the plain entry point with the padded head dim and the dtype's
    code."""
    calls = []
    dtype_arg = {"fa_flash_fwd": 7, "fa_flash_fwd_kv_quant": 8}

    def record(entry, device, *args):
        calls.append((entry, args[_HEAD_DIM_ARG[entry]], args[dtype_arg[entry]]))

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(tkv, "_call", record)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    q = torch.zeros(1, 4, 130, d, dtype=dtype)
    k, v = (torch.zeros(1, 2, 130, d, dtype=dtype) for _ in range(2))
    before = dict(tfa.KERNEL_LAUNCHES)
    if kernel == "k1":
        tfa.flash_attention(q, k, v)
    elif kernel == "k1_lse":
        tfa.flash_attention_with_lse(q, k, v)
    else:
        qdt = torch.int8 if kernel == "k4_int8" else torch.float8_e4m3fn
        tkv.flash_attention_kv_quant(q, tkv.quantize_kv(k.float(), v.float(), dtype=qdt))
    name = "flash_fwd_kv_quant" if kernel.startswith("k4") else "flash_fwd"
    key = f"{name}_fp32" if dtype == torch.float32 else name
    counts = {k_: n - before[k_] for k_, n in tfa.KERNEL_LAUNCHES.items() if n != before[k_]}
    assert counts == {key: 1}
    entry = "fa_flash_fwd_kv_quant" if name == "flash_fwd_kv_quant" else "fa_flash_fwd"
    assert calls == [(entry, tfa.padded_head_dim(d), tfa._DTYPE_CODES[dtype])]


@pytest.mark.parametrize("kernel", ["k1", "k1_lse", "k4_int8", "k4_fp8"])
@pytest.mark.parametrize("d", [160, 256, 288, 520, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
def test_wide_fp32_forward_counts_under_its_own_keys(kernel, d, dtype, monkeypatch):
    """K1 (with and without lse) and K4 (int8 and fp8 K/V) on the CUDA
    route above head dim 128, the C entry points stood in for by a
    recorder: fp32 counts one launch under "flash_fwd_d256_fp32" /
    "flash_fwd_kv_quant_d256_fp32" at padded head dim 256 and
    "flash_fwd_wide_fp32" / "flash_fwd_kv_quant_wide_fp32" at 512 and
    1024 (the 3xTF32 kernel of flash_fwd_fp32_wide.cuh), and nothing under
    any other key; bf16 / fp16 count under "_d256" / "_wide" and never
    under an "_fp32" key.  Every launch goes through the plain entry point
    (no key named "_simt" is left) with the padded head dim and the dtype's
    code, and fp32 K1 with block_q 0 (its one tile)."""
    calls, block_q = [], []
    dtype_arg = {"fa_flash_fwd": 7, "fa_flash_fwd_kv_quant": 8}

    def record(entry, device, *args):
        calls.append((entry, args[_HEAD_DIM_ARG[entry]], args[dtype_arg[entry]]))
        if entry == "fa_flash_fwd":
            block_q.append(args[-1])

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(tkv, "_call", record)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    q = torch.zeros(1, 4, 130, d, dtype=dtype)
    k, v = (torch.zeros(1, 2, 130, d, dtype=dtype) for _ in range(2))
    before = dict(tfa.KERNEL_LAUNCHES)
    if kernel == "k1":
        tfa.flash_attention(q, k, v)
    elif kernel == "k1_lse":
        tfa.flash_attention_with_lse(q, k, v)
    else:
        qdt = torch.int8 if kernel == "k4_int8" else torch.float8_e4m3fn
        tkv.flash_attention_kv_quant(q, tkv.quantize_kv(k.float(), v.float(), dtype=qdt))
    dp = tfa.padded_head_dim(d)
    name = "flash_fwd_kv_quant" if kernel.startswith("k4") else "flash_fwd"
    tier = "_d256" if dp == 256 else "_wide"
    key = f"{name}{tier}_fp32" if dtype == torch.float32 else f"{name}{tier}"
    counts = {k_: n - before[k_] for k_, n in tfa.KERNEL_LAUNCHES.items() if n != before[k_]}
    assert counts == {key: 1}
    assert not any(k_.endswith("_simt") for k_ in tfa.KERNEL_LAUNCHES)
    entry = "fa_flash_fwd_kv_quant" if name == "flash_fwd_kv_quant" else "fa_flash_fwd"
    assert calls == [(entry, dp, tfa._DTYPE_CODES[dtype])]
    if dtype == torch.float32:
        assert block_q == ([0] if entry == "fa_flash_fwd" else [])


@pytest.mark.parametrize("name", ["flash_fwd", "flash_fwd_kv_quant", "flash_bwd_dkv", "flash_bwd_dq"])
def test_d256_route_sends_16_bit_types_to_wgmma_and_fp32_to_3xtf32(name):
    """At padded head dim 256 each of K1, K4, K2 and K3 sends bf16 and fp16
    to its wgmma kernel's entry point under the "_d256" key, and fp32 to the
    same entry point (the 3xTF32 kernels of flash_fwd_fp32_wide.cuh and
    flash_bwd_fp32_wide.cuh) under a "_d256_fp32" key of its own; at 128
    the dtype does not change the entry point.  No key is named "_simt"."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa._route(name, 256, dtype) == (f"{name}_d256", f"fa_{name}")
        assert tfa._route(name, 128, dtype) == (name, f"fa_{name}")
    want = (f"{name}_d256_fp32", f"fa_{name}")
    assert tfa._route(name, 256, torch.float32) == want
    assert want[0] in tfa.KERNEL_LAUNCHES and f"{name}_d256" in tfa.KERNEL_LAUNCHES
    assert f"{name}_d256_simt" not in tfa.KERNEL_LAUNCHES


@pytest.mark.parametrize("d", [512, 1024])
@pytest.mark.parametrize("name", ["flash_fwd", "flash_fwd_kv_quant", "flash_bwd_dkv", "flash_bwd_dq"])
def test_wide_route_sends_16_bit_types_to_wgmma_and_fp32_to_3xtf32(name, d):
    """At padded head dims 512 and 1024 K1, K4, K2 and K3 send bf16 and
    fp16 to their own entry points (the wide wgmma kernels of
    flash_fwd_wide.cuh and flash_bwd_wide.cuh) under the "_wide" key, and
    fp32 to the same entry points (the 3xTF32 kernels of
    flash_fwd_fp32_wide.cuh and flash_bwd_fp32_wide.cuh) under
    "_wide_fp32"."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa._route(name, d, dtype) == (f"{name}_wide", f"fa_{name}")
    want = (f"{name}_wide_fp32", f"fa_{name}")
    assert tfa._route(name, d, torch.float32) == want
    assert all(key in tfa.KERNEL_LAUNCHES for key, _ in (tfa._route(name, d, t) for t in (torch.bfloat16, torch.float32)))
    assert f"{name}_wide_simt" not in tfa.KERNEL_LAUNCHES


# Where the backward's K2 / K3 entry points take q's dtype code.
_BWD_DTYPE_ARG = {"fa_flash_bwd_dkv": 11, "fa_flash_bwd_dq": 10}


@pytest.mark.parametrize("d", [288, 520])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_wide_backward_reaches_the_wgmma_entries_with_the_c_arguments(dtype, d, monkeypatch):
    """flash_attention's backward at head dims 288 and 520 (padded to 512
    and 1024) on the CUDA route, the C entry points stood in for by a
    recorder (`_call`): K2 and K3 reach fa_flash_bwd_dkv and fa_flash_bwd_dq
    (the wide wgmma kernels) with the padded head dim, q's dtype code as
    the C side reads it and the pre-pass's qs buffer (the one it wrote, not
    null); q, k, v and dO reach the backward zero-padded to the padded head
    dim; one launch each under the "_wide" keys."""
    calls, seen = [], {}

    def record(entry, device, *args):
        calls.append((entry, args))

    orig = tfa._launch_bwd

    def launch_bwd(q, k, v, o, lse, do, *rest):
        seen.update(q=q, k=k, v=v, do=do)
        return orig(q, k, v, o, lse, do, *rest)

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(tfa, "_launch_bwd", launch_bwd)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 4, 130, d, generator=gen).to(dtype).requires_grad_()
    k, v = (torch.randn(1, 2, 130, d, generator=gen).to(dtype).requires_grad_() for _ in range(2))
    do = torch.randn(1, 4, 130, d, generator=gen).to(dtype)
    out = tfa.flash_attention(q, k, v)
    before = dict(tfa.KERNEL_LAUNCHES)
    calls.clear()
    out.backward(do)
    dp = tfa.padded_head_dim(d)
    (prep, prep_args), (dkv, dkv_args), (dq, dq_args) = calls
    assert (prep, dkv, dq) == ("fa_flash_bwd_prep", "fa_flash_bwd_dkv", "fa_flash_bwd_dq")
    qs = prep_args[_QS_ARG[prep]]
    assert qs is not None and qs != 0 and prep_args[_HEAD_DIM_ARG[prep]] == dp
    for entry, args in ((dkv, dkv_args), (dq, dq_args)):
        assert args[_HEAD_DIM_ARG[entry]] == dp
        assert args[_BWD_DTYPE_ARG[entry]] == tfa._DTYPE_CODES[dtype]
        assert args[_QS_ARG[entry]] == qs
    for name, src in (("q", q), ("k", k), ("v", v), ("do", do)):
        x = seen[name]
        assert x.shape[-1] == dp and x.dtype == dtype
        assert torch.equal(x[..., :d], src.detach())
        assert not x[..., d:].any()
    counts = {key: n - before[key] for key, n in tfa.KERNEL_LAUNCHES.items() if n != before[key]}
    assert counts == {"flash_bwd_prep_wide": 1, "flash_bwd_dkv_wide": 1, "flash_bwd_dq_wide": 1}


@pytest.mark.parametrize("d", [160, 256, 288, 520, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
def test_wide_fp32_backward_counts_under_its_own_keys(dtype, d, monkeypatch):
    """flash_attention's backward above head dim 128 on the CUDA route, the
    C entry points stood in for by a recorder: fp32 counts one launch each
    of K2 and K3 under "flash_bwd_dkv_d256_fp32" / "flash_bwd_dq_d256_fp32"
    at padded head dim 256 and "flash_bwd_dkv_wide_fp32" /
    "flash_bwd_dq_wide_fp32" at 512 and 1024 (the 3xTF32 kernels of
    flash_bwd_fp32_wide.cuh), the pre-pass under its "_d256" / "_wide" key,
    and nothing under any other key; bf16 / fp16 count under "_d256" /
    "_wide" and never under an "_fp32" key.  K2 and K3 go through
    fa_flash_bwd_dkv and fa_flash_bwd_dq with the padded head dim, the
    dtype's code, and qs null for fp32 (the pre-pass's qs for bf16 /
    fp16)."""
    calls = []

    def record(entry, device, *args):
        if entry in _BWD_DTYPE_ARG:
            calls.append((entry, args[_HEAD_DIM_ARG[entry]], args[_BWD_DTYPE_ARG[entry]], args[_QS_ARG[entry]]))

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    q = torch.zeros(1, 4, 130, d, dtype=dtype, requires_grad=True)
    k, v = (torch.zeros(1, 2, 130, d, dtype=dtype, requires_grad=True) for _ in range(2))
    out = tfa.flash_attention(q, k, v)
    before = dict(tfa.KERNEL_LAUNCHES)
    out.backward(torch.zeros_like(out))
    dp = tfa.padded_head_dim(d)
    tier = "_d256" if dp == 256 else "_wide"
    fp32 = dtype == torch.float32
    want = {f"flash_bwd_prep{tier}": 1, f"flash_bwd_dkv{tier}{'_fp32' if fp32 else ''}": 1,
            f"flash_bwd_dq{tier}{'_fp32' if fp32 else ''}": 1}
    counts = {k_: n_ - before[k_] for k_, n_ in tfa.KERNEL_LAUNCHES.items() if n_ != before[k_]}
    assert counts == want
    code, qs = tfa._DTYPE_CODES[dtype], None if fp32 else 0
    assert calls == [("fa_flash_bwd_dkv", dp, code, qs), ("fa_flash_bwd_dq", dp, code, qs)]


@pytest.mark.parametrize("head_dim", [256, 512, 1024])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_fp32_wide_backward_kernels_fit_in_shared_memory(kernel, head_dim):
    """K2 and K3 for fp32 above 128 (csrc/flash_bwd_fp32_wide.cuh) fit an
    H100 block's 227 KB, counted as bwd32::Cfg lays them out
    (`fp32_wide_backward_smem_bytes`): two pinned operands of 64 KB (the
    block's pinned rows by its columns: D, or D / 2 at 1024, where the two
    blocks of a cluster split the columns), the ring slots of the two
    streamed operands, the eight warps' partial S and dP (double-buffered
    where they fit, always in a cluster), the streamed rows' statistics, the
    barriers and the alignment slack; one more slot of each streamed operand
    would not fit.  Their tiles are the plain loop's fp32 backward tiles."""
    stream, stages, double, ctas = tbs.KERNEL_FP32_WIDE_BWD[kernel][head_dim]
    pinned, streamed = tbs.fp32_wide_backward_tile(head_dim, kernel)
    cols = head_dim // ctas
    assert streamed == stream and pinned * cols == 128 * 128 and ctas in (1, 2) and (ctas == 1 or double)
    used = tbs.fp32_wide_backward_smem_bytes(head_dim, kernel)
    slots = 2 * stream * cols * 4
    parts = (2 if double else 1) * 8 * 2 * 16 * stream * 4
    assert 2 * pinned * cols * 4 + stages * slots + parts <= used <= tbs.SMEM_PER_BLOCK
    assert used + slots > tbs.SMEM_PER_BLOCK
    blocks = tbs.default_blocks(1024, 1024, head_dim, dtype=torch.float32)
    assert (blocks.bwd_dkv() if kernel == "dkv" else blocks.bwd_dq()[::-1]) == (streamed, pinned)


@pytest.mark.parametrize("head_dim", [512, 1024])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_wide_backward_kernels_fit_in_shared_memory(kernel, head_dim):
    """K2 and K3 for bf16/fp16 at 512 and 1024 (csrc/flash_bwd_wide.cuh)
    fit an H100 block's 227 KB, counted as wide::DkvCfg / DqCfg lay them
    out: the pinned rows of two operands (K2 16384 / D rows, 64 KB at both
    head dims; K3 32 rows, 64 / 128 KB), ring slots of four 64 x 64 boxes
    (four; two for K3 at 1024), the fp32 dP exchange, the swizzled T tiles
    the kernel writes, the pinned rows' statistics, the barriers and the
    alignment slack; one more slot would not fit."""
    pinned, stream = tbs.backward_tiles(head_dim, kernel)
    stages = tbs.backward_stages(head_dim, kernel)
    want_pinned = 16384 // head_dim if kernel == "dkv" else 32
    assert (pinned, stream, stages) == (want_pinned, 64, 2 if (kernel, head_dim) == ("dq", 1024) else 4)
    used = tbs.backward_smem_bytes(head_dim, kernel)
    slot = 4 * 64 * 64 * 2
    assert 2 * pinned * head_dim * 2 + stages * slot + 64 * pinned * 4 <= used <= tbs.SMEM_PER_BLOCK
    assert used == {("dkv", 512): 214_216, ("dq", 512): 210_376, ("dkv", 1024): 205_960,
                    ("dq", 1024): 210_344}[kernel, head_dim]
    assert used + slot > tbs.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [288, 520])
def test_plain_backward_at_the_wide_tiles_matches_jax(d, dtype):
    """The plain backward at the tiles of the kernels that run head dims 288
    and 520 (padded to 512 and 1024): for bf16 the wide wgmma K2 / K3's
    (dK/dV 64 query rows against 32 / 16 pinned KV rows, dQ 32 pinned query
    rows against 64 KV rows), for fp32 the 3xTF32 K2 / K3's (dK/dV 16 query
    rows against 32 pinned KV rows, dQ 32 pinned query rows against 16 KV
    rows); on fp32 inputs zero-padded to the padded head dim, at L130
    (ragged ends) with a
    GQA group of 2 whose tiles cross the causal diagonal and an lse
    cotangent: the q, k and v grads against jax.grad of the JAX package's
    flash_attention_with_lse at d itself, fp32, 1e-4."""
    q, k, v, do = _inputs(1, 4, 2, 130, 130, d=d, seed=71)
    dlse = randn(75, 1, 4, 130)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dp = tfa.padded_head_dim(d)
    blocks = tbs.default_blocks(130, 130, dp, 2, dtype=getattr(torch, dtype))
    if dtype == "bfloat16":
        assert blocks.bwd_dkv() == (64, 16384 // dp) and blocks.bwd_dq() == (32, 64)
    else:
        assert blocks.bwd_dkv() == (16, 32) and blocks.bwd_dq() == (32, 16)
        assert blocks.bwd_dkv() == tbs.fp32_wide_backward_tile(dp, "dkv")[::-1]
        assert blocks.bwd_dq() == tbs.fp32_wide_backward_tile(dp, "dq")
    qp, kp, vp, dop = (tfa._pad_head_dim(t(x), dp) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_reference(qp, kp, vp, sm_scale=d ** -0.5, block_sizes=blocks)
    grads = tfa.flash_attention_bwd_reference(qp, kp, vp, o, lse, dop, dlse=t(dlse), sm_scale=d ** -0.5,
                                              block_sizes=blocks)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert not g[..., d:].any()
        np.testing.assert_allclose(n(g[..., :d]), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize(
    "case", ["gqa-q129-kv257", "window-100", "segments", "no-key-rows", "non-causal", "lse-cotangent"]
)
@pytest.mark.parametrize("d", [160, 256, 288, 520])
def test_plain_backward_at_the_fp32_wide_tiles_matches_jax(d, case):
    """The plain backward at the 3xTF32 K2 / K3's tiles above head dim 128
    (`fp32_wide_backward_tile`: dK/dV 16 query rows against 64 / 32 pinned
    KV rows, dQ 64 / 32 pinned query rows against 32 / 16 KV rows at padded
    head dims 256 / 512 and 1024), on fp32 inputs zero-padded as the entry
    points pad them, against jax.grad of the JAX package's fp32
    flash_attention (flash_attention_with_lse for the lse cotangent) in
    interpret mode at d itself: q, k and v grads at 1e-4.  Cases: ragged
    q129 x kv257 with a GQA group of 4 whose tiles cross the causal
    diagonal; a window of 100 over them; 3 segments; rows that see no key
    (causal q200 x kv120: the first 80, whose dO is 0, as JAX's kernel
    spreads them over every key, and whose dq is exactly 0); non-causal; an
    lse cotangent."""
    lq, lk = {"no-key-rows": (200, 120)}.get(case, (129, 257))
    q, k, v, do = _inputs(1, 8, 2, lq, lk, d=d, seed=83)
    keyed = 80 if case == "no-key-rows" else 0
    do[:, :, :keyed] = 0
    causal = case != "non-causal"
    kw_j, kw_t = {}, {}
    if case == "window-100":
        kw_j = kw_t = dict(window=100)
    elif case == "segments":
        q_ids = np.repeat(np.arange(3, dtype=np.int32), [40, 50, 39])[None]
        kv_ids = np.repeat(np.arange(3, dtype=np.int32), [100, 100, 57])[None]
        kw_j = dict(segment_ids=(jnp.asarray(q_ids), jnp.asarray(kv_ids)))
        kw_t = dict(segment_ids=(t(q_ids), t(kv_ids)))
    dlse = randn(85, 1, 8, lq) if case == "lse-cotangent" else None

    def loss(q, k, v):
        if dlse is None:
            return jnp.sum(jfa.flash_attention(q, k, v, causal=causal, **kw_j) * do)
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dp = tfa.padded_head_dim(d)
    blocks = tbs.default_blocks(lq, lk, dp, 4, dtype=torch.float32)
    assert blocks.bwd_dkv() == tbs.fp32_wide_backward_tile(dp, "dkv")[::-1]
    assert blocks.bwd_dq() == tbs.fp32_wide_backward_tile(dp, "dq")
    qp, kp, vp, dop = (tfa._pad_head_dim(t(x), dp) for x in (q, k, v, do))
    kw = dict(causal=causal, sm_scale=d ** -0.5, block_sizes=blocks, **kw_t)
    o, lse = tfa.flash_attention_reference(qp, kp, vp, **kw)
    grads = tfa.flash_attention_bwd_reference(qp, kp, vp, o, lse, dop, dlse=None if dlse is None else t(dlse), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert not g[..., d:].any()
        np.testing.assert_allclose(n(g[..., :d]), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)
    assert not grads[0][:, :, :keyed].any()


# Where fa_flash_fwd_kv_quant takes q's dtype code and the payload's
# (0 = float32, 1 = bfloat16, 2 = float16; 1 = int8, 2 = float8_e4m3fn).
_K4_DTYPE_ARGS = (8, 9)
# Where fa_flash_fwd takes q's dtype code and block_q.
_K1_DTYPE_ARG, _K1_BLOCK_Q_ARG = 7, 29


@pytest.mark.parametrize("qdt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_wide_k4_reaches_the_wgmma_entry_with_the_c_arguments(dtype, qdt, monkeypatch):
    """K4 over int8 and fp8 at head dim 520 on the CUDA route, the C entry
    points stood in for by a recorder: it reaches fa_flash_fwd_kv_quant (the
    wide wgmma kernel) with head dim 1024, q's and the payload's dtype codes
    as the C side reads them, and the payloads zero-padded to 1024 bytes a
    row; K1 at the same head dim reaches fa_flash_fwd with block_q 0, the
    one tile the wide kernels take."""
    calls = []

    def record(entry, device, *args):
        calls.append((entry, args))

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    monkeypatch.setattr(tkv, "_call", record)
    q = torch.zeros(1, 4, 130, 520, dtype=dtype)
    k, v = (torch.randn(1, 2, 130, 520, generator=torch.Generator().manual_seed(i)) for i in range(2))
    kv = tkv.quantize_kv(k, v, dtype=getattr(torch, qdt))
    seen = {}
    orig = tkv._launch

    def launch(q_, kv_, *rest):
        seen["k"], seen["v"] = kv_.k, kv_.v
        return orig(q_, kv_, *rest)

    monkeypatch.setattr(tkv, "_launch", launch)
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tkv.flash_attention_kv_quant(q, kv)
    tfa.flash_attention(q, k.to(dtype), v.to(dtype))
    assert out.shape == q.shape
    (k4, k4_args), (k1, k1_args) = calls
    assert k4 == "fa_flash_fwd_kv_quant" and k4_args[_HEAD_DIM_ARG[k4]] == 1024
    assert [k4_args[i] for i in _K4_DTYPE_ARGS] == [tfa._DTYPE_CODES[dtype], tkv.QUANT_DTYPES[kv.k.dtype]]
    assert k1 == "fa_flash_fwd" and k1_args[_HEAD_DIM_ARG[k1]] == 1024
    assert k1_args[_K1_DTYPE_ARG] == tfa._DTYPE_CODES[dtype] and k1_args[_K1_BLOCK_Q_ARG] == 0
    for x, src in ((seen["k"], kv.k), (seen["v"], kv.v)):
        assert x.shape[-1] == 1024 and x.dtype == src.dtype
        assert torch.equal(x.view(torch.uint8)[..., :520], src.view(torch.uint8))
        assert not x.view(torch.uint8)[..., 520:].any()
    counts = {key: n - before[key] for key, n in tfa.KERNEL_LAUNCHES.items() if n != before[key]}
    assert counts == {"flash_fwd_kv_quant_wide": 1, "flash_fwd_wide": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("d", [160, 256])
def test_d256_backward_launches_k3_on_its_kernel(d, dtype, monkeypatch):
    """flash_attention's backward at head dims 160 and 256 (both run at 256)
    on the CUDA route, the C entry points stood in for by a recorder
    (`_call`): bf16 and fp16 hand K3 to fa_flash_bwd_dq (the wgmma kernel)
    with the pre-pass's qs buffer (the same one the pre-pass wrote) and
    count one flash_bwd_dq_d256 launch; fp32 hands it to the same entry
    point (the 3xTF32 kernel) with no qs and counts flash_bwd_dq_d256_fp32."""
    calls = []

    def record(entry, device, *args):
        calls.append((entry, args[_HEAD_DIM_ARG[entry]], args[_QS_ARG[entry]] if entry in _QS_ARG else None))

    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", record)
    q = torch.zeros(1, 4, 130, d, dtype=dtype, requires_grad=True)
    k, v = (torch.zeros(1, 2, 130, d, dtype=dtype, requires_grad=True) for _ in range(2))
    out = tfa.flash_attention(q, k, v)
    before = dict(tfa.KERNEL_LAUNCHES)
    out.backward(torch.zeros_like(out))
    prep, _, dq = calls[1:]
    fp32 = dtype == torch.float32
    assert dq[:2] == ("fa_flash_bwd_dq", 256)
    assert prep[0] == "fa_flash_bwd_prep" and dq[2] == prep[2]
    assert (dq[2] is None) == fp32 and dq[2] != 0
    counts = {key: n - before[key] for key, n in tfa.KERNEL_LAUNCHES.items() if n != before[key]}
    key = "flash_bwd_dq_d256_fp32" if fp32 else "flash_bwd_dq_d256"
    assert counts == {"flash_bwd_prep_d256": 1, key: 1, key.replace("_dq_", "_dkv_"): 1}
