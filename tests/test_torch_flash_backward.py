"""Flash attention backward: the port's autograd Functions, which take the
plain backward (`flash_attention_bwd_reference`) on CPU tensors, against
`jax.grad` of the JAX package's flash_attention (Pallas in interpret mode),
same numpy inputs and cotangents, fp32, 1e-4 (the source repo's backward
tier).

K2/K3 themselves run only on the card (`python3 chip_smoke.py` holds them
against this plain backward there)."""

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


# (id, (b, hq, hkv, lq, lk), torch kwargs, jax kwargs)
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
]


@pytest.mark.parametrize("shape,kw_t,kw_j", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_grads_match_jax(shape, kw_t, kw_j):
    b, hq, hkv, lq, lk = shape
    q, k, v, do = _inputs(b, hq, hkv, lq, lk)
    if kw_t == "segments":
        ids = _segment_ids(b, lq)
        kw_t, kw_j = dict(segment_ids=t(ids)), dict(segment_ids=jnp.asarray(ids))
    got = _torch_grads(q, k, v, do, **kw_t)
    want = _jax_grads(q, k, v, do, **kw_j)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


def test_lse_cotangent_matches_jax():
    """flash_attention_with_lse is differentiable in both outputs: the lse
    cotangent shifts di (JAX `_flash_lse_bwd_rule`)."""
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
