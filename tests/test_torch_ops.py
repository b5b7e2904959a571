"""Op/API layer: the packed-QKV op and the SDPA drop-in, each against its
counterpart in the JAX package's tests/test_ops.py on the same numpy
inputs, and the SDPA router's fall-through and patch mechanics."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flash_attention_tpu as jfat
import flash_attention_tpu_torch as tfat
from _torch_port import n, randn, t
from flash_attention_tpu_torch.ops import sdpa as tsdpa

tfa = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")


def _packed(seed, groups=2, seq=256, d=32):
    qkv = randn(seed, 3, groups, seq, d)
    qkv[0] *= d ** -0.5  # the caller scales Q (reference parity)
    return qkv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_packed_matches_jax(dtype):
    """The reference tolerances of test_qkv_packed_parity: atol 1e-5 at
    fp32 (both are flash kernels), the bf16 tier 1e-2."""
    qkv = _packed(0)
    want = jfat.flash_attention_qkv_packed(jnp.asarray(qkv, getattr(jnp, dtype)), 4, 2)
    got = tfat.flash_attention_qkv_packed(t(qkv).to(getattr(torch, dtype)), 4, 2)
    assert got.shape == (2, 256, 32) and got.dtype == getattr(torch, dtype)
    atol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32), atol=atol, rtol=0)


def test_qkv_packed_validation():
    """The same error conditions as the JAX op."""
    with pytest.raises(ValueError, match="4 dimensions"):
        tfat.flash_attention_qkv_packed(torch.zeros(3, 256, 64))
    with pytest.raises(ValueError, match="must be 3"):
        tfat.flash_attention_qkv_packed(torch.zeros(2, 4, 256, 64))
    with pytest.raises(ValueError, match="num_chunks_q"):
        tfat.flash_attention_qkv_packed(torch.zeros(3, 4, 256, 64), 3, 1)
    with pytest.raises(ValueError, match="num_chunks_kv"):
        tfat.flash_attention_qkv_packed(torch.zeros(3, 4, 256, 64), 1, 3)


def test_qkv_packed_grad_matches_jax():
    """Gradient of sum(out * g) through the packed op (test_qkv_packed_grad)."""
    qkv = _packed(1)
    g = randn(2, 2, 256, 32)
    want = jax.grad(lambda x: jnp.sum(jfat.flash_attention_qkv_packed(x, 4, 4) * g))(jnp.asarray(qkv))
    x = t(qkv).requires_grad_()
    (tfat.flash_attention_qkv_packed(x, 4, 4) * t(g)).sum().backward()
    np.testing.assert_allclose(n(x.grad), np.asarray(want), atol=1e-4, rtol=0)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the router's calls into flash_attention."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return tfa.flash_attention(*args, **kwargs)

    monkeypatch.setattr(tsdpa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("batch", [1, 2])
def test_sdpa_matches_jax(batch, flash_calls):
    """test_sdpa_parity: the drop-in against JAX's, which takes BTNH; the
    port keeps torch's [B, H, L, D]."""
    q, k, v = (randn(s, batch, 256, 4, 64) for s in (3, 4, 5))
    want = jfat.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True)
    got = tfat.dot_product_attention(*(t(x).transpose(1, 2) for x in (q, k, v)), is_causal=True)
    assert len(flash_calls) == 1
    np.testing.assert_allclose(n(got.transpose(1, 2)), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "lq,lk,kw",
    [(256, 256, dict(is_causal=True)), (128, 384, {}), (200, 200, dict(scale=0.3)),
     (256, 256, dict(is_causal=True, enable_gqa=True))],
    ids=["causal", "lq<lk-non-causal", "scale", "gqa"],
)
def test_sdpa_routes_to_flash_where_it_computes_the_same(lq, lk, kw, flash_calls):
    hkv = 2 if kw.get("enable_gqa") else 4
    q, k, v = t(randn(6, 2, 4, lq, 64)), t(randn(7, 2, hkv, lk, 64)), t(randn(8, 2, hkv, lk, 64))
    got = tfat.dot_product_attention(q, k, v, **kw)
    assert len(flash_calls) == 1
    np.testing.assert_allclose(n(got), n(F.scaled_dot_product_attention(q, k, v, **kw)), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["attn_mask", "dropout_p", "causal-lq!=lk", "3-D", "heads-without-gqa-flag"])
def test_sdpa_falls_through_to_torch(case, flash_calls):
    """What the kernels do not compute goes to torch's own function,
    unchanged: the same output, and no call into flash_attention."""
    q, k, v = t(randn(9, 2, 4, 128, 64)), t(randn(10, 2, 4, 256, 64)), t(randn(11, 2, 4, 256, 64))
    kw = {}
    if case == "attn_mask":
        kw = dict(attn_mask=torch.rand(128, 256, generator=torch.Generator().manual_seed(0)) > 0.3)
    elif case == "dropout_p":
        kw = dict(dropout_p=0.3)
    elif case == "causal-lq!=lk":
        kw = dict(is_causal=True)
    elif case == "3-D":
        q, k, v = q[0], k[0], v[0]
    else:
        k, v = k[:, :2], v[:, :2]
        with pytest.raises(RuntimeError):
            tfat.dot_product_attention(q, k, v)
        assert not flash_calls
        return
    torch.manual_seed(1)
    got = tfat.dot_product_attention(q, k, v, **kw)
    torch.manual_seed(1)
    want = F.scaled_dot_product_attention(q, k, v, **kw)
    assert not flash_calls
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "d,supported", [(16, True), (64, True), (96, True), (128, True), (160, True), (192, True), (256, True),
                    (288, True), (520, True), (1024, True), (1040, False)],
)
def test_sdpa_card_route_takes_head_dims_up_to_1024(d, supported, monkeypatch):
    """On the card route the router sends any head dim up to 1024 to the
    kernels (flash_attention pads it to 64, 128, 256, 512 or 1024), as the
    JAX router sends any head dim to its kernel; above 1024 it falls through
    to torch."""
    monkeypatch.setattr(tsdpa, "kernel_route", lambda *ts: "cuda")
    q = torch.zeros(1, 2, 256, d, dtype=torch.bfloat16)
    assert tsdpa._supported(q, q, q, None, 0.0, True, False, {}) is supported
    assert not tsdpa._supported(q.half().double(), q, q, None, 0.0, True, False, {})


def test_causal_with_lq_ne_lk_is_aligned_differently():
    """Why causal Lq != Lk falls through: torch aligns the causal mask to
    the top-left corner, the kernels (and the JAX router, which routes this
    case anyway) align the queries to the end of the keys."""
    q, k, v = t(randn(12, 1, 2, 128, 64)), t(randn(13, 1, 2, 256, 64)), t(randn(14, 1, 2, 256, 64))
    end_aligned = tfa.flash_attention(q, k, v, causal=True)
    top_left = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert (end_aligned - top_left).abs().max() > 0.1
    torch.testing.assert_close(tfat.dot_product_attention(q, k, v, is_causal=True), top_left, atol=0, rtol=0)


def test_patch_roundtrip(flash_calls):
    """install_patch replaces torch.nn.functional.scaled_dot_product_attention
    (keeping the original in __wrapped__), `import ...auto` installs it, and
    uninstall_patch restores it."""
    original = F.scaled_dot_product_attention
    assert getattr(original, "__wrapped__", None) is None
    try:
        importlib.import_module("flash_attention_tpu_torch.auto")
        tsdpa.install_patch()  # idempotent
        patched = F.scaled_dot_product_attention
        assert patched is not original and patched.__wrapped__ is original
        q = t(randn(15, 1, 2, 256, 64))
        out = torch.nn.functional.scaled_dot_product_attention(q, q, q, is_causal=True)
        assert len(flash_calls) == 1
        torch.testing.assert_close(out, original(q, q, q, is_causal=True), atol=2e-5, rtol=1e-5)
        masked = torch.nn.functional.scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(256, 256).bool())
        assert len(flash_calls) == 1
        torch.testing.assert_close(masked, original(q, q, q, attn_mask=torch.ones(256, 256).bool()))
    finally:
        tsdpa.uninstall_patch()
    assert F.scaled_dot_product_attention is original


def test_version_and_exports():
    assert tfat.__version__
    for name in ("flash_attention_qkv_packed", "dot_product_attention", "flash_attention", "BlockSizes"):
        assert hasattr(tfat, name)
    for sub in ("training", "ops", "data"):
        assert getattr(tfat, sub).__name__ == f"flash_attention_tpu_torch.{sub}"
