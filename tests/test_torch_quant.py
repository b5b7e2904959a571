"""Quantized KV: `quantize_tokens`, `dequantize_kv` and the plain route of
`flash_attention_kv_quant` (K4's plain version) against the JAX package,
whose K4 runs in Pallas interpret mode here.  Inputs are numpy from a seed;
fp8 payloads cross between the packages as uint8 views."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, from_jax, n, randn, t
from flash_attention_tpu.quant import kv as jkv
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES
from flash_attention_tpu_torch.quant import kv as tkv

tfa = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")

DTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _tokens(seed: int) -> np.ndarray:
    """[2, 3, 40, 64] with all-zero rows, tiny rows and large rows, so every
    branch of the scale (amax == 0, subnormal fp8 payloads, clipping at
    +-127) is reached."""
    x = randn(seed, 2, 3, 40, 64) * 3.0
    x[0, 0, :4] = 0.0
    x[0, 1, 5] *= 1e-30
    x[1, 2, 7] *= 1e4
    return x


@pytest.mark.parametrize("name", DTYPES)
def test_quantize_tokens_bit_equal_to_jax(name):
    jdt, tdt = DTYPES[name]
    x = _tokens(0)
    jp, js = jkv.quantize_tokens(jnp.asarray(x), jdt)
    tp, ts = tkv.quantize_tokens(t(x), tdt)
    assert tp.dtype == tdt and ts.dtype == torch.float32 and tp.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(bits(tp), bits(jp))
    np.testing.assert_array_equal(n(ts), np.asarray(js))
    assert (n(ts)[0, 0, :4] == 1.0).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", DTYPES)
def test_quantize_kv_and_dequantize_match_jax(name, out_dtype):
    jdt, tdt = DTYPES[name]
    k, v = _tokens(1), _tokens(2)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jdt)
    tq = tkv.quantize_kv(t(k), t(v), dtype=tdt)
    for a, b in ((tq.k, jq.k), (tq.v, jq.v)):
        np.testing.assert_array_equal(bits(a), bits(b))
    np.testing.assert_array_equal(n(tq.v_scale), np.asarray(jq.v_scale))
    assert tq.kv_len == 40
    jdq = jkv.dequantize_kv(jq, jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16)
    tdq = tkv.dequantize_kv(tq, out_dtype)
    for a, b in zip(tdq, jdq):
        assert a.dtype == out_dtype
        np.testing.assert_array_equal(n(a.float()), np.asarray(b.astype(jnp.float32)))


def test_quantize_tokens_rejects_other_dtypes():
    with pytest.raises(ValueError, match="quantized payloads"):
        tkv.quantize_tokens(torch.zeros(2, 8), torch.float16)


def _segs(b: int, length: int) -> np.ndarray:
    """Three packed documents of unequal lengths per row."""
    ids = np.zeros((b, length), np.int32)
    ids[:, length // 5:] = 1
    ids[:, length // 2:] = 2
    return ids


# (b, hq, hkv, lq, lk, d, window, segments); the JAX tests' shapes, at the
# smaller head dim where it does not change what is exercised.
CASES = {
    "mha": (1, 2, 2, 256, 256, 64, None, False),
    "gqa": (1, 4, 2, 256, 256, 64, None, False),
    "window100": (1, 2, 2, 384, 384, 64, 100, False),
    "segments3": (1, 2, 2, 384, 384, 64, None, True),
    "lq<lk": (2, 4, 2, 128, 256, 64, None, False),
    "dense-fallback": (1, 2, 2, 8, 64, 64, None, False),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", DTYPES)
def test_kv_quant_attention_matches_jax(name, case):
    """fp32 at the JAX tests' tolerances: atol 5e-5 / rtol 1e-4, and 2e-5 /
    1e-5 where masks (window, segments) apply; both sides sum the same
    dequantized tiles in another order."""
    jdt, tdt = DTYPES[name]
    b, hq, hkv, lq, lk, d, window, segmented = CASES[case]
    q, k, v = randn(3, b, hq, lq, d), randn(4, b, hkv, lk, d), randn(5, b, hkv, lk, d)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jdt)
    tq = tkv.QuantizedKV(from_jax(jq.k), from_jax(jq.k_scale), from_jax(jq.v), from_jax(jq.v_scale))
    segs = _segs(b, lq) if segmented else None
    jout = jkv.flash_attention_kv_quant(
        jnp.asarray(q), jq, window=window, segment_ids=None if segs is None else jnp.asarray(segs)
    )
    before = dict(KERNEL_LAUNCHES)
    tout = tkv.flash_attention_kv_quant(t(q), tq, window=window, segment_ids=None if segs is None else t(segs))
    assert KERNEL_LAUNCHES == before  # the plain route launches nothing
    atol, rtol = (2e-5, 1e-5) if window or segmented else (5e-5, 1e-4)
    assert tout.shape == q.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(n(tout), np.asarray(jout), atol=atol, rtol=rtol)


def test_kv_quant_attention_bf16_matches_jax():
    """bf16 q: the K/V tiles are dequantized in bf16 on both sides (the
    same roundings); atol 2e-2, the bf16 tier, since P and the output are
    rounded to bf16 after sums taken in another order."""
    q, k, v = randn(6, 1, 4, 256, 64), randn(7, 1, 2, 256, 64), randn(8, 1, 2, 256, 64)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jnp.int8)
    tq = tkv.QuantizedKV(from_jax(jq.k), from_jax(jq.k_scale), from_jax(jq.v), from_jax(jq.v_scale))
    jout = jkv.flash_attention_kv_quant(jnp.asarray(q, jnp.bfloat16), jq)
    tout = tkv.flash_attention_kv_quant(t(q).to(torch.bfloat16), tq)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(n(tout.float()), np.asarray(jout.astype(jnp.float32)), atol=2e-2, rtol=0)


def test_kv_quant_reference_dequantizes_like_the_kernel():
    """K4 dequantizes each tile as payload.to(T) * scale.to(T), rounded to
    T: the plain version equals K1's plain version on K/V dequantized that
    way, bit for bit."""
    from flash_attention_tpu_torch.kernels.flash_attention import flash_attention_reference

    tq = tkv.quantize_kv(t(randn(9, 1, 2, 256, 64)), t(randn(10, 1, 2, 256, 64)), dtype=torch.float8_e4m3fn)
    q = t(randn(11, 1, 2, 256, 64)).to(torch.bfloat16)
    k = tq.k.to(torch.bfloat16) * tq.k_scale.to(torch.bfloat16)[..., None]
    v = tq.v.to(torch.bfloat16) * tq.v_scale.to(torch.bfloat16)[..., None]
    want, _ = flash_attention_reference(q, k, v)
    assert torch.equal(tkv.flash_attention_kv_quant_reference(q, tq), want)


def test_cuda_route_raises_without_a_card():
    """K4's launcher never falls back: CPU tensors, an unsupported head dim
    or a non-quantized payload raise."""
    tq = tkv.quantize_kv(t(randn(12, 1, 2, 256, 64)), t(randn(13, 1, 2, 256, 64)))
    q = t(randn(14, 1, 2, 256, 64))
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        tkv._launch(q, tq, True, 0.125, None, None)
    tq32 = tkv.quantize_kv(t(randn(12, 1, 2, 256, 32)), t(randn(13, 1, 2, 256, 32)))
    with pytest.raises(NotImplementedError, match="head dims"):
        tkv._launch(q[..., :32], tq32, True, 0.125, None, None)
    plain = tkv.QuantizedKV(tq.k.float(), tq.k_scale, tq.v.float(), tq.v_scale)
    with pytest.raises(TypeError, match="payloads"):
        tkv.flash_attention_kv_quant(q, plain)


@pytest.mark.parametrize("d", [16, 96, 160, 256, 288, 520])
@pytest.mark.parametrize("name", DTYPES)
def test_kv_quant_padded_head_dim_matches_jax(name, d):
    """K4's CUDA-route padding on its plain version: q zero-padded to D64,
    D128, D256, D512 or D1024, the int8/fp8 payloads padded with zero bytes (0 in both formats),
    the scales unchanged, the plain version there with the true sm_scale,
    the output sliced back; against JAX at d itself, fp32, atol 5e-5 /
    rtol 1e-4 (the JAX tests' quantized tier)."""
    jdt, _ = DTYPES[name]
    q, k, v = randn(21, 1, 4, 256, d), randn(22, 1, 2, 256, d), randn(23, 1, 2, 256, d)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jdt)
    jout = jkv.flash_attention_kv_quant(jnp.asarray(q), jq)
    dp = tfa.padded_head_dim(d)
    kp, vp = (tfa._pad_head_dim(from_jax(x), dp) for x in (jq.k, jq.v))
    assert kp.dtype == from_jax(jq.k).dtype and not bits(kp)[..., d:].any()
    np.testing.assert_array_equal(bits(kp)[..., :d], bits(jq.k))
    tq = tkv.QuantizedKV(kp, from_jax(jq.k_scale), vp, from_jax(jq.v_scale))
    tout = tkv.flash_attention_kv_quant(tfa._pad_head_dim(t(q), dp), tq, sm_scale=d ** -0.5)[..., :d]
    np.testing.assert_allclose(n(tout), np.asarray(jout), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("d", [16, 96, 160, 256, 288, 520])
def test_kv_quant_cuda_route_launches_padded_head_dims(d, monkeypatch):
    """On the CUDA route `flash_attention_kv_quant` hands K4's launcher q and
    payloads padded to D64, D128, D256, D512 or D1024 with the scales unchanged and sm_scale
    from the true d, and slices the output back.  The launcher is stood in
    for by a recorder that runs the plain version (no card needed); the
    result is held against JAX at d."""
    seen = []

    def launch(q, kv, causal, sm_scale, window, segs):
        seen.append((q.shape[-1], kv.k.shape[-1], kv.v.shape[-1], tuple(kv.k_scale.shape), sm_scale))
        return tkv.flash_attention_kv_quant_reference(q, kv, causal=causal, sm_scale=sm_scale, window=window,
                                                      segment_ids=segs)

    monkeypatch.setattr(tkv, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tkv, "_launch", launch)
    q, k, v = randn(24, 1, 4, 256, d), randn(25, 1, 2, 256, d), randn(26, 1, 2, 256, d)
    jq = jkv.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype=jnp.float8_e4m3fn)
    tq = tkv.QuantizedKV(from_jax(jq.k), from_jax(jq.k_scale), from_jax(jq.v), from_jax(jq.v_scale))
    out = tkv.flash_attention_kv_quant(t(q), tq, window=100)
    dp = next(p for p in (64, 128, 256, 512, 1024) if d <= p)
    assert seen == [(dp, dp, dp, (1, 2, 256), d ** -0.5)] and out.shape == q.shape
    jout = jkv.flash_attention_kv_quant(jnp.asarray(q), jq, window=100)
    np.testing.assert_allclose(n(out), np.asarray(jout), atol=2e-5, rtol=1e-5)
