"""Dense attention: the port's vanilla_attention(_with_lse) against the JAX
package's, same numpy inputs, fp32, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, randn, t
from flash_attention_tpu.kernels import vanilla as jv
from flash_attention_tpu_torch.kernels import vanilla as tv

CASES = {
    "causal": dict(lq=48, lk=48, causal=True),
    "q_shorter_than_kv": dict(lq=16, lk=48, causal=True),
    "non_causal": dict(lq=24, lk=40, causal=False),
    "window": dict(lq=48, lk=48, causal=True, window=9),
    "segments": dict(lq=48, lk=48, causal=True, segments=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vanilla_matches_jax(name):
    c = CASES[name]
    b, h, d = 2, 3, 16
    q, k, v = (randn(s, b, h, l, d) for s, l in ((1, c["lq"]), (2, c["lk"]), (3, c["lk"])))
    segs = None
    if c.get("segments"):
        rng = np.random.default_rng(4)
        ids = np.sort(rng.integers(0, 3, (b, c["lq"])), axis=-1).astype(np.int32)
        segs = (ids, ids)
    kw = dict(causal=c["causal"], sm_scale=0.3, window=c.get("window"))
    jo, jl = jv.vanilla_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
        segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)),
    )
    to, tl = tv.vanilla_attention_with_lse(
        t(q), t(k), t(v), **kw, segment_ids=None if segs is None else tuple(map(t, segs)),
    )
    np.testing.assert_allclose(n(to), n(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tl), n(jl), atol=1e-5, rtol=0)
    out = tv.vanilla_attention(t(q), t(k), t(v), **kw, segment_ids=None if segs is None else tuple(map(t, segs)))
    assert torch.equal(out, to)


def test_mask_value_matches_jax():
    assert tv.DEFAULT_MASK_VALUE == jv.DEFAULT_MASK_VALUE


def test_vanilla_bf16_keeps_fp32_statistics():
    """bf16 inputs: output in bf16, lse in fp32, equal to the fp32 run on the
    same (bf16-representable) inputs to the bf16 tier."""
    q, k, v = (t(randn(s, 1, 2, 32, 16)).to(torch.bfloat16) for s in (5, 6, 7))
    o16, l16 = tv.vanilla_attention_with_lse(q, k, v, sm_scale=0.25)
    o32, l32 = tv.vanilla_attention_with_lse(q.float(), k.float(), v.float(), sm_scale=0.25)
    assert o16.dtype == torch.bfloat16 and l16.dtype == torch.float32
    np.testing.assert_allclose(n(l16), n(l32), atol=1e-5)
    np.testing.assert_allclose(n(o16.float()), n(o32), atol=2e-2)
