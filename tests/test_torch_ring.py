"""Ring and head-parallel attention of the port (`parallel/`) on 4 gloo CPU
ranks, against the JAX package on the same numpy inputs.

The ranks are spawned once for the file (`_torch_ranks.spawn`): every rank
runs every case of `_torch_parallel_cases._ring`, and each test checks one
case.  Where the JAX package's test of the same name runs in its fast lane,
the port is held against the JAX function itself on virtual devices (ring
attention over a 4-device seq mesh, head-parallel attention over 8);
where the JAX test is marked slow, against the JAX function its own slow
test compares with (dense `vanilla_attention`, autograd through it).
Tolerances are the JAX tests' (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import spawn
from flash_attention_tpu.kernels import vanilla_attention
from flash_attention_tpu.parallel import head_parallel_attention, make_mesh, ring_attention


def _randn(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkvg(seed: int, b: int, hq: int, hkv: int, l: int, d: int) -> dict:
    return {"q": _randn(seed, b, hq, l, d), "k": _randn(seed + 1, b, hkv, l, d),
            "v": _randn(seed + 2, b, hkv, l, d), "g": _randn(seed + 3, b, hq, l, d)}


INPUTS = {
    "suite": "ring",
    "ring": _qkvg(0, 1, 2, 2, 4 * 128, 64),
    "non_causal": _randn(10, 1, 2, 4 * 128, 64),
    "zigzag": _qkvg(20, 1, 2, 2, 8 * 128, 64),
    "gqa": _qkvg(30, 1, 4, 2, 4 * 128, 64),
    "head": {"q": _randn(40, 2, 8, 256, 64), "g": _randn(41, 2, 8, 256, 64)},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_parallel_cases", 4, tmp_path_factory.mktemp("ring_ranks"), INPUTS)


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]


def _dense(x: dict, causal: bool = True):
    """vanilla attention over k/v repeated to q's heads (JAX's GQA test)."""
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    group = q.shape[1] // k.shape[1]
    return vanilla_attention(q, jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1), causal=causal,
                             sm_scale=q.shape[-1] ** -0.5)


def _dense_grads(x: dict):
    g = jnp.asarray(x["g"])
    return jax.grad(lambda q, k, v: jnp.sum(_dense({"q": q, "k": k, "v": v}) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(x[n]) for n in "qkv"))


def _close_grads(got, want, atol=2e-4, rtol=1e-4):
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=f"d{name}")


def test_mesh_construction(out):
    """make_mesh's axes, the -1 axis and the JAX package's errors (JAX
    over 4 of its virtual devices, as the port has 4 ranks)."""
    shapes = out["mesh"]
    assert shapes[0] == (2, 2, 1) and shapes[1] == (2, 2, 1) and shapes[2] == (1, 1, 4)
    assert shapes[6] == ("data", "model", "seq")
    devs = jax.devices()[:4]
    assert dict(make_mesh(data=2, model=-1, devices=devs).shape) == {"data": 2, "model": 2, "seq": 1}
    for got, kw in zip(shapes[3:6], [dict(data=-1, model=-1), dict(data=3, model=-1), dict(data=8)]):
        with pytest.raises(ValueError) as e:
            make_mesh(devices=devs, **kw)
        assert got == f"ValueError: {e.value}"


def test_ring_attention_parity(out):
    """Ring attention over 4 seq shards == the JAX package's ring attention."""
    x = INPUTS["ring"]
    want = ring_attention(*(jnp.asarray(x[n]) for n in "qkv"), make_mesh(seq=4), causal=True)
    np.testing.assert_allclose(out["ring_parity"], np.asarray(want), atol=2e-5, rtol=1e-5)
    got, placed, local = out["ring_dtensor"]
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    assert placed and local == (1, 2, 128, 64)


def test_ring_attention_batch_axis_and_preordered(out):
    """batch_axis: rows over data, tokens over seq (a 2 x 2 mesh); a
    zig-zag input already in chunk order with preordered=True comes back
    in that order.  Both against the JAX package's ring on the same mesh
    shape."""
    x = INPUTS["ring"]
    q, k, v = (jnp.concatenate([jnp.asarray(x[n]), jnp.flip(jnp.asarray(x[n]), 2)]) for n in "qkv")
    want = ring_attention(q, k, v, make_mesh(data=2, seq=2), causal=True, batch_axis="data")
    got, got_pre = out["ring_batch_axis"]
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_pre, np.asarray(want), atol=2e-5, rtol=1e-5)


def test_ring_attention_non_causal(out):
    x = INPUTS["non_causal"]
    want = _dense({"q": x, "k": x, "v": x}, causal=False)
    np.testing.assert_allclose(out["ring_non_causal"], np.asarray(want), atol=2e-5, rtol=1e-5)


def test_head_parallel_attention_parity(out):
    """Head-sharded attention with gradients == the JAX package's
    head_parallel_attention over an 8-way model mesh."""
    q, g = jnp.asarray(INPUTS["head"]["q"]), jnp.asarray(INPUTS["head"]["g"])
    mesh = make_mesh(model=8)
    want = head_parallel_attention(q, q, q, mesh)
    dq = jax.grad(lambda q: jnp.sum(head_parallel_attention(q, q, q, mesh) * g))(q)
    got, got_dq = out["head_parallel"]
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got_dq, np.asarray(dq), atol=1e-4, rtol=1e-4)


def test_ring_attention_grad(out):
    """The explicit backward ring (merged o/lse into each shard's K2/K3, the
    dK/dV accumulators travelling with K/V) == autograd of dense attention."""
    _close_grads(out["ring_grad"], _dense_grads(INPUTS["ring"]))


def test_ring_attention_zigzag_parity(out):
    np.testing.assert_allclose(out["zigzag_parity"], np.asarray(_dense(INPUTS["zigzag"])), atol=2e-5, rtol=1e-5)
    assert out["zigzag_odd"] == "ValueError: zigzag needs L % (2*n) == 0 (L=20, n=4)"
    assert out["zigzag_non_causal"] == "ValueError: zigzag sharding only applies to causal"


def test_ring_attention_zigzag_grad(out):
    _close_grads(out["zigzag_grad"], _dense_grads(INPUTS["zigzag"]))


def test_ring_attention_gqa(out):
    """GQA rides through the ring: 4 q heads over 2 KV heads, whose dK/dV
    sum the group's rows on every shard."""
    np.testing.assert_allclose(out["gqa"], np.asarray(_dense(INPUTS["gqa"])), atol=2e-5)
    _close_grads(out["gqa_grad"], _dense_grads(INPUTS["gqa"]))


def test_cuda_tensors_over_a_gloo_group_raise(out):
    assert out["cuda_over_gloo"].startswith("ValueError: ring attention of CUDA tensors needs an NCCL process group")


def test_multihost_topology_and_agreement(ranks):
    """topology() has the JAX keys; assert_same_across_hosts passes on an
    agreed value and raises on one that differs by rank; a second
    initialize_multihost is a no-op."""
    for r, res in enumerate(ranks):
        assert res["topology"] == {"process_index": r, "process_count": 4, "global_devices": 4,
                                   "local_devices": 1, "platform": "cpu"}
        assert res["hosts_disagree"] == "ValueError: rank disagrees across hosts: psum 6 != " + str(4 * r)
        assert res["initialize_again"] == res["topology"]
