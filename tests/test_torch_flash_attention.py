"""Flash attention forward: the port's plain tile loop against the JAX
package's Pallas kernel (interpret mode), same numpy inputs, fp32, 1e-5 for
out and lse; the block-size functions against JAX's; the device routing.

The CUDA kernel itself runs only on the card (`python3 chip_smoke.py`
compares it there with `flash_attention_reference` and with vanilla)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import n, randn, t
from flash_attention_tpu.kernels import block_sizes as jbs
from flash_attention_tpu_torch import config
from flash_attention_tpu_torch.kernels import block_sizes as tbs
from flash_attention_tpu_torch.kernels.vanilla import vanilla_attention_with_lse

# The packages' kernels/__init__ re-export functions named like the modules.
jfa = importlib.import_module("flash_attention_tpu.kernels.flash_attention")
tfa = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")


def _qkv(lq, lk, hq=4, hkv=2, d=16, b=1, seed=0):
    return (
        randn(seed, b, hq, lq, d),
        randn(seed + 1, b, hkv, lk, d),
        randn(seed + 2, b, hkv, lk, d),
    )


# (lq, lk, causal): lengths at and above MIN_BLOCK, ragged, below MIN_BLOCK
# (the dense route on the CPU), queries shorter than KV, and non-causal.
SHAPES = [
    (128, 128, True),
    (200, 200, True),
    (384, 384, True),
    (40, 40, True),
    (128, 384, True),
    (200, 200, False),
]


@pytest.mark.parametrize("lq,lk,causal", SHAPES)
def test_flash_attention_matches_jax(lq, lk, causal):
    q, k, v = _qkv(lq, lk)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tfa.flash_attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lq,lk", [(128, 128), (200, 200), (40, 40), (128, 384)])
def test_flash_attention_with_lse_matches_jax(lq, lk):
    q, k, v = _qkv(lq, lk, seed=3)
    jo, jl = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tl = tfa.flash_attention_with_lse(t(q), t(k), t(v))
    np.testing.assert_allclose(n(to), n(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tl), n(jl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [16, 96, 160, 256, 288, 520])
def test_padded_head_dim_route_matches_jax(d):
    """The CUDA route's padding on the plain version: q/k/v zero-padded to
    D64 (d <= 64), D128 (d <= 128), D256, D512 or D1024, the plain loop
    there with the true sm_scale, the output sliced back.  Out and lse
    against JAX at d itself (which pads to a multiple of 8), fp32, 1e-5."""
    dp = tfa.padded_head_dim(d)
    assert dp == next(p for p in (64, 128, 256, 512, 1024) if d <= p)
    q, k, v = _qkv(200, 200, d=d, seed=21)
    jo, jl = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    padded = [tfa._pad_head_dim(t(x), dp) for x in (q, k, v)]
    assert all(x.shape[-1] == dp and not x[..., d:].any() for x in padded)
    to, tl = tfa.flash_attention_with_lse(*padded, sm_scale=d ** -0.5)
    assert not to[..., d:].any()  # zero v columns give zero output columns
    np.testing.assert_allclose(n(to[..., :d]), n(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tl), n(jl), atol=1e-5, rtol=0)
    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=70)
    tout = tfa.flash_attention(*padded, sm_scale=d ** -0.5, window=70)[..., :d]
    np.testing.assert_allclose(n(tout), n(jout), atol=1e-5, rtol=0)


def test_padded_head_dim_is_64_128_256_512_or_1024_up_to_1024():
    ds = (8, 16, 32, 64, 65, 96, 128, 129, 160, 192, 256, 257, 288, 512, 513, 520, 1024, 1040)
    assert [tfa.padded_head_dim(d) for d in ds] == [
        64, 64, 64, 64, 128, 128, 128, 256, 256, 256, 256, 512, 512, 512, 1024, 1024, 1024, 1040,
    ]


def test_window_and_segments_match_jax():
    """The plain version keeps the window and segment masks (the CUDA
    kernel does not take them yet)."""
    q, k, v = _qkv(200, 200, seed=6)
    ids = np.repeat(np.arange(4, dtype=np.int32), 50)[None]
    for kw_j, kw_t in (
        (dict(window=70), dict(window=70)),
        (dict(segment_ids=jnp.asarray(ids)), dict(segment_ids=t(ids))),
    ):
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
        got = tfa.flash_attention(t(q), t(k), t(v), **kw_t)
        np.testing.assert_allclose(n(got), n(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("block", [(64, 64), (128, 32), (32, 128)])
def test_reference_tiling_does_not_change_result(block):
    """Any tiling of the plain loop gives dense attention's out and lse."""
    q, k, v = _qkv(150, 150, hq=2, hkv=1, seed=9)
    bs = tbs.BlockSizes(block_q=block[0], block_kv=block[1])
    out, lse = tfa.flash_attention_reference(t(q), t(k), t(v), block_sizes=bs)
    kr, vr = (t(x).repeat_interleave(2, dim=1) for x in (k, v))
    vo, vl = vanilla_attention_with_lse(t(q), kr, vr, sm_scale=16 ** -0.5)
    np.testing.assert_allclose(n(out), n(vo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(lse), n(vl), atol=1e-5, rtol=0)


BLOCK_CASES = [
    ("MIN_BLOCK", lambda m: m.MIN_BLOCK),
    ("auto_num_chunks", lambda m: [m.auto_num_chunks(L, D) for L in (1, 64, 128, 1000, 4096, 65536) for D in (64, 128)]),
    ("blocks_from_chunks", lambda m: [
        m.blocks_from_chunks(lq, lk, cq, ck) for lq, lk, cq, ck in ((1024, 1024, 4, 2), (100, 5000, 1, 64), (65536, 65536, 64, 64))
    ]),
    ("resolve_bwd_blocks", lambda m: [
        m.resolve_bwd_blocks(m.BlockSizes(block_q=bq, block_kv=bk), lqp, lkp)
        for bq, bk, lqp, lkp in ((1024, 1024, 3072, 2048), (128, 640, 384, 1280), (512, 512, 512, 1536))
    ]),
    ("bwd_defaults", lambda m: [m.BlockSizes(1024, 256).bwd_dkv(), m.BlockSizes(1024, 256).bwd_dq(), m.BlockSizes()]),
]


@pytest.mark.parametrize("name,fn", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_block_sizes_match_jax(name, fn):
    def norm(x):
        if isinstance(x, list):
            return [norm(y) for y in x]
        if hasattr(x, "block_q"):
            return (x.block_q, x.block_kv, x.bwd_dkv(), x.bwd_dq())
        return x

    assert norm(fn(tbs)) == norm(fn(jbs))


def test_default_blocks_is_the_kernel_tile():
    """The plain loops' default tiles are the Hopper kernels': the forward
    192 x 64 at head dim 64 (three consumer warpgroups), 128 x 64 at 128
    (two) and for bf16/fp16 at 256 64 x 64 (K1, one) or 128 x 64 (K4,
    two), for any GQA group; the backward (two
    consumer warpgroups at 64 and 128) 64 query rows against 128 pinned KV
    rows for dK/dV, 128 pinned query rows against 64 KV rows for dQ; at 256
    dK/dV 32 query rows against 64 pinned KV rows and dQ 32 x 32.  fp32
    from 256 up: the 3xTF32 forward pins 64, 32 and 16 query rows against
    32, 32 and 16 KV rows; the 3xTF32 backward's dK/dV pins 64, 32 and 32
    KV rows against 16-row query tiles and its dQ 64, 32 and 32 query rows
    against 32, 16 and 16 KV rows (at 1024 two blocks of a cluster share
    the rows, each with half the columns); at 512 and 1024 the bf16/fp16
    forward (the wide wgmma kernel) takes 64 query rows against 32 and 16
    KV rows, and its backward (the wide wgmma K2 / K3) pins rows against
    64-row tiles: dK/dV 64 query rows against 32 / 16 KV rows, dQ 32 query
    rows against 64 KV rows."""
    assert tbs.KERNEL_BLOCK_KV == 64
    bwd = dict(block_q_dkv=64, block_kv_dkv=128, block_q_dq=128, block_kv_dq=64)
    assert tbs.default_blocks(1024, 1024, 64) == tbs.BlockSizes(192, 64, **bwd)
    assert tbs.default_blocks(40, 384, 128, group=4) == tbs.BlockSizes(128, 64, **bwd)
    assert tbs.default_blocks(1024, 1024, 64).bwd_dkv() == (64, 128)
    assert tbs.default_blocks(1024, 1024, 128).bwd_dq() == (128, 64)

    def tiles(d, dtype=None, quantized=False):
        x = tbs.default_blocks(1024, 1024, d, dtype=dtype, quantized=quantized)
        return x.block_q, x.block_kv, x.bwd_dkv(), x.bwd_dq()

    for dtype in (None, torch.bfloat16, torch.float16):
        assert tiles(256, dtype) == tiles(160, dtype) == (64, 64, (32, 64), (32, 32))
        assert tiles(256, dtype, quantized=True)[:2] == (128, 64)
    assert tiles(256, torch.float32) == tiles(129, torch.float32) == (64, 32, (16, 64), (64, 32))
    assert tiles(512, torch.float32) == tiles(288, torch.float32) == (32, 32, (16, 32), (32, 16))
    assert tiles(1024, torch.float32) == tiles(520, torch.float32) == (16, 16, (16, 32), (32, 16))
    for dtype in (None, torch.bfloat16, torch.float16):
        assert tiles(512, dtype) == tiles(288, dtype) == (64, 32, (64, 32), (32, 64))
        assert tiles(1024, dtype) == tiles(520, dtype) == (64, 16, (64, 16), (32, 64))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_loop_at_the_d256_tiles_matches_jax(dtype):
    """The plain forward and backward at the D256 kernels' tiles, 64 x 64
    forward and 32 x 64 dK/dV for bf16 (the wgmma kernels), 64 x 32 forward
    and 16 x 64 dK/dV for fp32 (the 3xTF32 kernels), on fp32 inputs at
    L130 (ragged ends, a GQA
    group of 2 whose tiles cross the causal diagonal): out, lse and the
    grads against the JAX package in interpret mode, fp32, forward 1e-5,
    backward 1e-4."""
    lq = lk = 130
    q, k, v = _qkv(lq, lk, d=256, seed=13)
    do = randn(16, 1, 4, lq, 256)
    blocks = tbs.default_blocks(lq, lk, 256, 2, dtype=getattr(torch, dtype))
    assert (blocks.block_q, blocks.block_kv) == ((64, 64) if dtype == "bfloat16" else (64, 32))
    assert blocks.bwd_dkv() == ((32, 64) if dtype == "bfloat16" else (16, 64))
    jo, jl = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tl = tfa.flash_attention_reference(t(q), t(k), t(v), block_sizes=blocks)
    np.testing.assert_allclose(n(to), n(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tl), n(jl), atol=1e-5, rtol=0)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = tfa.flash_attention_bwd_reference(t(q), t(k), t(v), to, tl, t(do), block_sizes=blocks)
    for name, g, w in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("lq,lk", [(300, 300), (200, 330)])
def test_plain_loop_at_the_kernel_tile_matches_jax(lq, lk):
    """The plain loop at the kernel's tile (ragged ends, a GQA group of 4
    whose 192-row tiles cross the causal diagonal) against the JAX
    package's kernel in interpret mode, fp32, 1e-5."""
    q, k, v = _qkv(lq, lk, hq=8, hkv=2, d=64, seed=11)
    jo, jl = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tl = tfa.flash_attention_reference(t(q), t(k), t(v), block_sizes=tbs.default_blocks(lq, lk, 64, 4))
    np.testing.assert_allclose(n(to), n(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(tl), n(jl), atol=1e-5, rtol=0)


def test_aligned_copies_only_what_the_kernels_cannot_read():
    """q/k/v sliced out of a fused [B, L, 3 H D] bf16 projection pass
    uncopied; a row stride that is not a multiple of 16 bytes, or a base
    2 bytes off, is copied."""
    b, length, h, d = 2, 40, 4, 64
    qkv = torch.zeros(b, length, 3 * h * d, dtype=torch.bfloat16)
    for i in range(3):
        view = qkv[..., i * h * d:(i + 1) * h * d].view(b, length, h, d).transpose(1, 2)
        assert tfa._aligned(view) is view
    odd_rows = torch.zeros(b, h, length, d + 1, dtype=torch.bfloat16)[..., :d]
    shifted = torch.zeros(b * h * length * d + 1, dtype=torch.bfloat16)[1:].view(b, h, length, d)
    for x in (odd_rows, shifted):
        y = tfa._aligned(x)
        assert y is not x and y.is_contiguous() and torch.equal(y, x) and y.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kv", ["same", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_forward_kernel_fits_in_shared_memory(dtype, kv, head_dim):
    """Every instantiation of the bf16/fp16 forward (q dtype, K/V payload,
    head dim) fits an H100 block's 227 KB; the 2-byte types share a layout.
    At 256 the ring keeps two slots and K4 one payload staging slot."""
    used = tbs.forward_smem_bytes(head_dim, quantized=kv != "same")
    assert used <= tbs.SMEM_PER_BLOCK == 232_448
    stages = tbs.kernel_stages(head_dim)
    assert stages == (2 if head_dim == 256 else 4)
    rows = tbs.kernel_block_q(head_dim, quantized=kv != "same")
    assert used >= (rows + 2 * stages * tbs.KERNEL_BLOCK_KV) * head_dim * 2


@pytest.mark.parametrize("kv", ["same", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("head_dim", [512, 1024])
def test_wide_forward_kernel_fits_in_shared_memory(kv, head_dim):
    """The bf16/fp16 forward at 512 and 1024 (csrc/flash_fwd_wide.cuh) fits
    an H100 block's 227 KB: the resident 64-row q tile, K slots and
    512-column V slots (K1: tiles of 32 KV rows in two K and two V slots at
    512, of 16 rows in two K slots and one V slot at 1024; K4 one of each,
    its 1-byte payloads staged in two / one slots) and the two warpgroups'
    S partials."""
    quantized = kv != "same"
    used = tbs.forward_smem_bytes(head_dim, quantized=quantized)
    assert used <= tbs.SMEM_PER_BLOCK
    bc, k_slots, v_slots, staging = tbs.KERNEL_WIDE_KV[head_dim]
    assert (bc, k_slots, v_slots, staging) == ((32, 2, 2, 2) if head_dim == 512 else (16, 2, 1, 1))
    assert tbs.kernel_stages(head_dim) == k_slots and tbs.kernel_block_q(head_dim, quantized) == 64
    k_tile, v_tile = bc * head_dim * 2, bc * 512 * 2
    slots = k_tile + v_tile + staging * (k_tile + v_tile) // 2 if quantized else k_slots * k_tile + v_slots * v_tile
    assert used >= 64 * head_dim * 2 + slots + 2 * 2 * 64 * bc * 4
    blocks = tbs.default_blocks(1024, 1024, head_dim, dtype=torch.bfloat16, quantized=quantized)
    assert (blocks.block_q, blocks.block_kv) == (64, bc)
    assert (blocks.block_kv_dkv, blocks.block_q_dkv) == (tbs.KERNEL_WIDE_DKV[head_dim][0], 64)


@pytest.mark.parametrize("kv", ["same", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("head_dim", [256, 512, 1024])
def test_fp32_wide_forward_kernel_fits_in_shared_memory(kv, head_dim):
    """The fp32 forward above 128 (csrc/flash_fwd_fp32_wide.cuh) fits an
    H100 block's 227 KB: q (64 KB; its lo copy where it is split once),
    the ring's K and V tiles (fp32, or K4's 1-byte payloads), the eight
    warps' partial S double-buffered; its tile is the plain loop's fp32
    forward tile, and the plain loop's dK/dV tile is the 3xTF32 backward's."""
    quantized = kv != "same"
    used = tbs.fp32_wide_forward_smem_bytes(head_dim, quantized)
    assert used <= tbs.SMEM_PER_BLOCK
    stream, pre = tbs.KERNEL_FP32_WIDE[head_dim]
    rows, bc = tbs.fp32_wide_forward_tile(head_dim)
    assert bc == stream and rows * head_dim == 128 * 128
    elem = 1 if quantized else 4
    q = rows * head_dim * 4 * (1 + pre)
    assert used >= q + 2 * stream * head_dim * elem + 2 * 8 * 16 * stream * 4
    blocks = tbs.default_blocks(1024, 1024, head_dim, dtype=torch.float32, quantized=quantized)
    assert (blocks.block_q, blocks.block_kv) == (rows, bc)
    assert blocks.bwd_dkv() == tbs.fp32_wide_backward_tile(head_dim, "dkv")[::-1]


@pytest.mark.parametrize(
    "case",
    ["gqa-q129-kv257", "window-100", "segments", "no-key-rows", "non-causal"],
)
@pytest.mark.parametrize("d", [160, 288, 520])
def test_plain_loop_at_the_fp32_wide_tiles_matches_jax(d, case):
    """The plain forward at the 3xTF32 forward's tiles above head dim 128
    (64 x 32, 32 x 32 and 16 x 16 at padded head dims 256, 512 and
    1024), on fp32 inputs zero-padded as the entry points pad
    them, against the JAX package's fp32 forward in interpret mode at d
    itself: out (and lse, where JAX's entry with lse takes the case) at
    1e-5.  Cases: ragged q129 x kv257 with a GQA group of 4 whose tiles
    cross the causal diagonal; a window of 100 over them; 3 segments; rows
    that see no key (causal q200 x kv120: the first 80, exactly 0 with lse
    -inf, where JAX's kernel spreads them over every key, so JAX is held
    on the other rows); non-causal."""
    lq, lk = {"no-key-rows": (200, 120)}.get(case, (129, 257))
    q, k, v = _qkv(lq, lk, hq=8, hkv=2, d=d, seed=29)
    causal = case != "non-causal"
    kw_j, kw_t = {}, {}
    if case == "window-100":
        kw_j = kw_t = dict(window=100)
    elif case == "segments":
        q_ids = np.repeat(np.arange(3, dtype=np.int32), [40, 50, 39])[None]
        kv_ids = np.repeat(np.arange(3, dtype=np.int32), [100, 100, 57])[None]
        kw_j = dict(segment_ids=(jnp.asarray(q_ids), jnp.asarray(kv_ids)))
        kw_t = dict(segment_ids=(t(q_ids), t(kv_ids)))
    dp = tfa.padded_head_dim(d)
    blocks = tbs.default_blocks(lq, lk, dp, 4, dtype=torch.float32)
    assert (blocks.block_q, blocks.block_kv) == tbs.fp32_wide_forward_tile(dp)
    qp, kp, vp = (tfa._pad_head_dim(t(x), dp) for x in (q, k, v))
    to, tl = tfa.flash_attention_reference(qp, kp, vp, causal=causal, sm_scale=d ** -0.5, block_sizes=blocks,
                                           **kw_t)
    assert not to[..., d:].any()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    keyed = 80 if case == "no-key-rows" else 0
    want = jfa.flash_attention(jq, jk, jv, causal=causal, **kw_j)
    np.testing.assert_allclose(n(to[:, :, keyed:, :d]), n(want)[:, :, keyed:], atol=1e-5, rtol=0)
    if not kw_j:
        _, jl = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal)
        np.testing.assert_allclose(n(tl[:, :, keyed:]), n(jl)[:, :, keyed:], atol=1e-5, rtol=0)
    assert not to[:, :, :keyed].any() and bool((tl[:, :, :keyed] == -np.inf).all())


def test_cpu_route_counts_no_kernel_launch():
    q, k, v = _qkv(128, 128)
    before = dict(tfa.KERNEL_LAUNCHES)
    tfa.flash_attention(t(q), t(k), t(v))
    tfa.flash_attention_with_lse(t(q), t(k), t(v))
    assert tfa.KERNEL_LAUNCHES == before


def test_routing_rejects_other_and_mixed_devices():
    cpu = torch.zeros(1, 1, 8, 16)
    meta = torch.zeros(1, 1, 8, 16, device="meta")
    assert config.kernel_route(cpu, cpu) == "plain"
    with pytest.raises(ValueError, match="unsupported or mixed"):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        tfa.flash_attention_with_lse(cpu, meta, meta)


def test_argument_errors_match_jax():
    q, k, v = (t(x) for x in _qkv(40, 40))
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="k and v shapes"):
        tfa.flash_attention(q, k, v[:, :, :20])
