"""The narrow decode kernels: K5 and K6 at head dims 8, 16 and 32 for GQA
groups of up to 8 (`csrc/decode_narrow.cuh`, `fa_paged_decode_narrow` /
`fa_fused_decode_narrow`).  Their plan in plain PyTorch
(`paged_attention_narrow_ref`: chunks of 128 tokens, or whole pages, that a
cluster's blocks walk in turn; each block's 32-token tiles dealt to its 4
warps, each warp an online softmax; the warps' states merged in order, then
the blocks') against the JAX package's `paged_attention` (`_paged_kernel` in
Pallas interpret mode) and `decode_attention_fused` (`_fused_kernel`), for
every q dtype and payload, at the tiles' and the split's edges; then the
routing, the split, the rows the kernels can copy, and the C constants the
plan mirrors.  Inputs are numpy from a seed; fp8 payloads cross as uint8
views."""

import importlib
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_cases import NARROW_PAYLOADS, TOL, jax_cache, make_pages
from _torch_port import from_jax, n, randn, t, torch_cache
from flash_attention_tpu_torch.inference import kv_cache as tkvc
from flash_attention_tpu_torch.kernels.flash_attention import KERNEL_LAUNCHES

# the modules, not the functions that the packages re-export under their names
jda = importlib.import_module("flash_attention_tpu.inference.decode_attention")
jpa = importlib.import_module("flash_attention_tpu.inference.paged_attention")
tpa = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")

# (head dim, group, payload, K5's page size): every head dim at every q-row
# capacity the kernel has (groups 1, 2, 4, 8), the nine payloads (q in
# fp32, bf16 and fp16 over its own dtype, int8 and fp8) in turn, and pages
# of 16 (two a tile), 48 (a tile across pages; chunks of 144 tokens) and 64
# (two tiles a page) in turn
CASES = [(d, group, list(NARROW_PAYLOADS)[i % 9], (16, 48, 64)[i % 3])
         for i, (d, group) in enumerate(itertools.product((8, 16, 32), (1, 2, 4, 8)))]
CASE_IDS = [f"d{d}-g{g}-{p}-ps{ps}" for d, g, p, ps in CASES]
HKV = 2


def _tol(payload: str) -> tuple[float, float]:
    return TOL["fp32" if payload.startswith("fp32") else "fp16"]


def _plan(capacity: int, unit: int, paged: bool, pairs: int) -> tuple[int, int, int]:
    """The narrow plan on a card that holds every pair's cluster of 2 at
    once but not of 4: clusters of 2, chunks of NARROW_TOKENS in whole
    units."""
    resident = {1: 2 * pairs, 2: pairs, 4: pairs - 1, 8: 0}
    return tpa.decode_cluster_split(capacity, pairs, unit, resident, paged, tpa.NARROW_TOKENS)


def _edges(chunk: int, capacity: int) -> list[int]:
    """Tokens read (the current one included) on the plan's edges: one; a
    tile's - 1, its whole and + 1; a chunk's - 1 and + 1; a cluster's span
    of chunks + 1 (the second walk's first token); the whole capacity."""
    tile = tpa.NARROW_TILE
    return [1, tile - 1, tile, tile + 1, chunk - 1, chunk + 1, 2 * chunk + 1, capacity]


@pytest.mark.parametrize("d,group,payload,page_size", CASES, ids=CASE_IDS)
def test_k5_narrow_plan_matches_jax_paged_kernel(d, group, payload, page_size):
    """The narrow K5's plan in plain PyTorch (clusters of 2, each block
    walking 2 chunks: 128 tokens in pages of 16 and 64, 144 in pages of 48)
    against JAX's paged kernel (interpret mode) over a permuted page table,
    at the tiles' and the split's edges; the plain version (what a CPU
    tensor runs: no launch) agrees too."""
    chunk = -(-tpa.NARROW_TOKENS // page_size) * page_size
    pps = 4 * chunk // page_size
    capacity = pps * page_size
    lengths = np.array(_edges(chunk, capacity), np.int32)
    cluster, got_chunk, walks = _plan(capacity, page_size, True, len(lengths) * HKV)
    assert (cluster, got_chunk, walks) == (2, chunk, 2)
    q, pi, pages = make_pages(group * HKV, HKV, d, payload, batch=len(lengths), page_size=page_size, pps=pps, seed=d)
    jout = jpa.paged_attention(q, pages[0], pages[1], jnp.asarray(lengths), jnp.asarray(pi),
                               pages_per_compute_block=2, k_scales=pages[2], v_scales=pages[3])
    kp, vp, ks, vs = (None if a is None else from_jax(a) for a in pages)
    tq = from_jax(q)
    assert tpa.uses_narrow_kernel(tq.dtype, d, group)
    before = dict(KERNEL_LAUNCHES)
    got = tpa.paged_attention_narrow_ref(tq, kp, vp, t(lengths), t(pi), cluster=cluster, chunk=chunk, k_scales=ks,
                                         v_scales=vs)
    plain = tpa.paged_attention(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    assert KERNEL_LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == tq.shape and got.dtype == tq.dtype
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), atol=atol, rtol=rtol)


@pytest.mark.parametrize("d,group,payload,page_size", CASES, ids=CASE_IDS)
def test_k6_narrow_plan_matches_jax_fused(d, group, payload, page_size):
    """The narrow K6's plan (q pre-scaled and rounded to its dtype, lengths
    + 1; chunks of 128 tokens, clusters of 2, each block walking 2 chunks)
    over the slot-major cache's page view against JAX's
    `decode_attention_fused` (its kernel in interpret mode), at the tiles'
    and the split's edges.  Where the JAX kernel rounds P to another dtype
    than q's before its P V product beyond the tolerance (pv_dtype,
    decode_attention.py:361: fp8 over an fp8 cache; bf16 over an int8 one,
    outside fp32 q's tolerance), K6 is held against JAX's einsum
    `decode_attention`, the function both compute."""
    qdt, quant = NARROW_PAYLOADS[payload]
    capacity = 4 * tpa.NARROW_TOKENS
    lengths = _edges(tpa.NARROW_TOKENS, capacity)
    cluster, chunk, walks = _plan(capacity, tpa.NARROW_TOKENS, False, len(lengths) * HKV)
    assert (cluster, chunk, walks) == (2, tpa.NARROW_TOKENS, 2)
    jc = jax_cache(HKV, d, payload, lengths=tuple(x - 1 for x in lengths), max_len=capacity, seed=d + group)
    q = jnp.asarray(randn(40 + d, len(lengths), group * HKV, d), qdt)
    if quant == jnp.float8_e4m3fn or (quant is not None and qdt == jnp.float32):
        jout = jda.decode_attention(q, jc, 0)
    else:
        jout = jda.decode_attention_fused(q, jc, 0, block=64)
    tc = torch_cache(jc)
    kp, vp, ks, vs = tkvc.page_view(tc, 0, tc.max_len)
    pi = tkvc.identity_page_indices(tc.slots, tc.max_len, tc.max_len, device="cpu")
    got = tpa.paged_attention_narrow_ref(from_jax(q), kp, vp, tc.lengths + 1, pi, cluster=cluster, chunk=chunk,
                                         k_scales=ks, v_scales=vs, prescale_q=True)
    atol, rtol = _tol(payload)
    np.testing.assert_allclose(n(got.float()), np.asarray(jout, np.float32), atol=atol, rtol=rtol)


@pytest.mark.parametrize("cluster,chunk", [(1, 128), (2, 128), (8, 128), (2, 144), (4, 160)])
@pytest.mark.parametrize("payload", ["fp32", "fp32-int8"])
def test_narrow_plan_reads_nothing_past_the_lengths(cluster, chunk, payload):
    """NaN in every page row at or past a sequence's length (payload or
    scales) leaves the narrow plan's output finite and equal to the clean
    one, and within fp32's tolerance of the plain version's, whatever the
    cluster and the chunk (a multiple of the tile or not)."""
    lengths = np.array([1, 33, 150, 300, 511], np.int32)
    q, pi, pages = make_pages(8, HKV, 32, payload, batch=len(lengths), page_size=16, pps=32, seed=3)
    kp, vp, ks, vs = (None if a is None else from_jax(a).clone() for a in pages)
    tq = from_jax(q)
    kw = dict(cluster=cluster, chunk=chunk, k_scales=ks, v_scales=vs)
    clean = tpa.paged_attention_narrow_ref(tq, kp, vp, t(lengths), t(pi), **kw)
    dirty = [ks, vs] if ks is not None else [kp, vp]
    for b, length in enumerate(lengths):
        for j, page in enumerate(pi[b]):
            for x in dirty:
                x[:, page, max(0, int(length) - j * 16):] = float("nan")
    got = tpa.paged_attention_narrow_ref(tq, kp, vp, t(lengths), t(pi), **kw)
    assert torch.isfinite(got).all() and torch.equal(got, clean)
    plain = tpa.paged_attention_ref(tq, kp, vp, t(lengths), t(pi), k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(n(got), n(plain), atol=TOL["fp32"][0], rtol=TOL["fp32"][1])


@pytest.mark.parametrize(
    "q_dtype,d,group,want",
    [
        (torch.bfloat16, 32, 1, "narrow"),  # the d32 timing row: GPT-sized heads of 32
        (torch.bfloat16, 32, 4, "narrow"),  # d32_gqa4: GQA 16/4
        (torch.float32, 8, 8, "narrow"),  # the largest group the narrow kernel holds
        (torch.float16, 16, 2, "narrow"),
        (torch.float32, 16, 9, "group"),  # above 8: the whole-group kernels
        (torch.bfloat16, 32, 16, "group"),
        (torch.bfloat16, 64, 1, "tiles"),  # head dims 64-256: decode.cuh's group tiles
        (torch.float32, 256, 8, "tiles"),
        (torch.bfloat16, 64, 16, "group"),
        (torch.float16, 512, 4, "wide"),  # above 256: the wide kernels
    ],
)
def test_narrow_kernel_routing(q_dtype, d, group, want):
    """Which kernel a decode configuration runs: the narrow kernel at head
    dims 8-32 for groups of up to 8 (every q dtype), and no configuration
    two kernels."""
    kinds = {"narrow": tpa.uses_narrow_kernel(q_dtype, d, group), "group": tpa.uses_group_kernel(q_dtype, d, group),
             "wide": tpa.uses_wide_kernel(q_dtype, d, group)}
    assert [k for k, on in kinds.items() if on] == ([] if want == "tiles" else [want])


# What the card holds at once of the narrow kernel's clusters, by cluster
# size: an H100's cudaOccupancyMaxActiveClusters for K6 over an int8 layer
# at 4 q rows (5 blocks an SM; clusters of 4 and 8 within its GPCs)
RESIDENT = {1: 660, 2: 330, 4: 154, 8: 77}


@pytest.mark.parametrize(
    "capacity,pairs,unit,paged,want",
    [
        (1024, 512, 128, True, (1, 128, 8)),  # the d32 row (32 slots x 16 KV heads): one block a pair
        (1024, 512, 128, False, (1, 128, 8)),
        (1024, 128, 128, True, (4, 128, 2)),  # d32_gqa4 (32 slots x 4 KV heads): clusters of 4
        (1024, 128, 16, True, (4, 128, 2)),  # pages of 16: 8 a chunk
        (1024, 16, 48, True, (8, 144, 1)),  # pages of 48: chunks of 144 tokens
        (256, 16, 128, False, (2, 128, 1)),  # two chunks: clusters of 2
        (65536, 8, 128, False, (8, 128, 64)),  # a long capacity: 64 chunks a block
    ],
)
def test_narrow_split_choice(capacity, pairs, unit, paged, want):
    """The narrow kernel's split (`decode_cluster_split` at NARROW_TOKENS,
    as `cluster_plan` asks for it): the largest cluster of 1, 2, 4 or 8
    whose clusters all fit the card at once and leave each block a chunk;
    chunks of 128 tokens in whole units; the capacity covered."""
    cluster, chunk, walks = tpa.decode_cluster_split(capacity, pairs, unit, RESIDENT, paged, tpa.NARROW_TOKENS)
    assert (cluster, chunk, walks) == want
    assert chunk % unit == 0 and chunk >= tpa.NARROW_TOKENS
    assert cluster * chunk * walks >= capacity > cluster * chunk * (walks - 1)


@pytest.mark.parametrize(
    "dtype,d,offset,ok",
    [
        (torch.int8, 8, 8, True),  # 8-byte rows: 8-byte copies
        (torch.int8, 16, 8, False),  # 16-byte rows must start on 16 bytes
        (torch.int8, 16, 16, True),
        (torch.bfloat16, 8, 8, False),
        (torch.bfloat16, 8, 16, True),
        (torch.float32, 32, 4, False),
        (torch.float32, 32, 16, True),
    ],
)
def test_narrow_rows_must_fit_the_copies(dtype, d, offset, ok):
    """The kernels copy a row's d columns in 16-byte pieces (8-byte ones
    for the 8-byte rows of an 8-bit cache at d = 8): a cache view whose rows
    do not start on that many bytes raises before any launch, and is never
    copied."""
    flat = torch.zeros(64 * d, dtype=dtype)
    assert flat.data_ptr() % 64 == 0
    start = offset // flat.element_size()
    view = flat[start:start + 2 * 4 * d].view(2, 4, d)  # rows d apart, the first `offset` bytes in
    if ok:
        tpa._check_rows("k", view)
    else:
        with pytest.raises(ValueError, match="rows must be contiguous"):
            tpa._check_rows("k", view)


CSRC = Path(tpa.__file__).resolve().parents[1] / "csrc"


def test_narrow_plan_mirrors_the_kernel():
    """The plan's constants are the C side's, which no CPU run can ask: the
    tile (kNTile), the chunk (kNChunk, a tile for each of kNWarps warps),
    the largest group (kNMaxRows), the head dims decode.cu's
    narrow_head_dim takes and the q-row capacities narrow_launch_rows
    instantiates."""
    header = (CSRC / "decode_narrow.cuh").read_text()
    decode_cu = (CSRC / "decode.cu").read_text()

    def c_int(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", header).group(1))

    assert tpa.NARROW_TILE == c_int("kNTile")
    assert tpa.NARROW_TOKENS == c_int("kNThreads") // 32 * tpa.NARROW_TILE
    assert "constexpr int kNChunk = kNWarps * kNTile;" in header
    assert tpa.MAX_ROWS == c_int("kNMaxRows")
    body = re.search(r"bool narrow_head_dim\(int d\) \{(.*?)\}", decode_cu, re.S).group(1)
    assert set(tpa.NARROW_HEAD_DIMS) == {int(x) for x in re.findall(r"d == (\d+)", body)}
    rows = {int(x) for x in re.findall(r"narrow_launch_one<T, KV, (\d+), kPaged>", header)}
    assert rows == {1, 2, 4, 8} and set(tpa.CLUSTER_SIZES["narrow"]) == {1, 2, 4, 8}
