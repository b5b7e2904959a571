"""kernels.autotune on the CPU lane, held against the JAX package.

Ports `test_autotune_sweeps_and_caches`, `test_flash_attention_consults_
tuned_cache` and `test_autotuned_entry_reaches_default_path`
(tests/test_flash_attention.py) and `test_trainer_autotune_hook`
(tests/test_training_e2e.py); each output is held against the JAX
package's `flash_attention` on the same numpy inputs at 1e-5 (fp32).  On
the CPU the tuner times the plain version at each K1 tile; the CUDA route's
launches are checked with the C entry point stood in for by a recorder
(`_call`), as in test_torch_flash_backward.py."""

from __future__ import annotations

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TORCH_CFG, randn
from flash_attention_tpu.kernels import BlockSizes as JBlockSizes
from flash_attention_tpu.kernels import flash_attention as jflash
from flash_attention_tpu_torch.inference import InferenceEngine
from flash_attention_tpu_torch.kernels import BlockSizes, default_blocks
from flash_attention_tpu_torch.kernels.block_sizes import K1_TILES
from flash_attention_tpu_torch.models import gpt as tgpt
from flash_attention_tpu_torch.training import Trainer, TrainerConfig

# the package re-exports the functions under the modules' names
at = importlib.import_module("flash_attention_tpu_torch.kernels.autotune")
tfa = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
jat = importlib.import_module("flash_attention_tpu.kernels.autotune")


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A cache file of the test's own, empty before and after."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("FA_AUTOTUNE_CACHE", str(path))
    at.clear_cache()
    yield path
    at.clear_cache()


def _qkv(seed, b, h, hkv, length, d):
    return (randn(seed, b, h, length, d), randn(seed + 1, b, hkv, length, d), randn(seed + 2, b, hkv, length, d))


def _both(q, k, v):
    """The port's default flash_attention and the JAX package's on the same
    numpy inputs."""
    out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    return out.numpy(), np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v))))


def test_autotune_sweeps_and_caches(cache):
    """autotune measures the candidates (the plain version's tiles here),
    returns one of them, persists it, and tuned_blocks retrieves it without
    measuring; the winner's output matches JAX's flash_attention."""
    q, k, v = _qkv(40, 1, 2, 2, 256, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cands = at.candidate_blocks(256, 256, 64)
    assert [c.block_q for c in cands] == list(K1_TILES[64])
    assert all(dataclasses.replace(c, block_q=192) == default_blocks(256, 256, 64) for c in cands)
    best = at.autotune(tq, tk, tv, causal=True, depth=2, iters=1)
    assert best in cands
    entry = json.loads(cache.read_text())
    assert list(entry) == ["torch|cpu|b1h2q256k256d64|float32|causal=1|g1"]
    calls = []
    real = at.chain_timer
    at.chain_timer = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        again = at.autotune(tq, tk, tv, causal=True, depth=2, iters=1)
    finally:
        at.chain_timer = real
    assert again == best and calls == []  # a hit measures nothing
    hit = at.tuned_blocks(q.shape, k.shape[2], torch.float32, causal=True, device="cpu")
    assert hit == best
    out = tfa.flash_attention(tq, tk, tv, block_sizes=best).numpy()
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_flash_attention_consults_tuned_cache(monkeypatch):
    """The default tiling path looks the cache up once, with the GQA
    group's KV heads and the inputs' device; explicit block_sizes, chunk
    counts, a window or segment ids skip the lookup."""
    calls = []

    def spy(q_shape, kv_len, dtype, *, causal=True, num_kv_heads=None, device=None):
        calls.append((tuple(q_shape), kv_len, num_kv_heads, str(device)))
        return dataclasses.replace(default_blocks(256, 256, 64), block_q=64)  # a distinctive tile

    monkeypatch.setattr(at, "tuned_blocks", spy)
    q, k, v = _qkv(41, 1, 4, 2, 256, 64)
    out, ref = _both(q, k, v)
    assert calls == [((1, 4, 256, 64), 256, 2, "cpu")], calls
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    calls.clear()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv, block_sizes=BlockSizes(128, 128))
    tfa.flash_attention(tq, tk, tv, num_chunks_q=2, num_chunks_kv=2)
    tfa.flash_attention(tq, tk, tv, window=64)
    tfa.flash_attention(tq, tk, tv, segment_ids=torch.zeros(1, 256, dtype=torch.int32))
    assert calls == []


def test_autotuned_entry_reaches_default_path(cache, monkeypatch):
    """End to end: autotune writes an entry, and a later flash_attention
    with no tiling runs at it (the plain version's tile) and stays equal to
    JAX's output."""
    q, k, v = _qkv(42, 1, 2, 2, 256, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tile = dataclasses.replace(default_blocks(256, 256, 64), block_q=64)
    best = at.autotune(tq, tk, tv, causal=True, depth=2, iters=1, candidates=[tile])
    assert best == tile
    assert at.tuned_blocks(q.shape, 256, torch.float32, causal=True, num_kv_heads=2, device="cpu") == best
    seen = []
    real = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference", lambda *a, **kw: seen.append(kw["block_sizes"]) or real(*a, **kw))
    out, ref = _both(q, k, v)
    assert seen == [best]
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_tuned_blocks_probes_larger_groups_only(cache):
    """An entry tuned at GQA group 1 does not serve group 2 of the same
    shape; one tuned at group 4 serves group 2 (and its own)."""
    q, k, v = _qkv(43, 1, 4, 4, 128, 64)
    best = at.autotune(*(torch.from_numpy(x) for x in (q, k, v)), depth=1, iters=1)
    assert at.tuned_blocks((1, 4, 128, 64), 128, torch.float32, num_kv_heads=4, device="cpu") == best
    assert at.tuned_blocks((1, 4, 128, 64), 128, torch.float32, num_kv_heads=2, device="cpu") is None
    q, k, v = _qkv(43, 1, 4, 1, 128, 64)
    best = at.autotune(*(torch.from_numpy(x) for x in (q, k, v)), depth=1, iters=1, candidates=[
        dataclasses.replace(default_blocks(128, 128, 64), block_q=64)])
    for hkv in (1, 2):
        assert at.tuned_blocks((1, 4, 128, 64), 128, torch.float32, num_kv_heads=hkv, device="cpu").block_q == 64


def test_padded_head_dim_looks_up_the_callers_head_dim(cache, monkeypatch):
    """At head dim 96 the CUDA route pads to 128 and calls itself: the
    cache is looked up once, under 96, and the tuned tile reaches K1 (the C
    entry point stood in for by a recorder); the plain version at 96 on the
    CPU matches JAX."""
    q, k, v = _qkv(44, 1, 2, 2, 128, 96)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    best = at.autotune(tq, tk, tv, depth=1, iters=1)
    assert best.block_q in K1_TILES[128]
    assert list(json.loads(cache.read_text())) == ["torch|cpu|b1h2q128k128d96|float32|causal=1|g1"]
    out, ref = _both(q, k, v)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    lookups, launches = [], []
    real = at.tuned_blocks
    monkeypatch.setattr(at, "tuned_blocks", lambda *a, **kw: lookups.append(a[0][-1]) or real(*a, **kw))
    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", lambda entry, device, *args: launches.append((entry, args[13], args[-1])))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    monkeypatch.setattr(at, "_default_device", lambda: torch.device("cpu"))
    tfa.flash_attention(*(x.to(torch.bfloat16) for x in (tq, tk, tv)))
    assert lookups == [96] and launches == [("fa_flash_fwd", 128, K1_TILES[128][0])]  # no bf16 entry: default
    lookups.clear(), launches.clear()
    tfa.flash_attention(tq, tk, tv)
    assert lookups == [96] and launches == [("fa_flash_fwd", 128, 0)]  # fp32: K1's one tile


@pytest.mark.parametrize("d,bq", [(d, bq) for d, tiles in K1_TILES.items() for bq in tiles])
def test_k1_launches_each_tile(d, bq, monkeypatch):
    """block_q reaches fa_flash_fwd as its last argument for every K1_TILES
    entry; another block_q launches the default tile, fp32 0 (one tile),
    and K4 takes no tile argument of its own."""
    launches = []
    monkeypatch.setattr(tfa, "kernel_route", lambda *ts: "cuda")
    monkeypatch.setattr(tfa, "_call", lambda entry, device, *args: launches.append((entry, args[13], args[-1])))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    q = torch.zeros(1, 2, 130, d, dtype=torch.bfloat16)
    tile = dataclasses.replace(default_blocks(130, 130, d), block_q=bq)
    tfa.flash_attention(q, q, q, block_sizes=tile)
    tfa.flash_attention(q, q, q, block_sizes=dataclasses.replace(tile, block_q=256))
    tfa.flash_attention(q.float(), q.float(), q.float(), block_sizes=tile)
    assert launches == [("fa_flash_fwd", d, bq), ("fa_flash_fwd", d, K1_TILES[d][0]),
                        (tfa._route("flash_fwd", d, torch.float32)[1], d, 0)]
    assert tfa.k1_block_q(tile, 512, torch.bfloat16) == 0


def test_failing_candidate_raises(cache):
    """A candidate that fails raises, where JAX drops it: every candidate is
    a kernel built for it.  Nothing is cached."""
    q = torch.from_numpy(randn(45, 1, 2, 128, 64))
    with pytest.raises(ValueError):
        at.autotune(q, q, q, depth=1, iters=1, candidates=[default_blocks(128, 128, 64), BlockSizes(0, 64)])
    assert not cache.exists()
    assert at.tuned_blocks(q.shape, 128, torch.float32, device="cpu") is None


def test_jax_and_port_entries_share_a_file_and_never_cross(cache):
    """Both packages write one FA_AUTOTUNE_CACHE file, merging; each reads
    only its own keys (the port's start with "torch|")."""
    jat.clear_cache()
    try:
        q, k, v = _qkv(46, 1, 2, 2, 256, 64)
        jbest = jat.autotune(*(jnp.asarray(x) for x in (q, k, v)), depth=2, iters=1,
                             candidates=[JBlockSizes(128, 128)])
        assert at.tuned_blocks(q.shape, 256, torch.float32, device="cpu") is None  # JAX's entry is not the port's
        tbest = at.autotune(*(torch.from_numpy(x) for x in (q, k, v)), depth=1, iters=1)
        keys = set(json.loads(cache.read_text()))
        assert keys == {"cpu|b1h2q256k256d64|float32|causal=1|g1", "torch|cpu|b1h2q256k256d64|float32|causal=1|g1"}
        assert jat.tuned_blocks(q.shape, 256, jnp.float32) == jbest
        assert at.tuned_blocks(q.shape, 256, torch.float32, device="cpu") == tbest
        q2 = randn(47, 1, 2, 128, 64)
        at.autotune(*(torch.from_numpy(q2),) * 3, depth=1, iters=1)
        assert jat.tuned_blocks(q2.shape, 128, jnp.float32) is None  # the port's entry is not JAX's
    finally:
        jat.clear_cache()


def test_trainer_autotune_hook(cache):
    """TrainerConfig(autotune_blocks=True): before the first step the
    trainer tunes the model's attention shape and logs it; the entry is in
    the cache afterwards, and training runs."""
    cfg = dataclasses.replace(TORCH_CFG, block_size=128, n_layer=1, n_head=2, n_embd=32)
    tcfg = TrainerConfig(max_iters=2, eval_interval=10, log_interval=1, warmup_iters=1, autotune_blocks=True)
    trainer = Trainer(cfg, tcfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def batches():
        while True:
            x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, cfg.block_size + 1)))
            yield x[:, :-1], x[:, 1:]

    logs = []
    history = trainer.fit(batches(), log=logs.append)
    assert len(history) == 2 and all(np.isfinite(r["train_loss"]) for r in history)
    assert any("autotuned attention blocks" in str(line) for line in logs)
    hit = at.tuned_blocks((2, cfg.n_head, cfg.block_size, cfg.head_dim), cfg.block_size, cfg.dtype,
                          num_kv_heads=cfg.kv_heads, device="cpu")
    assert hit is not None and hit.block_q in K1_TILES[64]
    assert trainer.warmup_autotune(2) == hit  # a hit: the same tiling, from the cache


def test_engine_warmup_autotune(cache):
    """InferenceEngine.warmup_autotune tunes b=1 at each admission bucket of
    at least MIN_BLOCK (128 and 256 here, not 64) on the engine's device;
    prefill then runs at the tuned tiles and serves the request."""
    model = tgpt.GPT(TORCH_CFG, device="cpu")
    eng = InferenceEngine(model, slots=2, max_len=256, device="cpu")
    assert eng.buckets == [64, 128, 256]
    eng.warmup_autotune()
    d, h = TORCH_CFG.head_dim, TORCH_CFG.n_head
    keys = set(json.loads(cache.read_text()))
    assert keys == {f"torch|cpu|b1h{h}q{n}k{n}d{d}|float32|causal=1|g1" for n in (128, 256)}
    eng.submit([i % TORCH_CFG.vocab_size for i in range(1, 140)], max_new_tokens=3)
    (req,) = eng.run()
    assert len(req.output) == 3
    eng.warmup_autotune(buckets=[64])  # below MIN_BLOCK: nothing to tune
    assert set(json.loads(cache.read_text())) == keys


@pytest.mark.parametrize("d,bq", [(d, bq) for d, tiles in K1_TILES.items() for bq in tiles])
def test_k1_tiles_fit_and_default_first(d, bq):
    """Each tile K1 is built at is 64 rows per consumer warpgroup, fits an
    H100 block's shared memory, and the default (kernel_block_q) comes
    first; default_blocks is unchanged."""
    from flash_attention_tpu_torch.kernels import block_sizes as tbs

    assert bq % 64 == 0 and K1_TILES[d][0] == tbs.kernel_block_q(d)
    used = tbs.forward_smem_bytes(d, quantized=False, block_q=bq)
    assert used <= tbs.SMEM_PER_BLOCK
    assert used - tbs.forward_smem_bytes(d, quantized=False) == (bq - tbs.kernel_block_q(d)) * d * 2
    assert default_blocks(1024, 1024, d).block_q == tbs.kernel_block_q(d)
