"""Chunked prefill: `kv_cache.chunk_write` (bf16, int8, fp8 caches, and the
start that the JAX package's dynamic_update_slice clamps at the capacity),
`model_runner._offset_attention` (GQA, ragged starts, quantized scales;
1e-5 at fp32), `prefill_chunk` and `llama.prefill_chunk` against the JAX
package's, and the engine's `chunk_prefill` against the JAX engine's
(greedy outputs and the prefill_chunks / decode_steps stats), the final
chunk at the capacity included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JAX_CFG, TORCH_CFG, bits, from_jax, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.inference import engine as jengine
from flash_attention_tpu.inference import kv_cache as jkv
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.quant import kv as jquant
from flash_attention_tpu_torch.inference import engine as tengine
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.models import gpt as tgpt
from flash_attention_tpu_torch.models import llama as tl

CACHES = {
    "bfloat16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
    "int8": (dict(dtype=jnp.float32, quant_dtype=jnp.int8), dict(dtype=torch.float32, quant_dtype=torch.int8)),
    "float8_e4m3fn": (dict(dtype=jnp.float32, quant_dtype=jnp.float8_e4m3fn),
                      dict(dtype=torch.float32, quant_dtype=torch.float8_e4m3fn)),
    None: (dict(dtype=jnp.float32), dict(dtype=torch.float32)),
}


def _caches(kind, *, n_layer=JAX_CFG.n_layer, slots=2, kv_heads=JAX_CFG.kv_heads, max_len=64,
            head_dim=JAX_CFG.head_dim):
    args = (n_layer, slots, kv_heads, max_len, head_dim)
    jkw, tkw = CACHES[kind]
    return jkv.init_cache(*args, **jkw), tkv.init_cache(*args, **tkw, device="cpu")


def _values(x, exact: bool) -> np.ndarray:
    """A cache tensor of either package as numpy: its raw bits when
    `exact` (1-byte payloads as uint8, bf16 as int16), else fp32 values."""
    if isinstance(x, torch.Tensor):
        if not exact:
            return n(x.float())
        return bits(x) if x.element_size() == 1 else n(x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
    a = np.asarray(x)
    if not exact:
        return a.astype(np.float32)
    return bits(a) if a.itemsize == 1 else (a.view(np.int16) if a.dtype.name == "bfloat16" else a)


def _assert_same_cache(jc, tc, rows=None, atol=0.0):
    """Payloads (bit for bit when atol is 0), scales (1e-6 relative) and
    lengths; `rows` [slots] limits the comparison to each slot's first
    rows."""
    pairs = [(_values(tc.k, atol == 0), _values(jc.k, atol == 0), atol, 0),
             (_values(tc.v, atol == 0), _values(jc.v, atol == 0), atol, 0)]
    if tc.quantized:
        pairs += [(n(tc.k_scale), np.asarray(jc.k_scale), 0, 1e-6), (n(tc.v_scale), np.asarray(jc.v_scale), 0, 1e-6)]
    for got, want, a, r in pairs:
        for s, rows_s in enumerate(rows or [got.shape[3]] * got.shape[2]):
            np.testing.assert_allclose(got[:, :, s, :rows_s], want[:, :, s, :rows_s], atol=a, rtol=r)
    np.testing.assert_array_equal(n(tc.lengths), np.asarray(jc.lengths))


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "float8_e4m3fn"])
def test_chunk_write_matches_jax_and_clamps_at_capacity(kind):
    """Two chunks of 8 into a 32-row slot: at start 5, then at start 30,
    which JAX's dynamic_update_slice clamps to 24 (a slice would have
    written two rows); payloads bit for bit, scales equal, in place."""
    jc, tc = _caches(kind, n_layer=1, max_len=32)
    tensors = (tc.k, tc.v)
    h, d = JAX_CFG.kv_heads, JAX_CFG.head_dim
    for i, start in enumerate((5, 30)):
        k, v = randn(2 * i, h, 8, d), randn(2 * i + 1, h, 8, d) * 3.0
        jc = jkv.chunk_write(jc, 0, jnp.int32(1), jnp.asarray(k), jnp.asarray(v), jnp.int32(start))
        tkv.chunk_write(tc, 0, 1, t(k), t(v), start)
    assert tc.k is tensors[0] and tc.v is tensors[1]
    _assert_same_cache(jc, tc)
    written = n((tc.k[0, :, 1].float() != 0).any(dim=-1).any(dim=0))
    assert written.nonzero()[0].tolist() == list(range(5, 13)) + list(range(24, 32))


@pytest.mark.parametrize("kind", [None, "int8", "float8_e4m3fn"])
def test_offset_attention_matches_jax(kind):
    """q [3 slots, 4 heads, 5 rows, 16] over a GQA 4/2 cache of 40 rows at
    ragged starts (0, 7, 33: the last slot's rows reach past the capacity's
    end), fp32 q; int8/fp8 payloads with their scales: 1e-5."""
    s, hq, hkv, c, L, d = 3, 4, 2, 5, 40, 16
    q = randn(0, s, hq, c, d)
    k, v = randn(1, hkv, s, L, d), randn(2, hkv, s, L, d)
    starts = np.array([0, 7, 33], np.int32)
    ks = vs = None
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), t(k), t(v)
    if kind is not None:
        jq = dict(int8=jnp.int8, float8_e4m3fn=jnp.float8_e4m3fn)[kind]
        jk, jks = jquant.quantize_tokens(jk, jq)
        jv, jvs = jquant.quantize_tokens(jv, jq)
        ks, vs = np.asarray(jks), np.asarray(jvs)
        tk, tv = from_jax(jk), from_jax(jv)
    want = jmr._offset_attention(jnp.asarray(q), jk, jv, None if ks is None else jnp.asarray(ks),
                                 None if vs is None else jnp.asarray(vs), jnp.asarray(starts))
    got = tmr._offset_attention(t(q), tk, tv, None if ks is None else t(ks), None if vs is None else t(vs),
                                t(starts))
    assert got.shape == (s, hq, c, d) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def models():
    tree = numpy_params(seed=0)
    return jax_tree(tree), tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")


@pytest.mark.parametrize("kind", [None, "int8"])
def test_prefill_chunk_matches_jax(models, kind):
    """A 21-token prompt in chunks of 8 (the last padded, 5 real): each
    chunk's logits against JAX's (fp32 1e-5, int8 cache 1e-2), the cache's
    rows below the length (fp32 1e-5; int8 payloads bit for bit, scales
    1e-6), the length; and the port's chunked prefill
    against its whole-prompt prefill (1e-3, as the JAX package's own
    test)."""
    jp, tm = models
    prompt = np.random.default_rng(1).integers(0, 64, 21).astype(np.int32)
    jc, tc = _caches(kind)
    atol = 1e-5 if kind is None else 1e-2
    for start in range(0, 21, 8):
        valid = min(8, 21 - start)
        chunk = np.zeros(8, np.int32)
        chunk[:valid] = prompt[start:start + valid]
        jc, jlog = jmr.prefill_chunk(jp, jnp.asarray(chunk), JAX_CFG, jc, jnp.int32(1), jnp.int32(start),
                                     jnp.int32(valid))
        tc, tlog = tmr.prefill_chunk(tm, t(chunk), tc, 1, start, valid)
        assert tlog.dtype == torch.float32 and tlog.shape == (64,)
        np.testing.assert_allclose(n(tlog), np.asarray(jlog), atol=atol, rtol=0)
    assert n(tc.lengths).tolist() == [0, 21]
    _assert_same_cache(jc, tc, rows=[0, 21], atol=1e-5 if kind is None else 0.0)
    _, whole = _caches(kind)
    _, wlog = tmr.prefill(tm, t(prompt), whole, 1)
    np.testing.assert_allclose(n(tlog), n(wlog), atol=1e-3 if kind is None else 2e-2, rtol=0)


def test_llama_prefill_chunk_matches_jax():
    """TINY_LLAMA, a 45-token prompt in chunks of 16 on an fp32 cache:
    logits of every chunk 1e-5, the cache's rows below the length (RoPE at
    absolute positions), the length; and against the whole prompt's
    prefill (1e-4)."""
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), jl.TINY_LLAMA))
    jp, tm = jax_tree(tree), tl.params_from_jax(tree, tl.TINY_LLAMA, device="cpu")
    cfg = jl.TINY_LLAMA
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 45).astype(np.int32)
    jc, tc = _caches(None, n_layer=cfg.n_layer, kv_heads=cfg.n_kv_head, max_len=128, head_dim=cfg.head_dim)
    for start in range(0, 45, 16):
        valid = min(16, 45 - start)
        chunk = np.full(16, prompt[-1], np.int32)
        chunk[:valid] = prompt[start:start + valid]
        jc, jlog = jl.prefill_chunk(jp, jnp.asarray(chunk), cfg, jc, jnp.int32(0), jnp.int32(start), jnp.int32(valid))
        tc, tlog = tl.prefill_chunk(tm, t(chunk), tc, 0, start, valid)
        np.testing.assert_allclose(n(tlog), np.asarray(jlog), atol=1e-5, rtol=0)
    _assert_same_cache(jc, tc, rows=[45, 0], atol=1e-5)
    _, whole = _caches(None, n_layer=cfg.n_layer, kv_heads=cfg.n_kv_head, max_len=128, head_dim=cfg.head_dim)
    _, wlog = tl.prefill(tm, t(prompt), whole, 0)
    np.testing.assert_allclose(n(tlog), n(wlog), atol=1e-4, rtol=0)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def scaled_models():
    """Weights at std ~0.5, so that greedy top-2 logit gaps sit far above
    the parity tier and a flipped token reads as a fault."""
    tree = numpy_params(seed=1, scale=25.0)
    return jax_tree(tree), tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")


PROMPTS = [[1, 2, 3] * 9, [5, 4, 3, 2, 1], list(range(1, 22))]  # 27 and 21 tokens chunk; 5 does not


def _run(engine, prompts, budget):
    for p in prompts:
        engine.submit(p, max_new_tokens=budget)
    return {r.uid: r.output for r in engine.run()}


@pytest.fixture(scope="module")
def jax_chunked(scaled_models):
    """The JAX engine on PROMPTS with chunk_prefill 8 (synchronous drain,
    the port's default) and without: outputs and stats."""
    jp, _ = scaled_models
    out = {}
    for chunk in (None, 8):
        eng = jengine.InferenceEngine(jp, JAX_CFG, slots=2, max_len=64, scan_steps=2, chunk_prefill=chunk,
                                      pipeline_scans=False)
        out[chunk] = (_run(eng, PROMPTS, 6), dict(eng.stats))
    return out


def test_engine_chunked_prefill_matches_jax_engine(scaled_models, jax_chunked):
    """Chunks of 8 interleaved with decode scans: the greedy outputs equal
    the JAX chunked engine's and the port's own whole-prompt admission; the
    chunk count (4 + 3) and decode steps equal JAX's."""
    _, tm = scaled_models
    eng = tengine.InferenceEngine(tm, slots=2, max_len=64, scan_steps=2, chunk_prefill=8, device="cpu")
    got = _run(eng, PROMPTS, 6)
    want, jstats = jax_chunked[8]
    assert got == want == jax_chunked[None][0]
    assert eng.stats["prefill_chunks"] == jstats["prefill_chunks"] == 7
    assert eng.stats["decode_steps"] == jstats["decode_steps"]
    assert eng.stats["prefills"] == jstats["prefills"] == 3
    assert eng.stats["prefill_dispatches"] == 1  # the 5-token prompt
    whole = tengine.InferenceEngine(tm, slots=2, max_len=64, scan_steps=2, device="cpu")
    assert _run(whole, PROMPTS, 6) == got


@pytest.mark.parametrize("length", [58, 62, 63])
def test_engine_final_chunk_at_capacity(scaled_models, length):
    """max_len 64, chunks of 24: the final chunk would cross the capacity,
    so it is shifted back to end at 64 (three chunks: 0, 24, 40).  The
    first token equals whole-prompt admission's and the JAX engine's."""
    jp, tm = scaled_models
    prompt = [(i % 50) + 1 for i in range(length)]
    jeng = jengine.InferenceEngine(jp, JAX_CFG, slots=1, max_len=64, scan_steps=2, chunk_prefill=24,
                                   pipeline_scans=False)
    want = _run(jeng, [prompt], 1)
    eng = tengine.InferenceEngine(tm, slots=1, max_len=64, scan_steps=2, chunk_prefill=24, device="cpu")
    got = _run(eng, [prompt], 1)
    whole = tengine.InferenceEngine(tm, slots=1, max_len=64, scan_steps=2, device="cpu")
    assert got == want == _run(whole, [prompt], 1)
    assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"] == 3


def test_llama_engine_chunked_prefill_matches_jax_engine():
    """A Llama engine with prefill_chunk_fn=llama.prefill_chunk and chunks
    of 16 against the JAX engine with the same options (TINY_LLAMA, fp32,
    weights scaled as the GPT engine tests'): greedy outputs, chunk count,
    decode steps; and against the port's whole-prompt admission."""
    cfg = jl.TINY_LLAMA
    tree = jax.tree.map(lambda a: a * 25.0 if a.ndim == 2 else a,
                        jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(3), cfg)))
    jp, tm = jax_tree(tree), tl.params_from_jax(tree, tl.TINY_LLAMA, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, m).tolist() for m in (40, 9, 33)]
    jeng = jengine.InferenceEngine(jp, cfg, slots=2, max_len=128, scan_steps=4, prefill_fn=jl.prefill,
                                   decode_fn=jl.decode_step, prefill_chunk_fn=jl.prefill_chunk, chunk_prefill=16,
                                   pipeline_scans=False)
    want = _run(jeng, prompts, 7)
    kw = dict(slots=2, max_len=128, scan_steps=4, prefill_fn=tl.prefill, decode_fn=tl.decode_step, device="cpu")
    eng = tengine.InferenceEngine(tm, prefill_chunk_fn=tl.prefill_chunk, chunk_prefill=16, **kw)
    got = _run(eng, prompts, 7)
    assert got == want == _run(tengine.InferenceEngine(tm, **kw), prompts, 7)
    assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"] == 6
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]


def test_chunk_prefill_with_custom_prefill_fn_needs_chunk_fn():
    tm = tl.Llama(tl.TINY_LLAMA, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk_fn"):
        tengine.InferenceEngine(tm, prefill_fn=tl.prefill, decode_fn=tl.decode_step, chunk_prefill=16, device="cpu")
    # without chunk_prefill a custom prefill_fn needs no chunk function
    tengine.InferenceEngine(tm, prefill_fn=tl.prefill, decode_fn=tl.decode_step, device="cpu")
