"""Serving path: KV cache writes (plain and int8/fp8), prefill /
prefill_many / decode_step (every attn_impl) against the JAX package's
model_runner (1e-4, fp32), the engine's greedy outputs (plain and int8
cache) against the JAX engine's, sampling support, the engine's options
against the JAX engine's constructor, and the CUDA-only paths that must
raise where there is no card."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JAX_CFG, TORCH_CFG, bits, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.inference import engine as jengine
from flash_attention_tpu.inference import kv_cache as jkv
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu_torch.inference import engine as tengine
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.inference import sampling as tsamp
from flash_attention_tpu_torch.models import gpt as tgpt

SLOTS, MAX_LEN = 3, 256


@pytest.fixture(scope="module")
def models():
    tree = numpy_params(seed=0)
    return jax_tree(tree), tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")


QUANT = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _caches(quant: str | None = None):
    args = (JAX_CFG.n_layer, SLOTS, JAX_CFG.kv_heads, MAX_LEN, JAX_CFG.head_dim)
    jq, tq = QUANT[quant] if quant else (None, None)
    return (jkv.init_cache(*args, dtype=jnp.float32, quant_dtype=jq),
            tkv.init_cache(*args, dtype=torch.float32, quant_dtype=tq, device="cpu"))


def _assert_cache_equal(jc, tc, atol=1e-4):
    np.testing.assert_allclose(n(tc.k), np.asarray(jc.k), atol=atol, rtol=0)
    np.testing.assert_allclose(n(tc.v), np.asarray(jc.v), atol=atol, rtol=0)
    np.testing.assert_array_equal(n(tc.lengths), np.asarray(jc.lengths))


def test_cache_writes_match_jax_and_happen_in_place():
    jc, tc = _caches()
    h, d = JAX_CFG.kv_heads, JAX_CFG.head_dim
    k0, v0 = randn(1, h, 7, d), randn(2, h, 7, d)
    jc = jkv.prefill_write(jc, 0, jnp.int32(2), jnp.asarray(k0), jnp.asarray(v0))
    k_before = tc.k
    assert tkv.prefill_write(tc, 0, 2, t(k0), t(v0)) is tc
    assert tc.k is k_before  # same storage: written in place
    jc = jkv.set_length(jc, jnp.int32(2), 7)
    tkv.set_length(tc, 2, 7)
    kn, vn = randn(3, SLOTS, h, d), randn(4, SLOTS, h, d)
    pos = np.array([0, 5, 7], np.int32)
    jc = jkv.decode_write(jc, 1, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    tkv.decode_write(tc, 1, t(kn), t(vn), t(pos))
    jc = jkv.advance_lengths(jc, jnp.asarray([1, 0, 1], jnp.int32))
    tkv.advance_lengths(tc, t(np.array([1, 0, 1], np.int32)))
    _assert_cache_equal(jc, tc, atol=0)
    jk, jv = jkv.layer_kv(jc, 1, dtype=jnp.float32)
    tk, tv = tkv.layer_kv(tc, 1, dtype=torch.float32)
    np.testing.assert_array_equal(n(tk), np.asarray(jk))
    np.testing.assert_array_equal(n(tv), np.asarray(jv))


@pytest.mark.parametrize("quant", QUANT)
def test_quantized_cache_writes_match_jax_in_place(quant):
    """prefill_write and decode_write store JAX's payloads (bit for bit) and
    scales, in place; k_scale and v_scale are separate tensors, where the
    JAX package's init_cache gives both one array."""
    jc, tc = _caches(quant)
    assert tc.quantized and tc.k_scale is not tc.v_scale
    h, d = JAX_CFG.kv_heads, JAX_CFG.head_dim
    k0, v0 = randn(11, h, 9, d), randn(12, h, 9, d)
    jc = jkv.prefill_write(jc, 1, jnp.int32(2), jnp.asarray(k0), jnp.asarray(v0))
    tensors = (tc.k, tc.v, tc.k_scale, tc.v_scale)
    tkv.prefill_write(tc, 1, 2, t(k0), t(v0))
    kn, vn = randn(13, SLOTS, h, d), randn(14, SLOTS, h, d) * 5.0
    pos = np.array([3, 0, 9], np.int32)
    jc = jkv.decode_write(jc, 0, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    tkv.decode_write(tc, 0, t(kn), t(vn), t(pos))
    assert all(a is b for a, b in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), tensors))
    np.testing.assert_array_equal(bits(tc.k), bits(jc.k))
    np.testing.assert_array_equal(bits(tc.v), bits(jc.v))
    np.testing.assert_array_equal(n(tc.k_scale), np.asarray(jc.k_scale))
    np.testing.assert_array_equal(n(tc.v_scale), np.asarray(jc.v_scale))
    for layer in (0, 1):
        for a, b in zip(tkv.layer_kv(tc, layer, torch.float32), jkv.layer_kv(jc, layer, jnp.float32)):
            np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("t_len,length", [(160, None), (64, 41)])
def test_prefill_matches_jax(models, t_len, length):
    """Whole prompt (flash route) and a bucket-padded prompt (dense route)."""
    jp, tm = models
    toks = np.random.default_rng(t_len).integers(0, 64, t_len).astype(np.int32)
    jc, tc = _caches()
    jc, jl = jmr.prefill(jp, jnp.asarray(toks), JAX_CFG, jc, jnp.int32(1),
                         None if length is None else jnp.int32(length))
    tc, tl = tmr.prefill(tm, t(toks), tc, 1, length)
    np.testing.assert_allclose(n(tl), np.asarray(jl), atol=1e-4, rtol=0)
    assert tl.dtype == torch.float32 and tl.shape == (64,)
    _assert_cache_equal(jc, tc)


def test_prefill_many_matches_jax(models):
    jp, tm = models
    bucket = 128
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, m).tolist() for m in (100, 128)]
    toks = np.zeros((2, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
        toks[i, len(p):] = p[-1]
    lens, slots = [100, 128], [2, 0]
    jc, tc = _caches()
    jc, jl = jmr.prefill_many(jp, jnp.asarray(toks), JAX_CFG, jc, jnp.asarray(slots), jnp.asarray(lens))
    tc, tl = tmr.prefill_many(tm, t(toks), tc, slots, lens)
    np.testing.assert_allclose(n(tl), np.asarray(jl), atol=1e-4, rtol=0)
    _assert_cache_equal(jc, tc)


def test_chained_decode_steps_match_jax(models):
    """8 chained decode steps after a prefill, teacher-forced with the same
    tokens in both packages; slot 2 inactive (its length must not move)."""
    jp, tm = models
    prompt = np.arange(1, 21, dtype=np.int32)
    jc, tc = _caches()
    jc, _ = jmr.prefill(jp, jnp.asarray(prompt), JAX_CFG, jc, jnp.int32(0))
    tc, _ = tmr.prefill(tm, t(prompt), tc, 0)
    jc, _ = jmr.prefill(jp, jnp.asarray(prompt[:5]), JAX_CFG, jc, jnp.int32(1))
    tc, _ = tmr.prefill(tm, t(prompt[:5]), tc, 1)
    active = np.array([True, True, False])
    feed = np.random.default_rng(5).integers(0, 64, (8, SLOTS)).astype(np.int32)
    for step in range(8):
        jc, jl = jmr.decode_step(jp, jnp.asarray(feed[step]), JAX_CFG, jc, jnp.asarray(active))
        tc, tl = tmr.decode_step(tm, t(feed[step]), tc, t(active))
        np.testing.assert_allclose(n(tl)[:2], np.asarray(jl)[:2], atol=1e-4, rtol=0)
    assert n(tc.lengths).tolist() == [28, 13, 0]
    _assert_cache_equal(jc, tc)


@pytest.mark.parametrize("attn_impl", ["einsum", "paged", "fused"])
def test_chained_quantized_decode_steps_match_jax(models, attn_impl):
    """An int8 cache: prefill, then 8 teacher-forced decode steps.  The
    port's attn_impl path against the JAX package's einsum path at 1e-4, the
    fp32 tier of the unquantized test; the payloads stay bit-equal (K/V the
    two packages compute 1e-7 apart round to the same int8 here) and the
    scales equal to 1e-6 relative.  Against
    the port's own einsum path on the same cache, at 1e-5."""
    jp, tm = models
    prompt = np.arange(1, 21, dtype=np.int32)
    jc, tc = _caches("int8")
    _, ref_cache = _caches("int8")
    for cache in (tc, ref_cache):
        tmr.prefill(tm, t(prompt), cache, 0)
        tmr.prefill(tm, t(prompt[:5]), cache, 1)
    jc, _ = jmr.prefill(jp, jnp.asarray(prompt), JAX_CFG, jc, jnp.int32(0))
    jc, _ = jmr.prefill(jp, jnp.asarray(prompt[:5]), JAX_CFG, jc, jnp.int32(1))
    active = np.array([True, True, False])
    feed = np.random.default_rng(5).integers(0, 64, (8, SLOTS)).astype(np.int32)
    for step in range(8):
        jc, jl = jmr.decode_step(jp, jnp.asarray(feed[step]), JAX_CFG, jc, jnp.asarray(active))
        tc, tl = tmr.decode_step(tm, t(feed[step]), tc, t(active), attn_impl=attn_impl)
        _, el = tmr.decode_step(tm, t(feed[step]), ref_cache, t(active))
        np.testing.assert_allclose(n(tl)[:2], np.asarray(jl)[:2], atol=1e-4, rtol=0)
        np.testing.assert_allclose(n(tl)[:2], n(el)[:2], atol=1e-5, rtol=0)
    assert n(tc.lengths).tolist() == [28, 13, 0]
    np.testing.assert_array_equal(bits(tc.k), bits(jc.k))
    np.testing.assert_allclose(n(tc.v_scale), np.asarray(jc.v_scale), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="attn_impl"):
        tmr.decode_step(tm, t(feed[0]), tc, attn_impl="chunked")


def test_decode_stops_advancing_at_capacity(models):
    _, tm = models
    _, tc = _caches()
    tmr.prefill(tm, torch.zeros(8, dtype=torch.long), tc, 0)
    tkv.set_length(tc, 0, MAX_LEN - 1)
    tmr.decode_step(tm, torch.zeros(SLOTS, dtype=torch.int32), tc)
    assert int(tc.lengths[0]) == MAX_LEN - 1


def test_decode_loop_is_greedy_decode_steps(models):
    _, tm = models
    _, c1 = _caches()
    _, c2 = _caches()
    first = t(np.array([3, 4, 5], np.int32))
    _, toks = tmr.decode_loop(tm, c1, first, 4)
    cur = first
    for i in range(4):
        _, logits = tmr.decode_step(tm, cur, c2)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
        assert torch.equal(toks[i], cur)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def scaled_models():
    """Weights at std ~0.5 so that greedy top-2 logit gaps sit far above the
    1e-4 parity tier: a flipped token then reads as a bug, not a tie."""
    tree = numpy_params(seed=1, scale=25.0)
    return jax_tree(tree), tgpt.params_from_jax(tree, TORCH_CFG, device="cpu")


def _min_top2_gap(tm, prompt, output):
    with torch.no_grad():
        logits = tm(t(np.array([prompt + output[:-1]], np.int64)))[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).min().item()


def test_engine_greedy_matches_jax_engine(scaled_models):
    """More requests than slots, one prompt over 128 tokens (flash route),
    one at max_len (cut to its last max_len-1 tokens, then cache-full),
    mixed budgets: outputs equal the JAX engine's token for token."""
    jp, tm = scaled_models
    rng = np.random.default_rng(7)
    lens_budgets = [(5, 6), (150, 5), (30, 9), (70, 3), (12, 1), (MAX_LEN, 4), (9, 12)]
    prompts = [(rng.integers(0, 64, m).tolist(), b) for m, b in lens_budgets]
    jeng = jengine.InferenceEngine(jp, JAX_CFG, slots=2, max_len=MAX_LEN, scan_steps=4, pipeline_scans=False)
    teng = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=4)
    for p, b in prompts:
        jeng.submit(p, max_new_tokens=b)
        teng.submit(p, max_new_tokens=b)
    jout = {r.uid: r.output for r in jeng.run()}
    tdone = teng.run()
    tout = {r.uid: r.output for r in tdone}
    assert tout == jout
    for r in tdone:
        # cache-full is checked when a scan is drained, so a prompt of
        # max_len-1 tokens still gets its admission token and one more
        assert len(r.output) == min(r.max_new_tokens, max(2, MAX_LEN - len(r.prompt)))
        assert r.ttft is not None and r.ttft >= 0
        if len(r.output) > 0:
            assert _min_top2_gap(tm, r.prompt, r.output) > 1e-2
    assert teng.stats["tokens_out"] == sum(len(o) for o in tout.values())


def test_engine_int8_greedy_matches_jax_int8_engine(scaled_models):
    """An int8 KV cache: the port's engine, on each decode path, gives the
    JAX int8 engine's greedy outputs token for token; kv_quant_dtype may be
    given by name, as the JAX README does."""
    jp, tm = scaled_models
    rng = np.random.default_rng(8)
    lens_budgets = [(5, 6), (150, 5), (30, 9), (12, 1), (9, 12)]
    prompts = [(rng.integers(0, 64, m).tolist(), b) for m, b in lens_budgets]
    jeng = jengine.InferenceEngine(jp, JAX_CFG, slots=2, max_len=MAX_LEN, scan_steps=4, pipeline_scans=False,
                                   kv_quant_dtype=jnp.int8)
    for p, b in prompts:
        jeng.submit(p, max_new_tokens=b)
    jout = {r.uid: r.output for r in jeng.run()}
    for attn_impl, dtype in (("einsum", "int8"), ("paged", torch.int8), ("fused", "int8")):
        teng = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=4, kv_quant_dtype=dtype,
                                       decode_fn=functools.partial(tmr.decode_step, attn_impl=attn_impl))
        assert teng.cache.k.dtype == torch.int8 and teng.cache.quantized
        for p, b in prompts:
            teng.submit(p, max_new_tokens=b)
        assert {r.uid: r.output for r in teng.run()} == jout, attn_impl


def test_engine_honours_decode_fn_and_checks_quant_dtype(models):
    _, tm = models
    calls = []

    def decode_fn(model, tokens, cache, active):
        calls.append(tokens.shape)
        return tmr.decode_step(model, tokens, cache, active)

    eng = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=4, decode_fn=decode_fn)
    eng.submit([1, 2, 3], max_new_tokens=6)
    ref = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=4)
    ref.submit([1, 2, 3], max_new_tokens=6)
    assert eng.run()[0].output == ref.run()[0].output
    assert len(calls) == eng.stats["decode_steps"] > 0
    assert tengine.InferenceEngine(tm, kv_quant_dtype="float8_e4m3fn").cache.k.dtype == torch.float8_e4m3fn
    for bad in ("int4", torch.float16):
        with pytest.raises(ValueError, match="kv_quant_dtype|quant_dtype"):
            tengine.InferenceEngine(tm, kv_quant_dtype=bad)


def test_engine_eos_and_single_token(models):
    _, tm = models
    eng = tengine.InferenceEngine(tm, slots=1, max_len=MAX_LEN, scan_steps=4)
    eng.submit([1, 2, 3, 4], max_new_tokens=8)
    ref = eng.run()[0].output
    eos, stop = next((tok, i) for i, tok in enumerate(ref) if tok != ref[0])
    eng = tengine.InferenceEngine(tm, slots=1, max_len=MAX_LEN, scan_steps=4)
    eng.submit([1, 2, 3, 4], max_new_tokens=8, eos_id=eos)
    eng.submit([1, 2, 3], max_new_tokens=1)
    done = {r.uid: r.output for r in eng.run()}
    assert done[1] == ref[: stop + 1]
    _, first = tmr.prefill(tm, t(np.array([1, 2, 3])), _caches()[1], 0)
    assert done[2] == [int(torch.argmax(first))]
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit([])


def test_engine_streams_every_token(models):
    _, tm = models
    streamed = {}
    eng = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=2)
    for p in ([1, 2, 3], [4, 5]):
        eng.submit(p, max_new_tokens=5, on_token=lambda r, tok: streamed.setdefault(r.uid, []).append(tok))
    for r in eng.run():
        assert streamed[r.uid] == r.output


def test_engine_sampled_requests_finish_in_range(models):
    _, tm = models
    eng = tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=4, rng_seed=3)
    eng.submit([1, 2, 3], max_new_tokens=7, temperature=0.8, top_k=5)
    eng.submit([4, 5, 6], max_new_tokens=6, temperature=0.8, top_p=0.9)
    eng.submit([7, 8], max_new_tokens=5)
    done = eng.run()
    assert sorted(len(r.output) for r in done) == [5, 6, 7]
    assert all(0 <= tok < TORCH_CFG.vocab_size for r in done for tok in r.output)


def test_top_k_top_p_restrict_support():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[5.0, 4.9, 0.0, -1.0, -2.0]] * 2)
    for _ in range(20):
        assert set(tsamp.sample(logits, gen, temperature=1.0, top_p=0.7).tolist()) <= {0, 1}
        assert set(tsamp.sample(logits, gen, temperature=5.0, top_k=3).tolist()) <= {0, 1, 2}
        toks = tsamp.sample_tokens(
            logits, gen, torch.tensor([1.0, 5.0]), torch.tensor([5, 2]), torch.tensor([0.7, 1.0])
        )
        assert int(toks[0]) in (0, 1) and int(toks[1]) in (0, 1)
    greedy = tsamp.sample_tokens(logits, gen, torch.tensor([0.0, -1.0]), torch.tensor([5, 5]))
    assert greedy.tolist() == [0, 0]
    # temperature 5 over 5 tokens with no filter reaches the tail
    seen = set()
    for _ in range(200):
        seen |= set(tsamp.sample(logits, gen, temperature=5.0).tolist())
    assert seen == {0, 1, 2, 3, 4}


def test_engine_takes_every_option_of_the_jax_engine(models):
    """The port's constructor takes each parameter of the JAX engine's,
    with `model` in place of params + cfg and `draft_model` in place of
    draft_params + draft_cfg, and the same defaults except
    pipeline_scans (False on the card until it is measured there)."""
    import inspect

    spelled = {"params": "model", "cfg": "model", "draft_params": "draft_model", "draft_cfg": "draft_model"}
    jsig = inspect.signature(jengine.InferenceEngine.__init__).parameters
    tsig = inspect.signature(tengine.InferenceEngine.__init__).parameters
    for name, param in jsig.items():
        if name == "self":
            continue
        port = spelled.get(name, name)
        assert port in tsig, name
        if name not in spelled and name != "pipeline_scans":
            assert tsig[port].default == param.default, name
    assert jsig["pipeline_scans"].default is True and tsig["pipeline_scans"].default is False
    _, tm = models
    eng = tengine.InferenceEngine(
        tm, chunk_prefill=16, prefill_chunk_fn=tmr.prefill_chunk, draft_model=tm, spec_k=2, spec_adaptive=True,
        spec_min_accept=1.5, spec_retrial_every=4, spec_reopen_margin=0.2, scan_tokens_target=8,
        pipeline_scans=True, device="cpu",
    )
    eng.submit(list(range(1, 40)), max_new_tokens=5)
    eng.submit([1, 2, 3], max_new_tokens=5, temperature=0.7)
    assert sorted(len(r.output) for r in eng.run()) == [5, 5]


def test_cuda_paths_raise_without_a_card(models):
    """Asked for the card where there is none, the port raises; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card behaviour")
    _, tm = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.InferenceEngine(tm, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.init_cache(1, 1, 1, 8, 16, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.GPT(dataclasses.replace(TORCH_CFG, n_layer=1), device="cuda")
