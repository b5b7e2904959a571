"""Llama slice: the port's `models/llama.py` against the JAX package's on
the same numpy params and inputs (TINY_LLAMA, fp32): the forward and
loss_fn (1e-5), RoPE (1e-6) and RMSNorm, prefill logits and cache contents
on bf16 and fp8 caches (fp8 bytes bit-equal), chained decode steps and
decode_loop (logits 1e-5, tokens equal), the engine with prefill_fn /
decode_fn on an fp8 cache (greedy outputs equal to the JAX engine's), the
trainer on a LlamaConfig (first-step loss 1e-5, falling), and JAX-quantized
params loaded unchanged.  The JAX side runs its Pallas kernels in interpret
mode, as its own tests do."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, n, randn, t
from flash_attention_tpu.inference import InferenceEngine as JEngine
from flash_attention_tpu.inference import kv_cache as jkv
from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.quant import weights as jw
from flash_attention_tpu.training import Trainer as JTrainer
from flash_attention_tpu.training import TrainerConfig as JTrainerConfig
from flash_attention_tpu_torch.inference import InferenceEngine
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.quant import weights as tw
from flash_attention_tpu_torch.training import Trainer, TrainerConfig

JCFG, TCFG = jl.TINY_LLAMA, tl.TINY_LLAMA
CACHES = {
    "float32": (dict(dtype=jnp.float32), dict(dtype=torch.float32)),
    "bfloat16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
    "float8_e4m3fn": (dict(dtype=jnp.float32, quant_dtype=jnp.float8_e4m3fn),
                      dict(dtype=torch.float32, quant_dtype=torch.float8_e4m3fn)),
}


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model(tree):
    return tl.params_from_jax(tree, TCFG, device="cpu")


def _ids(seed, *shape):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape).astype(np.int32)


def _caches(kind: str, slots: int = 2, max_len: int = 128):
    args = (JCFG.n_layer, slots, JCFG.n_kv_head, max_len, JCFG.head_dim)
    jkw, tkw = CACHES[kind]
    return jkv.init_cache(*args, **jkw), tkv.init_cache(*args, **tkw, device="cpu")


def test_configs_match_jax():
    for name in ("LLAMA2_7B", "LLAMA3_8B", "TINY_LLAMA"):
        j, p = getattr(jl, name), getattr(tl, name)
        for f in ("vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd", "intermediate", "max_seq", "rope_theta",
                  "rms_eps", "head_dim"):
            assert getattr(p, f) == getattr(j, f), (name, f)
    assert tl.LLAMA3_8B.head_dim == 128 and tl.LLAMA3_8B.n_head // tl.LLAMA3_8B.n_kv_head == 4


@pytest.mark.parametrize("length", [40, 144])
def test_forward_and_loss_match_jax(jparams, model, length):
    """Below and above the kernels' MIN_BLOCK (dense and tile-loop routes)."""
    idx, tgt = _ids(1, 2, length), _ids(2, 2, length)
    want = jl.forward(jparams, jnp.asarray(idx), JCFG)
    got = model(torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (2, length, JCFG.vocab_size)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)
    jloss = jl.loss_fn(jparams, jnp.asarray(idx), jnp.asarray(tgt), JCFG)
    tloss = tl.loss_fn(model, torch.from_numpy(idx), torch.from_numpy(tgt))
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=0)


@pytest.mark.parametrize("theta,d", [(10000.0, 16), (10000.0, 128), (500000.0, 128)])
def test_rope_matches_jax(theta, d):
    """Split halves (not interleaved), tables in fp32 (1e-6)."""
    pos = np.arange(0, 256)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), d, theta)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), d, theta)
    assert tc.dtype == torch.float32 and tc.shape == (256, d // 2)
    np.testing.assert_allclose(n(tc), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(ts), np.asarray(js), atol=1e-6, rtol=0)
    x = randn(3, 1, 2, 256, d)
    want = jl.apply_rope(jnp.asarray(x), jc[None, None], js[None, None])
    got = tl.apply_rope(t(x), tc[None, None], ts[None, None])
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=0)
    # split halves: column i pairs with column i + d/2
    e = np.zeros((1, 1, 1, d), np.float32)
    e[..., 0] = 1.0
    c, s = tl.rope_cos_sin(torch.tensor([1]), d, theta)
    y = tl.apply_rope(t(e), c, s)[0, 0, 0]
    assert float(y[d // 2]) == pytest.approx(float(s[0, 0])) and float(y[1]) == 0.0


def test_rms_norm_and_rope_in_bf16_match_jax():
    """RMSNorm in fp32 times the fp32 gain, cast back; RoPE in fp32, cast
    back: bf16 results bit-equal to JAX's."""
    x = randn(4, 3, 5, 64)
    g = 1.0 + 0.1 * randn(5, 64)
    want = jl._rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g), 1e-5)
    got = tl._rms_norm(t(x).bfloat16(), t(g), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got.view(torch.int16)), np.asarray(want).view(np.int16))
    jc, js = jl.rope_cos_sin(jnp.arange(5), 64, 10000.0)
    tc, ts = tl.rope_cos_sin(torch.arange(5), 64, 10000.0)
    want = jl.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jc, js)
    got = tl.apply_rope(t(x).bfloat16(), tc, ts)
    np.testing.assert_array_equal(n(got.view(torch.int16)), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("kind", ["bfloat16", "float8_e4m3fn"])
def test_prefill_matches_jax(jparams, model, kind):
    """A bucket-padded prompt (37 real tokens of 64): logits at the last
    real token, fp32 (1e-5); the cache after RoPE (bf16 within one ulp,
    fp8 payload bytes bit-equal, scales 1e-6); the length."""
    prompt = _ids(3, 64)
    jc, tc = _caches(kind)
    jc, jlog = jl.prefill(jparams, jnp.asarray(prompt), JCFG, jc, jnp.int32(1), jnp.int32(37))
    tc, tlog = tl.prefill(model, torch.from_numpy(prompt), tc, 1, 37)
    assert tlog.dtype == torch.float32 and tlog.shape == (JCFG.vocab_size,)
    np.testing.assert_allclose(n(tlog), np.asarray(jlog), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(tc.lengths), np.asarray(jc.lengths))
    if kind == "float8_e4m3fn":
        np.testing.assert_array_equal(bits(tc.k), bits(jc.k))
        np.testing.assert_array_equal(bits(tc.v), bits(jc.v))
        np.testing.assert_allclose(n(tc.k_scale), np.asarray(jc.k_scale), atol=1e-6, rtol=1e-6)
    else:
        # K and V agree to 1e-6 in fp32 before the cast; a value near a bf16
        # rounding boundary may round to the neighbour: one ulp, 2^-7 relative
        np.testing.assert_allclose(n(tc.k.float()), np.asarray(jc.k, np.float32), atol=0, rtol=2 ** -7)
        np.testing.assert_allclose(n(tc.v.float()), np.asarray(jc.v, np.float32), atol=0, rtol=2 ** -7)


def _greedy_ref(model, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        toks.append(int(torch.argmax(model(torch.tensor([toks]))[0, -1])))
    return toks[len(prompt):]


@pytest.mark.parametrize("kind", ["float32", "float8_e4m3fn"])
def test_decode_steps_and_loop_match_jax(jparams, model, kind):
    """Prefill two slots, then chained decode steps with slot 1 inactive:
    logits 1e-5 and tokens equal at every step; decode_loop's tokens equal
    to JAX's; on the fp32 cache the greedy tokens equal full recompute (the
    RoPE positions of cached decode)."""
    prompt = [1, 5, 9, 2, 7, 3, 8, 4]
    jc, tc = _caches(kind)
    for slot in (1, 0):  # slot 0 last: its logits give the first token
        jc, jlog = jl.prefill(jparams, jnp.asarray(prompt[: 7 + slot], jnp.int32), JCFG, jc, jnp.int32(slot))
        tc, tlog = tl.prefill(model, torch.tensor(prompt[: 7 + slot]), tc, slot)
    jc0 = jax.tree.map(lambda x: x, jc)
    tc0 = dataclasses.replace(tc, **{f.name: getattr(tc, f.name).clone() for f in dataclasses.fields(tc)
                                     if getattr(tc, f.name) is not None})
    first = int(torch.argmax(tlog))
    toks = [first]
    jnxt = jnp.full((2,), first, jnp.int32)
    tnxt = torch.full((2,), first, dtype=torch.int32)
    active = np.array([True, False])
    for _ in range(5):
        jc, jlog = jl.decode_step(jparams, jnxt, JCFG, jc, jnp.asarray(active))
        tc, tlog = tl.decode_step(model, tnxt, tc, torch.from_numpy(active))
        np.testing.assert_allclose(n(tlog), np.asarray(jlog), atol=1e-5, rtol=0)
        jnxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        tnxt = torch.argmax(tlog, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(n(tnxt), np.asarray(jnxt))
        toks.append(int(tnxt[0]))
    np.testing.assert_array_equal(n(tc.lengths), np.asarray(jc.lengths))
    if kind == "float32":
        assert toks[:6] == _greedy_ref(model, prompt[:7], 6)
    first2 = torch.tensor([first, first], dtype=torch.int32)
    _, jtoks = jl.decode_loop(jparams, JCFG, jc0, jnp.asarray(n(first2)), 4)
    _, ttoks = tl.decode_loop(model, tc0, first2, 4)
    assert ttoks.shape == (4, 2)
    np.testing.assert_array_equal(n(ttoks), np.asarray(jtoks))


def test_decode_stops_at_capacity(model):
    """Positions are lengths clipped to the capacity, and a full slot stops
    advancing at max_len - 1."""
    _, tc = _caches("float32", max_len=16)
    tc.lengths.copy_(torch.tensor([15, 3], dtype=torch.int32))
    tl.decode_step(model, torch.tensor([1, 2], dtype=torch.int32), tc)
    assert tc.lengths.tolist() == [15, 4]


def test_engine_on_fp8_cache_matches_jax_engine(jparams, model):
    """InferenceEngine with prefill_fn / decode_fn over a Llama on an fp8
    cache: greedy outputs equal to the JAX engine's (one prompt per
    prefill dispatch), and the first token equal to full recompute."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9], [6, 6, 6], [9, 8, 7, 6, 5, 4, 3]]
    jeng = JEngine(jparams, JCFG, slots=2, max_len=128, kv_quant_dtype=jnp.float8_e4m3fn, prefill_fn=jl.prefill,
                   decode_fn=jl.decode_step)
    teng = InferenceEngine(model, slots=2, max_len=128, kv_quant_dtype="float8_e4m3fn", prefill_fn=tl.prefill,
                           decode_fn=tl.decode_step, device="cpu")
    assert teng.cache.k.shape == (JCFG.n_layer, JCFG.n_kv_head, 2, 128, JCFG.head_dim)
    for i, p in enumerate(prompts):
        jeng.submit(p, max_new_tokens=4 + i)
        teng.submit(p, max_new_tokens=4 + i)
    want = {r.uid: r.output for r in jeng.run()}
    got = {r.uid: r.output for r in teng.run()}
    assert got == want
    assert teng.stats["prefill_dispatches"] == len(prompts)
    assert got[1][0] == _greedy_ref(model, prompts[0], 1)[0]


def test_engine_max_len_defaults_to_max_seq(model):
    eng = InferenceEngine(model, slots=1, prefill_fn=tl.prefill, decode_fn=tl.decode_step, device="cpu")
    assert eng.max_len == TCFG.max_seq and eng.cache.kv_heads == TCFG.n_kv_head


def test_trainer_on_a_llama_config_matches_jax_trainer():
    """The trainer dispatches on the config's type: from the JAX trainer's
    initial params, the first step's loss within 1e-5 of JAX's, and the
    loss falls over 8 steps in both."""
    shape = dict(vocab_size=64, n_layer=2, n_head=2, n_kv_head=2, n_embd=32, intermediate=64, max_seq=64)
    tkw = dict(max_iters=8, log_interval=1, learning_rate=1e-3, warmup_iters=1)
    jtrainer = JTrainer(jl.LlamaConfig(**shape, dtype=jnp.float32), JTrainerConfig(**tkw), seed=0)
    tcfg = tl.LlamaConfig(**shape, dtype=torch.float32)
    model = tl.params_from_jax(jax.tree.map(np.asarray, jtrainer.params), tcfg, param_dtype=torch.float32,
                               device="cpu")
    trainer = Trainer(tcfg, TrainerConfig(**tkw), model=model)
    idx, tgt = _ids(7, 2, 32), _ids(8, 2, 32)

    def batches(wrap):
        while True:
            yield wrap(idx), wrap(tgt)

    want = [r["train_loss"] for r in jtrainer.fit(batches(jnp.asarray), log=lambda s: None)]
    got = [r["train_loss"] for r in trainer.fit(batches(torch.from_numpy), log=lambda s: None)]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    assert got[-1] < got[0] and want[-1] < want[0]
    fresh = Trainer(tcfg, TrainerConfig(**tkw), seed=0, device="cpu")
    assert isinstance(fresh.model, tl.Llama) and fresh.model.wte.dtype == torch.float32


@pytest.mark.parametrize("bits_", [8, 4])
def test_jax_quantized_params_load_unchanged(tree, bits_):
    """`quantize_llama_params` on the JAX side, loaded through
    params_from_jax: the same payload bytes in QuantizedLinears, and the
    same forward (1e-5); the port's own quantization gives the same
    bytes."""
    jq = jw.quantize_llama_params(jax.tree.map(jnp.asarray, tree), bits=bits_)
    model = tl.params_from_jax(jax.tree.map(np.asarray, jq), TCFG, device="cpu")
    assert isinstance(model.lm_head, tw.QuantizedLinear) and isinstance(model.blocks[0].w_down, tw.QuantizedLinear)
    np.testing.assert_array_equal(bits(model.blocks[1].wk.values), bits(jq["blocks"][1]["wk"].values))
    idx = _ids(9, 1, 32)
    want = jl.forward(jq, jnp.asarray(idx), JCFG)
    got = model(torch.from_numpy(idx))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)
    mine = tw.quantize_llama_params(tl.params_from_jax(tree, TCFG, device="cpu"), bits=bits_)
    np.testing.assert_array_equal(bits(mine.blocks[1].wk.values), bits(jq["blocks"][1]["wk"].values))
    np.testing.assert_array_equal(bits(mine.lm_head.values), bits(jq["lm_head"].values))


def test_quantized_forward_stays_close_to_fp32(model, tree):
    """The JAX test's bounds: int8 within 0.05 and int4 within 1.0 of the
    fp32 logits, finite."""
    idx = torch.from_numpy(_ids(10, 1, 32))
    ref = model(idx)
    for bits_, tol in ((8, 0.05), (4, 1.0)):
        q = tw.quantize_llama_params(tl.params_from_jax(tree, TCFG, device="cpu"), bits=bits_)
        out = q(idx)
        assert torch.isfinite(out).all() and (out - ref).abs().max() < tol, bits_


def test_seq_mesh_and_missing_card_raise(tmp_path):
    """A seq_mesh runs the sequence-parallel forward (before the parallel
    slice it raised NotImplementedError): on a 1-rank gloo group it equals
    the unsharded forward; a length the ring cannot split raises.  Without
    a card the default device raises."""
    import torch.distributed as dist

    from flash_attention_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        mesh = make_mesh(seq=1, device="cpu")
        idx = torch.randint(0, TCFG.vocab_size, (2, 130), generator=torch.Generator().manual_seed(0))
        plain = tl.Llama(TCFG, device="cpu")
        ring = tl.Llama(dataclasses.replace(TCFG, seq_mesh=mesh, seq_zigzag=True), device="cpu")
        with torch.no_grad():
            torch.testing.assert_close(ring(idx), plain(idx), atol=1e-5, rtol=1e-5)
            with pytest.raises(ValueError, match="context-parallel forward needs T % 2 == 0"):
                ring(idx[:, :129])
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.Llama(TCFG)
