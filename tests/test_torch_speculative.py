"""Speculative decoding and the engine's scan options: `kv_cache.multi_write`
and `model_runner.verify_step` against the JAX package's,
`speculative_decode_loop` against JAX's (tokens, counts, both caches'
lengths) and against greedy `decode_loop`, `gather_tokens`, and the engine
with a `draft_model` against the JAX engine with `draft_params` (greedy
outputs and every stat the JAX engine keeps) in each case of the JAX
package's speculative tests: mixed greedy/sampled batches, chunked
prefill, the adaptive retreat, its trials, backoff and fast retreat; then
`scan_tokens_target` and `pipeline_scans` against the JAX engine.  Greedy
equality is held at fp32 on weights scaled so that top-2 logit gaps are
wide; bf16 is checked for budgets, id ranges and stats only."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import JAX_CFG, TORCH_CFG, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.inference import engine as jengine
from flash_attention_tpu.inference import kv_cache as jkv
from flash_attention_tpu.inference import model_runner as jmr
from flash_attention_tpu.inference import speculative as jspec
from flash_attention_tpu.models import gpt as jgpt
from flash_attention_tpu_torch.inference import engine as tengine
from flash_attention_tpu_torch.inference import kv_cache as tkv
from flash_attention_tpu_torch.inference import model_runner as tmr
from flash_attention_tpu_torch.inference import speculative as tspec
from flash_attention_tpu_torch.models import gpt as tgpt

MAX_LEN = 256
J_DRAFT = jgpt.GPTConfig(vocab_size=64, block_size=256, n_layer=1, n_head=2, n_embd=32, dropout=0.0,
                         dtype=jnp.float32)
T_DRAFT = tgpt.GPTConfig(vocab_size=64, block_size=256, n_layer=1, n_head=2, n_embd=32, dtype=torch.float32)
J_GQA = dataclasses.replace(JAX_CFG, n_kv_head=2)
T_GQA = dataclasses.replace(TORCH_CFG, n_kv_head=2)
J_GQA_DRAFT = dataclasses.replace(J_DRAFT, n_head=4, n_kv_head=1)
T_GQA_DRAFT = dataclasses.replace(T_DRAFT, n_head=4, n_kv_head=1)
# stats the port keeps beside the JAX engine's
PORT_ONLY_STATS = {"prefill_dispatches", "draft_dispatches", "decode_scans"}


def _pair(jcfg, tcfg, seed: int, scale: float = 25.0):
    """(JAX params, port GPT) on the same numpy weights, scaled so that
    greedy top-2 gaps sit far above fp32 rounding."""
    tree = numpy_params(seed=seed, scale=scale, cfg=jcfg)
    return jax_tree(tree), tgpt.params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(JAX_CFG, TORCH_CFG, seed=1)


@pytest.fixture(scope="module")
def draft():
    return _pair(J_DRAFT, T_DRAFT, seed=9)


def _caches(jcfg, slots: int, quant=None, max_len: int = MAX_LEN):
    args = (jcfg.n_layer, slots, jcfg.kv_heads, max_len, jcfg.head_dim)
    jq, tq = {None: (None, None), "int8": (jnp.int8, torch.int8)}[quant]
    return (jkv.init_cache(*args, dtype=jnp.float32, quant_dtype=jq),
            tkv.init_cache(*args, dtype=torch.float32, quant_dtype=tq, device="cpu"))


def _cache_values(c, slot: int, rows: int) -> list[np.ndarray]:
    """A slot's first rows of every cache tensor, payloads as fp32."""
    out = [np.asarray(n(c.k) if isinstance(c.k, torch.Tensor) else c.k).astype(np.float32),
           np.asarray(n(c.v) if isinstance(c.v, torch.Tensor) else c.v).astype(np.float32)]
    if c.k_scale is not None:
        out += [np.asarray(n(x) if isinstance(x, torch.Tensor) else x) for x in (c.k_scale, c.v_scale)]
    return [a[:, :, slot, :rows] for a in out]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_multi_write_matches_jax(quant):
    """Four rows per slot at ragged positions, one slot's clipped at the
    capacity so that its last rows repeat one index: every row below the
    lengths equal (payloads bit for bit), in place."""
    jc, tc = _caches(JAX_CFG, 3, quant, max_len=16)
    tensors = (tc.k, tc.v)
    h, d = JAX_CFG.kv_heads, JAX_CFG.head_dim
    k, v = randn(0, 3, 4, h, d), randn(1, 3, 4, h, d) * 2.0
    pos = np.minimum(np.array([[0], [6], [13]]) + np.arange(4)[None], 15).astype(np.int32)
    jc = jkv.multi_write(jc, 1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tkv.multi_write(tc, 1, t(k), t(v), t(pos))
    assert tc.k is tensors[0] and tc.v is tensors[1]
    for slot, rows in enumerate((4, 10, 15)):  # slot 2's index 15 is written twice
        for got, want in zip(_cache_values(tc, slot, rows), _cache_values(jc, slot, rows)):
            np.testing.assert_array_equal(got, want)
    assert float(tc.k[1, :, 2, 15].abs().sum()) > 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_verify_step_matches_jax(quant):
    """Three slots at lengths 9, 4 and 253 of 256 score four rows each:
    logits [S, C, vocab] (fp32 1e-5, int8 cache 1e-2) except the rows of
    slot 2 that see its index 255, written twice; the cache's rows below
    the lengths plus the four new ones; lengths not advanced.  GPT-2's
    init, unscaled."""
    jp, tm = _pair(JAX_CFG, TORCH_CFG, seed=0, scale=1.0)
    jc, tc = _caches(JAX_CFG, 3, quant)
    rng = np.random.default_rng(3)
    for slot, m in enumerate((9, 4, 9)):
        prompt = rng.integers(0, 64, m).astype(np.int32)
        jc, _ = jmr.prefill(jp, jnp.asarray(prompt), JAX_CFG, jc, jnp.int32(slot))
        tmr.prefill(tm, t(prompt), tc, slot)
    jc = jkv.set_length(jc, jnp.int32(2), 253)
    tkv.set_length(tc, 2, 253)
    toks = rng.integers(0, 64, (3, 4)).astype(np.int32)
    jc, jlog = jmr.verify_step(jp, jnp.asarray(toks), JAX_CFG, jc)
    tc, tlog = tmr.verify_step(tm, t(toks), tc)
    assert tlog.shape == (3, 4, 64) and tlog.dtype == torch.float32
    atol = 1e-5 if quant is None else 1e-2
    np.testing.assert_allclose(n(tlog)[:2], np.asarray(jlog)[:2], atol=atol, rtol=0)
    np.testing.assert_allclose(n(tlog)[2, :2], np.asarray(jlog)[2, :2], atol=atol, rtol=0)
    assert n(tc.lengths).tolist() == [9, 4, 253] == np.asarray(jc.lengths).tolist()
    for slot, rows in enumerate((13, 8, 255)):
        for got, want in zip(_cache_values(tc, slot, rows), _cache_values(jc, slot, rows)):
            np.testing.assert_allclose(got, want, atol=1e-5 if quant is None else 0, rtol=1e-6)


SPEC_CASES = {
    "self_draft": dict(quant=None, gqa=False, self_draft=True),
    "draft_1_layer": dict(quant=None, gqa=False, self_draft=False),
    "int8_target": dict(quant="int8", gqa=False, self_draft=False),
    "gqa": dict(quant=None, gqa=True, self_draft=False),
}


@pytest.mark.parametrize("case", SPEC_CASES)
def test_speculative_loop_matches_jax_and_greedy_decode(case, target, draft):
    """12 iterations of window 3 on two slots: tokens [12, 2, 4], counts
    and both caches' lengths equal JAX's; each slot's emitted tokens equal
    the port's greedy decode_loop on the same kind of cache; a self-draft
    accepts every proposal."""
    spec = SPEC_CASES[case]
    if spec["gqa"]:
        (jp, tm), (dp, dm) = _pair(J_GQA, T_GQA, seed=3), _pair(J_GQA_DRAFT, T_GQA_DRAFT, seed=4)
        jcfg, jdcfg = J_GQA, J_GQA_DRAFT
    else:
        (jp, tm), (dp, dm) = target, (target if spec["self_draft"] else draft)
        jcfg, jdcfg = JAX_CFG, (JAX_CFG if spec["self_draft"] else J_DRAFT)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    k, iters = 3, 12

    def prefill_both():
        jct, tct = _caches(jcfg, 2, spec["quant"])
        jcd, tcd = _caches(jdcfg, 2)
        firsts = []
        for slot, p in enumerate(prompts):
            jct, _ = jmr.prefill(jp, jnp.asarray(p, jnp.int32), jcfg, jct, jnp.int32(slot))
            jcd, _ = jmr.prefill(dp, jnp.asarray(p, jnp.int32), jdcfg, jcd, jnp.int32(slot))
            _, logits = tmr.prefill(tm, t(np.array(p)), tct, slot)
            tmr.prefill(dm, t(np.array(p)), tcd, slot)
            firsts.append(int(torch.argmax(logits)))
        return jct, tct, jcd, tcd, np.array(firsts, np.int32)

    jct, tct, jcd, tcd, first = prefill_both()
    jct, jcd, jtoks, jcounts = jspec.speculative_decode_loop(jp, jcfg, jct, dp, jdcfg, jcd, jnp.asarray(first),
                                                             n_iters=iters, k=k)
    tct, tcd, ttoks, tcounts = tspec.speculative_decode_loop(tm, tct, dm, tcd, t(first), n_iters=iters, k=k)
    assert ttoks.shape == (iters, 2, k + 1) and ttoks.dtype == torch.int32
    np.testing.assert_array_equal(n(ttoks), np.asarray(jtoks))
    np.testing.assert_array_equal(n(tcounts), np.asarray(jcounts))
    np.testing.assert_array_equal(n(tct.lengths), np.asarray(jct.lengths))
    np.testing.assert_array_equal(n(tcd.lengths), np.asarray(jcd.lengths))
    _, ref_cache, _, _, _ = prefill_both()
    _, ref = tmr.decode_loop(tm, ref_cache, t(first), iters)
    for slot in range(2):
        assert tspec.gather_tokens(ttoks, tcounts, slot, limit=iters) == n(ref[:, slot]).tolist()
    if spec["self_draft"]:
        assert int(tcounts.min()) == k + 1
    else:
        assert int(tcounts.min()) < k + 1  # a rejection and its rollback ran


def test_speculative_loop_masks_inactive_slots(target, draft):
    """An inactive slot's lengths stay; its rows below the length are
    untouched in both caches."""
    jp, tm = target
    _, dm = draft
    _, tct = _caches(JAX_CFG, 2)
    _, tcd = _caches(J_DRAFT, 2)
    for slot, p in enumerate(([3, 1, 4, 1, 5], [9, 2, 6])):
        tmr.prefill(tm, t(np.array(p)), tct, slot)
        tmr.prefill(dm, t(np.array(p)), tcd, slot)
    before = [x.clone() for x in (tct.k[:, :, 1, :3], tcd.k[:, :, 1, :3])]
    tspec.speculative_decode_loop(tm, tct, dm, tcd, t(np.array([1, 2], np.int32)), n_iters=3, k=3,
                                  active=torch.tensor([True, False]))
    assert n(tct.lengths)[1] == n(tcd.lengths)[1] == 3 and n(tct.lengths)[0] > 5
    assert torch.equal(tct.k[:, :, 1, :3], before[0]) and torch.equal(tcd.k[:, :, 1, :3], before[1])


def test_speculative_rejects_short_draft_cache(target):
    _, tm = target
    _, tct = _caches(JAX_CFG, 1)
    _, tcd = _caches(JAX_CFG, 1, max_len=128)
    with pytest.raises(ValueError, match="draft cache max_len"):
        tspec.speculative_decode_loop(tm, tct, tm, tcd, torch.tensor([1], dtype=torch.int32), 2)


def test_gather_tokens_matches_jax():
    toks = np.array([[[5, 6, -1], [1, -1, -1]], [[7, -1, -1], [2, 3, 4]]], np.int32)
    counts = np.array([[2, 1], [1, 3]], np.int32)
    for slot in (0, 1):
        for limit in (None, 2):
            want = jspec.gather_tokens(toks, counts, slot, limit)
            assert tspec.gather_tokens(toks, counts, slot, limit) == want
            assert tspec.gather_tokens(t(toks), t(counts), slot, limit) == want
    assert tspec.gather_tokens(toks, counts, 1) == [1, 2, 3, 4]
    assert tspec.PAD == jspec.PAD == -1


# ------------------------------------------------------------------ engine

P3 = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8]]
P2 = P3[:2]
SAMPLED = dict(temperature=0.9, top_k=8)
# name: (engine options, requests (prompt, budget, sampling), max_len,
# scan_steps); "draft" names the draft: the 1-layer DRAFT, the target
# itself, or a bad draft of the target's shape that becomes the target
# once the retreat lands.  From the JAX package's speculative tests.
ENGINE_CASES = {
    "draft": (dict(), [(p, 7, {}) for p in P3], 256, 8),
    "sampled_only": (dict(), [([1, 2, 3], 6, dict(temperature=0.8, top_k=4))], 256, 4),
    "mixed_batch": (dict(), [([3, 1, 4, 1, 5, 9], 20, {}), ([7, 7, 7], 12, SAMPLED)], 256, 4),
    "chunked_prefill": (dict(chunk_prefill=8), [(list(range(1, 20)), 6, {}), ([5, 4, 3], 6, {})], 64, 8),
    "retreat": (dict(spec_adaptive=True, spec_min_accept=3.9), [(p, 24, {}) for p in P2], 256, 8),
    "retreat_resumes_pipelining": (dict(spec_adaptive=True, spec_min_accept=3.9, pipeline_scans=True),
                                   [(p, 40, {}) for p in P2], 256, 8),
    "good_draft_kept": (dict(draft="self", spec_adaptive=True), [(P3[0], 24, {})], 256, 8),
    "retrial_reopens": (dict(draft="recovers", spec_adaptive=True, spec_min_accept=3.9, spec_reopen_margin=0.0,
                             spec_retrial_every=2), [(P3[0], 96, {})], 256, 4),
    "retrial_backoff": (dict(spec_adaptive=True, spec_min_accept=3.9, spec_retrial_every=2), [(P3[0], 120, {})],
                        256, 4),
    "catastrophic_retreat": (dict(spec_adaptive=True, spec_min_accept=8.0, spec_retrial_every=0),
                             [(p, 24, {}) for p in P2], 256, 8),
}


def _engine_run(eng, requests, swap=None):
    """Submit, run, return {uid: output}.  swap(eng): the draft to install
    the moment the retreat lands (the trial test's recovering draft)."""
    swapped = []

    def on_token(req, tok):
        if swap is not None and not eng._spec_enabled and not swapped:
            swap(eng)
            swapped.append(True)

    for prompt, budget, kw in requests:
        eng.submit(prompt, max_new_tokens=budget, on_token=on_token, **kw)
    return {r.uid: r.output for r in eng.run()}


def _jax_vs_port(case, target, draft):
    """Run one case of ENGINE_CASES's form through both engines: (JAX
    engine, port engine, JAX outputs, port outputs)."""
    (jp, tm), (dp, dm) = target, draft
    opts, requests, max_len, scan = case
    opts = dict(opts)
    which = opts.pop("draft", "draft")
    pipeline = opts.pop("pipeline_scans", False)
    kw = dict(slots=2, max_len=max_len, scan_steps=scan, spec_k=3, **opts)
    if which == "self":
        jd, td = dict(draft_params=jp, draft_cfg=JAX_CFG), dict(draft_model=tm)
    elif which == "recovers":
        jbad, tbad = _pair(JAX_CFG, TORCH_CFG, seed=9)
        jd, td = dict(draft_params=jbad, draft_cfg=JAX_CFG), dict(draft_model=tbad)
    else:
        jd, td = dict(draft_params=dp, draft_cfg=J_DRAFT), dict(draft_model=dm)
    jeng = jengine.InferenceEngine(jp, JAX_CFG, pipeline_scans=pipeline, **jd, **kw)
    teng = tengine.InferenceEngine(tm, pipeline_scans=pipeline, device="cpu", **td, **kw)
    swap = {"recovers": (lambda e: setattr(e, "draft_params", jp), lambda e: setattr(e, "draft_model", tm))}
    jswap, tswap = swap.get(which, (None, None))
    want = _engine_run(jeng, requests, jswap)
    got = _engine_run(teng, requests, tswap)
    return jeng, teng, want, got


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_engine_with_draft_matches_jax_engine(name, target, draft):
    """The port's engine with draft_model against the JAX engine with
    draft_params: every greedy request's output, every sampled request's
    length and every stat of the JAX engine equal (the port adds
    PORT_ONLY_STATS); greedy outputs also equal the plain engine's."""
    jeng, teng, want, got = _jax_vs_port(ENGINE_CASES[name], target, draft)
    requests = ENGINE_CASES[name][1]
    for uid, (_, _, kw) in enumerate(requests, start=1):
        assert len(got[uid]) == len(want[uid])
        if not kw:
            assert got[uid] == want[uid], uid
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats
    assert set(teng.stats) - set(jeng.stats) <= PORT_ONLY_STATS
    assert teng._spec_enabled == jeng._spec_enabled
    assert teng._spec_retrial_interval == jeng._spec_retrial_interval
    _, tm = target
    plain = tengine.InferenceEngine(tm, slots=2, max_len=ENGINE_CASES[name][2], scan_steps=ENGINE_CASES[name][3],
                                    device="cpu")
    plain_out = _engine_run(plain, requests)
    for uid, (_, _, kw) in enumerate(requests, start=1):
        if not kw:
            assert got[uid] == plain_out[uid], uid
    # what each JAX test pins, on the port's stats
    stats = teng.stats
    if name == "sampled_only":
        assert "spec_rounds" not in stats
    if name == "mixed_batch":
        assert stats["spec_rounds"] >= 3 and "draft_resyncs" not in stats
    if name in ("retreat", "catastrophic_retreat"):
        assert stats["spec_rounds"] == stats["spec_disabled_at_round"]
    if name == "catastrophic_retreat":
        assert stats["spec_disabled_at_round"] == 1
    if name == "retreat_resumes_pipelining":
        assert stats["pipelined_scans"] > 0 and "spec_disabled_at_round" in stats
    if name == "good_draft_kept":
        assert "spec_disabled_at_round" not in stats and stats["spec_accept_ema"] > 3.0
    if name == "retrial_reopens":
        assert stats["spec_trials"] >= 1 and stats["spec_rounds"] > stats["spec_reopened_at_round"]
        assert teng._spec_enabled
    if name == "retrial_backoff":
        assert stats["spec_trials"] >= 2 and "spec_reopened_at_round" not in stats and not teng._spec_enabled
        assert teng._spec_retrial_interval >= 2 * 2 ** (stats["spec_trials"] - 1)


def test_engine_retreat_in_a_mixed_batch_keeps_greedy_outputs(target, draft):
    """A greedy and a sampled request share the batch when the adaptive
    guard retreats: the next regular scan decodes both slots.  The port
    rebuilds the scan's slot mask when the slots it decodes change, so the
    greedy output equals the plain engine's.  The JAX engine keeps the mask
    of its sampled-only scans (`_slot_cfg` is reset only when the running
    set changes, engine.py:926), so its greedy slot decodes masked, with
    its cache length frozen, and its output departs from the plain
    engine's (a defect of the reference, pinned here); the stats agree."""
    requests = ENGINE_CASES["mixed_batch"][1]
    jeng, teng, want, got = _jax_vs_port((dict(spec_adaptive=True, spec_min_accept=3.9), requests, 256, 4), target,
                                         draft)
    jp, tm = target
    plain = _engine_run(tengine.InferenceEngine(tm, slots=2, max_len=256, scan_steps=4, device="cpu"), requests)
    jplain = _engine_run(jengine.InferenceEngine(jp, JAX_CFG, slots=2, max_len=256, scan_steps=4,
                                                 pipeline_scans=False), requests)
    assert teng.stats["spec_disabled_at_round"] == 1
    assert got[1] == plain[1] == jplain[1]
    assert want[1] != jplain[1]
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats


def test_engine_no_draft_prefills_after_retreat(target, draft):
    """After a permanent retreat, admissions skip the draft prefill and no
    trial runs; stats equal the JAX engine's."""
    (jp, tm), (dp, dm) = target, draft
    kw = dict(slots=2, max_len=256, scan_steps=4, spec_k=3, spec_adaptive=True, spec_min_accept=3.9,
              spec_retrial_every=0)
    jeng = jengine.InferenceEngine(jp, JAX_CFG, draft_params=dp, draft_cfg=J_DRAFT, pipeline_scans=False, **kw)
    teng = tengine.InferenceEngine(tm, draft_model=dm, device="cpu", **kw)
    for eng in (jeng, teng):
        _engine_run(eng, [(P3[0], 40, {})])
        assert "spec_disabled_at_round" in eng.stats
    before = teng.stats["draft_prefills"]
    want = _engine_run(jeng, [([9, 2, 6], 8, {})] * 3)
    assert _engine_run(teng, [([9, 2, 6], 8, {})] * 3) == want
    assert teng.stats["draft_prefills"] == before and "spec_trials" not in teng.stats
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats


def test_engine_draft_options_are_checked(target, draft):
    _, tm = target
    _, dm = draft
    eng = tengine.InferenceEngine(tm, draft_model=dm, device="cpu")
    assert eng.spec_min_accept == pytest.approx(3.0) and eng.spec_reopen_margin == pytest.approx(0.5)
    assert eng.draft_cache.k.shape == (1, 2, 8, 256, 16) and eng.draft_cache.k.dtype == torch.float32
    assert not eng.draft_cache.quantized
    assert not tengine.InferenceEngine(tm, draft_model=dm, kv_quant_dtype="int8", device="cpu").draft_cache.quantized
    for bad in (dict(prefill_fn=tmr.prefill), dict(decode_fn=tmr.decode_step)):
        with pytest.raises(ValueError, match="GPT path only"):
            tengine.InferenceEngine(tm, draft_model=dm, device="cpu", **bad)


def test_engine_bf16_speculation_meets_budgets():
    """bf16 target and draft (greedy equality is fp32's, see speculative.py):
    exact budgets, ids in range, one spec round or more, and counts within
    [1, k + 1] a round."""
    cfg = dataclasses.replace(TORCH_CFG, dtype=torch.bfloat16)
    tm = tgpt.GPT(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    eng = tengine.InferenceEngine(tm, slots=2, max_len=128, draft_model=tm, spec_k=3, device="cpu")
    for p, b in (([1, 2, 3], 9), ([4, 5], 13), ([6], 5)):
        eng.submit(p, max_new_tokens=b)
    done = eng.run()
    assert sorted(len(r.output) for r in done) == [5, 9, 13]
    assert all(0 <= tok < cfg.vocab_size for r in done for tok in r.output)
    rounds = eng.stats["spec_rounds"]
    assert rounds >= 1 and eng.stats["decode_steps"] == rounds * eng._n_spec_iters * 4


# ------------------------------------------------- scan length and pipelining

SCAN_CASES = {
    "pipelined": dict(pipeline_scans=True),
    "tokens_target": dict(scan_tokens_target=4),
    "pipelined_tokens_target": dict(pipeline_scans=True, scan_tokens_target=4),
}


@pytest.mark.parametrize("name", SCAN_CASES)
def test_scan_options_match_jax_engine(name, target):
    """scan_tokens_target and pipeline_scans against the JAX engine with
    the same settings (more requests than slots, one finishing on its first
    token): outputs, decode_steps and pipelined_scans equal; outputs equal
    the port's default engine's."""
    jp, tm = target
    rng = np.random.default_rng(7)
    requests = [(rng.integers(0, 64, m).tolist(), b, {}) for m, b in ((5, 6), (70, 9), (30, 1), (12, 17), (9, 3))]
    kw = dict(slots=2, max_len=MAX_LEN, scan_steps=8, **SCAN_CASES[name])
    kw.setdefault("pipeline_scans", False)
    jeng = jengine.InferenceEngine(jp, JAX_CFG, **kw)
    teng = tengine.InferenceEngine(tm, device="cpu", **kw)
    want = _engine_run(jeng, requests)
    got = _engine_run(teng, requests)
    assert got == want
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats
    assert teng.stats.get("pipelined_scans", 0) == (teng.stats["decode_scans"] if kw["pipeline_scans"] else 0)
    assert got == _engine_run(tengine.InferenceEngine(tm, slots=2, max_len=MAX_LEN, scan_steps=8, device="cpu"),
                              requests)
