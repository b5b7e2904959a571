"""The port's sharded models (`parallel/`): DP/TP and context-parallel
training, tensor-parallel Llama serving and the dry run, on 4 gloo CPU
ranks, against the JAX package on the same numpy inputs and parameters.

The ranks are spawned once for the file (`_torch_ranks.spawn`) and run
every case of `_torch_parallel_cases._model`; each test checks one case.
Where the JAX package's test of the same name runs in its fast lane, the
port is held against the JAX function itself on virtual devices (the dp x
tp steps over its 2 x 4 mesh, TP serving over 4, the dp x cp step over a
2 x 2 data x seq mesh as the port's); where the JAX test is marked slow,
against the unsharded JAX model its own slow test compares with.
Tolerances are the JAX tests' (fp32).

The train steps run as the JAX tests run them, one step from a fresh
optimizer, whose first learning rate is 0 (the schedule warms up from 0):
loss and parameters against the JAX sharded step, and the gradients the
update reads (after the data-parallel average) against jax.grad of the
unsharded loss.  (A step at count 1 would move the weights by AdamW's
first update, m / sqrt(v) = sign(g) up to eps = 1e-8, which turns the last
bits of a gradient near 1e-8 into differences above 1e-5; the gradients
themselves are the well-conditioned check.)
"""

import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_ranks import spawn
from flash_attention_tpu import parallel as jpar
from flash_attention_tpu.inference import init_cache as jinit_cache
from flash_attention_tpu.models import gpt as jgpt
from flash_attention_tpu.models import llama as jllama
from flash_attention_tpu.quant.weights import quantize_llama_params as jquantize_llama
from flash_attention_tpu.training import make_optimizer, make_train_step
from flash_attention_tpu_torch import parallel as tpar
from flash_attention_tpu_torch.models import gpt as tgpt
from flash_attention_tpu_torch.models import llama as tllama
from flash_attention_tpu_torch.parallel.sharding import jax_leaf_name
from flash_attention_tpu_torch.quant.weights import quantize_llama_params as tquantize_llama


def _tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _ints(seed: int, shape, hi: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


GPT_TP = dict(vocab_size=64, block_size=128, n_layer=2, n_head=4, n_embd=64)
LLAMA_TP = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=4, n_embd=32, intermediate=64, max_seq=32)
LLAMA_SERVE = dict(LLAMA_TP, max_seq=64)
CP = dict(vocab_size=64, block_size=256, n_layer=2, n_head=4, n_embd=64)
LLAMA_CP = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, n_embd=64, intermediate=128, max_seq=256)


def _jgpt(**kw):
    return jgpt.GPTConfig(**kw, dropout=0.0, dtype=jnp.float32)


def _jllama(**kw):
    return jllama.LlamaConfig(**kw, dtype=jnp.float32)


INPUTS = {
    "suite": "model",
    "dp_tp": {"cfg": GPT_TP, "params": _tree(jgpt.init_params(jax.random.PRNGKey(0), _jgpt(**GPT_TP))),
              "idx": _ints(1, (4, 128)), "tgt": _ints(2, (4, 128))},
    "llama_dp_tp": {"cfg": LLAMA_TP, "params": _tree(jllama.init_params(jax.random.PRNGKey(0), _jllama(**LLAMA_TP))),
                    "idx": _ints(3, (4, 32)), "tgt": _ints(4, (4, 32))},
    "tp_inference": {"cfg": LLAMA_SERVE,
                     "params": _tree(jllama.init_params(jax.random.PRNGKey(0), _jllama(**LLAMA_SERVE))),
                     "prompt": np.asarray([3, 1, 4, 1, 5], np.int32)},
    "cp": {"cfg": CP, "params": _tree(jgpt.init_params(jax.random.PRNGKey(0), _jgpt(**CP))),
           "idx": _ints(5, (2, 256)), "tgt": _ints(6, (2, 256))},
    "llama_cp": {"cfg": LLAMA_CP, "params": _tree(jllama.init_params(jax.random.PRNGKey(0), _jllama(**LLAMA_CP))),
                 "idx": _ints(7, (2, 256)), "tgt": _ints(8, (2, 256))},
    "dp_cp": {"cfg": CP, "params": _tree(jgpt.init_params(jax.random.PRNGKey(1), _jgpt(**CP))),
              "idx": _ints(9, (4, 256)), "tgt": _ints(10, (4, 256))},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_parallel_cases", 4, tmp_path_factory.mktemp("model_ranks"), INPUTS)


@pytest.fixture(scope="module")
def out(ranks):
    return ranks[0]


def _jax_step(cfg, params, idx, tgt, in_shardings):
    opt = make_optimizer(1e-3, warmup_iters=1, lr_decay_iters=10)
    step = jax.jit(make_train_step(cfg, opt), in_shardings=in_shardings)
    return step(params, opt.init(params), jnp.asarray(idx), jnp.asarray(tgt), jax.random.PRNGKey(3))


def _check_step(got, new, loss, fam, cfg, d, loss_rtol):
    """The port's step (loss, grads, params) against the JAX sharded step
    (new params, loss) and jax.grad of the unsharded loss."""
    got_loss, got_grads, got_params = got
    np.testing.assert_allclose(got_loss, float(loss), rtol=loss_rtol)
    _close_trees(got_params, new, atol=1e-5, rtol=1e-5)
    params = jax.tree.map(jnp.asarray, d["params"])
    grads = jax.grad(fam.loss_fn)(params, jnp.asarray(d["idx"]), jnp.asarray(d["tgt"]), cfg)
    _close_trees(got_grads, grads, atol=2e-4, rtol=2e-3)


def _close_trees(got, want, atol, rtol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = jax.tree.leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol, err_msg=jax.tree_util.keystr(path))


def test_dp_tp_train_step(out):
    """A dp x tp step (DTensor parameters by the GPT rules, the batch's rows
    over data): loss and updated parameters equal the JAX package's step
    sharded over its 2 x 4 mesh."""
    d = INPUTS["dp_tp"]
    cfg = _jgpt(**GPT_TP)
    mesh = jpar.make_mesh(data=2, model=4)
    params = jax.tree.map(jnp.asarray, d["params"])
    b = NamedSharding(mesh, P("data"))
    p_shard = jpar.gpt_param_sharding(mesh, params)
    new, _, loss = _jax_step(cfg, params, d["idx"], d["tgt"], (p_shard, None, b, b, None))
    _check_step(out["dp_tp"][:3], new, loss, jgpt, cfg, d, 1e-6)
    wqkv_local, opt = out["dp_tp"][3:]
    assert wqkv_local == (3 * 64 // 2, 64) and opt == "AdamW"


def test_tp_wqkv_shard_is_a_head_group(ranks):
    """Placed over the model axis, the fused wqkv (and its bias) is laid
    out part-major by shard: each model rank's local rows are the q, k and
    v rows of its own heads, so the layer needs no collective of its own,
    and `whole` restores the unsharded layout."""
    assert [r["wqkv_head_group"] for r in ranks] == [(True, True, True, True)] * 4


def test_llama_dp_tp_train_step(out):
    """Llama trains sharded by the same Megatron rules as TP serving."""
    d = INPUTS["llama_dp_tp"]
    cfg = _jllama(**LLAMA_TP)
    mesh = jpar.make_mesh(data=2, model=4)
    params = jax.tree.map(jnp.asarray, d["params"])
    p_shard = jax.tree.map(lambda s: NamedSharding(mesh, s), jpar.llama_param_specs(params),
                           is_leaf=lambda x: isinstance(x, P))
    b = NamedSharding(mesh, P("data"))
    new, _, loss = _jax_step(cfg, params, d["idx"], d["tgt"], (p_shard, None, b, b, None))
    _check_step(out["llama_dp_tp"][:3], new, loss, jllama, cfg, d, 1e-5)
    wq_local = out["llama_dp_tp"][3]
    assert wq_local == (32 // 2, 32)


def test_tp_inference_matches_single_device(out):
    """4-way TP Llama serving: the JAX package's TP prefill/decode tokens,
    with the cache's local shard holding n_kv_head / 4 heads after the
    calls."""
    d = INPUTS["tp_inference"]
    cfg = _jllama(**LLAMA_SERVE)
    params = jax.tree.map(jnp.asarray, d["params"])
    mesh = jpar.make_mesh(model=4)
    cache = jinit_cache(cfg.n_layer, 2, cfg.n_kv_head, cfg.max_seq, cfg.head_dim, dtype=cfg.dtype)
    pp, cc = jpar.shard_llama_for_inference(params, cache, mesh)
    prompt = jnp.asarray(d["prompt"])
    cc, logits = jpar.tp_prefill(pp, prompt, cfg, cc, jnp.int32(0), mesh)
    cc, _ = jpar.tp_prefill(pp, prompt, cfg, cc, jnp.int32(1), mesh)
    first = jnp.full((2,), int(jnp.argmax(logits)), jnp.int32)
    _, toks = jpar.tp_decode_loop(pp, cfg, cc, first, 6, mesh)
    got_logits, got_toks, local, lengths = out["tp_inference"]
    np.testing.assert_allclose(got_logits, np.asarray(logits), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_toks, np.asarray(toks))
    assert local == (cfg.n_layer, cfg.n_kv_head // 4, 2, cfg.max_seq, cfg.head_dim)
    assert lengths == (11, 11)


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_inference_quantized_weights(out, bits):
    """Weight-only int8/int4 Llama served 4-way TP (payloads and scales
    sharded with their weights; int4 column-parallel payloads re-packed per
    shard): logits and greedy tokens of the unsharded quantized model."""
    ref_logits, ref_toks, logits, toks = out[f"tp_quant{bits}"]
    np.testing.assert_allclose(logits, ref_logits, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(toks, ref_toks)


def test_tp_inference_rejects_indivisible_heads(out):
    cfg = _jllama(vocab_size=64, n_layer=1, n_head=3, n_kv_head=3, n_embd=24, intermediate=48, max_seq=64)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    with pytest.raises(ValueError) as e:
        jpar.shard_llama_for_inference(params, jinit_cache(1, 1, 3, 64, cfg.head_dim, dtype=cfg.dtype),
                                       jpar.make_mesh(model=4))
    assert out["tp_rejects"] == f"ValueError: {e.value}"


def _unsharded(fam, cfg, d):
    params = jax.tree.map(jnp.asarray, d["params"])
    idx, tgt = jnp.asarray(d["idx"]), jnp.asarray(d["tgt"])
    loss, grads = jax.value_and_grad(fam.loss_fn)(params, idx, tgt, cfg)
    return fam.forward(params, idx, cfg), loss, grads


def _check_model(got, want):
    logits, loss, grads = want
    np.testing.assert_allclose(got["logits"], np.asarray(logits), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    _close_trees(got["grads"], grads, atol=2e-4, rtol=2e-3)


def test_gpt_ring_model_forward_and_grad_parity(out):
    """GPT with a seq mesh (ring attention inside, contiguous shards):
    logits, loss and every parameter gradient equal the unsharded JAX
    model's."""
    _check_model(out["gpt_cp_False"], _unsharded(jgpt, _jgpt(**CP), INPUTS["cp"]))


def test_gpt_ring_model_zigzag_parity(out):
    """Zig-zag: tokens and positions taken in zig-zag order once, the
    logits gathered back into natural order."""
    _check_model(out["gpt_cp_True"], _unsharded(jgpt, _jgpt(**CP), INPUTS["cp"]))


def test_llama_ring_model_parity(out):
    """Llama (RoPE at each shard's global positions, GQA 4/2) with ring
    attention inside."""
    _check_model(out["llama_cp_False"], _unsharded(jllama, _jllama(**LLAMA_CP), INPUTS["llama_cp"]))


def test_llama_with_seq_mesh_runs_zigzag(out):
    """A Llama config with a seq mesh runs (the port raised before),
    zig-zag included: RoPE at the zig-zag positions."""
    _check_model(out["llama_cp_True"], _unsharded(jllama, _jllama(**LLAMA_CP), INPUTS["llama_cp"]))


def test_dp_cp_train_step(out):
    """Context-parallel training on a data x seq mesh (rows over data,
    zig-zag tokens over seq, ring attention inside the model): loss and
    updated parameters equal the JAX package's sharded step's."""
    d = INPUTS["dp_cp"]
    base = _jgpt(**CP)
    mesh = jpar.make_mesh(data=2, seq=2)
    cfg = dataclasses.replace(base, seq_mesh=mesh, seq_batch_axis="data")
    b = jpar.seq_batch_sharding(mesh)
    new, _, loss = _jax_step(cfg, jax.tree.map(jnp.asarray, d["params"]), d["idx"], d["tgt"], (None, None, b, b, None))
    _check_step(out["dp_cp"], new, loss, jgpt, base, d, 1e-6)


def test_demo_cp_under_torchrun(tmp_path):
    """The demo's --cp --cp-zigzag on 2 gloo ranks under torchrun: both
    ranks train, rank 0 writes the history and the checkpoints; --cp must
    divide block_size, with the JAX demo's message."""
    import subprocess
    import sys

    from flash_attention_tpu_torch.demo import train as tdemo

    with pytest.raises(SystemExit, match="--cp 3 must divide block_size"):
        tdemo.train(cp=3, block_size=128, device="cpu")
    args = ["--cp", "2", "--cp-zigzag", "--device", "cpu", "--max-iters", "2", "--n-layer", "1", "--n-head", "2",
            "--n-embd", "32", "--block-size", "64", "--batch-size", "2", "--eval-iters", "1", "--checkpoint-every",
            "1", "--out-dir", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                          "-m", "flash_attention_tpu_torch.demo.train", *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert run.stdout.count("context parallel: sequence sharded over 2 devices (zigzag)") == 2
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history) == 2 and all(np.isfinite(r["train_loss"]) for r in history)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_1", "step_2"]


def test_dryrun_entrypoint():
    """The dry run's four checks on 4 gloo ranks."""
    from flash_attention_tpu_torch.parallel.dryrun import dryrun_train_step

    dryrun_train_step(4)


def _jax_specs(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(path): tuple(s) for path, s in leaves}


def test_gpt_param_specs_are_the_jax_specs_transposed():
    """Leaf by leaf: a linear weight's spec is the JAX spec reversed ([out,
    in] against [in, out]); biases, embeddings and norms keep it."""
    cfg = _jgpt(**GPT_TP)
    want = _jax_specs(jpar.gpt_param_specs(jgpt.init_params(jax.random.PRNGKey(0), cfg)))
    model = tgpt.GPT(tgpt.GPTConfig(**GPT_TP, dtype=torch.float32), device="cpu")
    got = tpar.gpt_param_specs(model)
    assert len(got) == len(want)
    for name, spec in got.items():
        parts = name.split(".")
        leaf, transposed = jax_leaf_name(name)
        path = (parts[:-2] if parts[-1] in ("weight", "bias") else parts[:-1]) + [leaf]
        key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path)
        assert spec == (tuple(reversed(want[key])) if transposed else want[key]), name
    assert got["blocks.0.attn.wqkv.weight"] == ("model", None) and got["blocks.0.attn.wo.weight"] == (None, "model")


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_llama_param_specs_are_the_jax_specs(bits):
    """Dense weights transposed; quantized payloads and scales (kept [in,
    out] in both packages) follow their weight's orientation unchanged."""
    cfg = _jllama(**LLAMA_TP)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    model = tllama.Llama(tllama.LlamaConfig(**LLAMA_TP, dtype=torch.float32), device="cpu")
    if bits is not None:
        params = jquantize_llama(params, bits=bits)
        tquantize_llama(model, bits=bits)
    want = _jax_specs(jpar.llama_param_specs(params))
    got = tpar.llama_param_specs(model)
    assert len(got) == len(want)
    for name, spec in got.items():
        parts = name.split(".")
        sub = {"values": "[<flat index 0>]", "scales": "[<flat index 1>]"}.get(parts[-1])
        path = parts[:-1] if parts[-1] in ("weight", "values", "scales") else parts
        key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path) + (sub or "")
        assert spec == (tuple(reversed(want[key])) if parts[-1] == "weight" else want[key]), name
