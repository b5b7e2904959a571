"""Training slice: the port's loss and gradients, dropout and remat,
optimizer, schedule, gradient accumulation, trainer, checkpoints, data and
demo, each against the JAX package on the same numpy inputs where JAX has
a counterpart.  Small fp32 models; the JAX side runs its Pallas kernels in
interpret mode, as its own tests do."""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from _torch_port import JAX_CFG, TORCH_CFG, jax_tree, n, numpy_params, randn, t
from flash_attention_tpu.data import loader as jloader
from flash_attention_tpu.models import gpt as jgpt
from flash_attention_tpu.training import Trainer as JTrainer
from flash_attention_tpu.training import TrainerConfig as JTrainerConfig
from flash_attention_tpu.training import optimizer as joptim
from flash_attention_tpu_torch.data import loader as tloader
from flash_attention_tpu_torch.demo import train as tdemo
from flash_attention_tpu_torch.models import gpt as tgpt
from flash_attention_tpu_torch.training import (
    MetricsLogger,
    Trainer,
    TrainerConfig,
    cosine_schedule,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_demo():
    """The JAX package's demo/train.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_demo_train", REPO / "demo" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- model: loss and gradients against JAX ---------------------------------


@pytest.mark.parametrize("variant", ["flash", "dense", "gqa"])
def test_loss_and_grads_match_jax(variant):
    """gpt.loss_fn's value (1e-5) and every parameter gradient (1e-4)
    against jax.value_and_grad(gpt.loss_fn); T = 160 takes the flash path
    (>= MIN_BLOCK) in both packages.  GQA: 4 query heads over 2 KV heads,
    whose dK/dV sum over the group."""
    extra = {"flash": {}, "dense": {"use_flash": False}, "gqa": {"n_kv_head": 2}}[variant]
    jcfg = dataclasses.replace(JAX_CFG, **extra)
    tcfg = dataclasses.replace(TORCH_CFG, **extra)
    tree = numpy_params(seed=0, scale=4.0, cfg=jcfg)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jcfg.vocab_size, (2, 160)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (2, 160)).astype(np.int32)
    want_loss, want = jax.value_and_grad(lambda p: jgpt.loss_fn(p, jnp.asarray(idx), jnp.asarray(tgt), jcfg))(
        jax_tree(tree)
    )
    model = tgpt.params_from_jax(tree, tcfg, param_dtype=torch.float32, device="cpu")
    loss = tgpt.loss_fn(model, t(idx).long(), t(tgt).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=0)
    got = tgpt.grads_to_jax_layout(model)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_params_from_jax_keeps_fp32_master_weights():
    tree = numpy_params(seed=2)
    bf = dataclasses.replace(TORCH_CFG, dtype=torch.bfloat16)
    model = tgpt.params_from_jax(tree, bf, param_dtype=torch.float32, device="cpu")
    w = model.blocks[0].attn.wqkv.weight
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(n(w), tree["blocks"][0]["attn"]["wqkv"].T)
    serving = tgpt.params_from_jax(tree, bf, device="cpu")
    assert serving.blocks[0].attn.wqkv.weight.dtype == torch.bfloat16
    idx = torch.arange(20)[None] % 64
    with torch.no_grad():
        assert model(idx).dtype == torch.bfloat16
        torch.testing.assert_close(model(idx), serving(idx), atol=0, rtol=0)


def test_remat_gradients_equal_no_remat_under_dropout():
    """Dropout masks come from generators seeded per (step seed, site)
    inside each block, so the block torch.utils.checkpoint recomputes draws
    the same masks: remat and no-remat give equal gradients."""
    cfg = dataclasses.replace(TORCH_CFG, dropout=0.2)
    idx = torch.randint(0, 64, (2, 160), generator=torch.Generator().manual_seed(3))
    grads, losses = [], []
    for remat in (False, True):
        model = tgpt.GPT(dataclasses.replace(cfg, remat=remat), generator=torch.Generator().manual_seed(4),
                         param_dtype=torch.float32, device="cpu")
        loss = tgpt.loss_fn(model, idx, idx, rng=123, deterministic=False)
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad.clone() for p in model.parameters()])
    assert losses[0] == losses[1]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with torch.no_grad():
        assert tgpt.loss_fn(model, idx, idx).item() != losses[0]  # dropout was on


def test_dropout_keep_share_and_scale():
    x = torch.ones(200_000)
    y = tgpt._dropout(x, 0.2, seed=7)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    torch.testing.assert_close(tgpt._dropout(x, 0.2, seed=7), y, atol=0, rtol=0)
    assert not torch.equal(tgpt._dropout(x, 0.2, seed=8), y)
    assert tgpt._dropout(x, 0.2, seed=None) is x
    with pytest.raises(ValueError, match="seed"):
        model = tgpt.GPT(dataclasses.replace(TORCH_CFG, dropout=0.1), device="cpu")
        model(torch.zeros(1, 4, dtype=torch.long), deterministic=False)


def test_generate_greedy_and_seeded():
    model = tgpt.GPT(TORCH_CFG, generator=torch.Generator().manual_seed(5), device="cpu")
    start = torch.tensor([[1, 2, 3]])
    greedy = tgpt.generate(model, start, max_new_tokens=5, top_k=1)
    ids = start
    with torch.no_grad():
        for _ in range(5):
            ids = torch.cat([ids, model(ids)[:, -1].argmax(-1, keepdim=True)], dim=1)
    torch.testing.assert_close(greedy, ids)
    a = tgpt.generate(model, start, max_new_tokens=8, generator=torch.Generator().manual_seed(1))
    b = tgpt.generate(model, start, max_new_tokens=8, generator=torch.Generator().manual_seed(1))
    assert a.shape == (1, 11) and torch.equal(a, b) and int(a.max()) < TORCH_CFG.vocab_size


# -- optimizer, schedule, accumulation against optax ------------------------


@pytest.mark.parametrize("lr,warmup,decay,min_lr", [(6e-4, 5, 20, 6e-5), (1e-3, 0, 10, 1e-4), (3e-4, 100, 2000, 3e-5)])
def test_schedule_matches_optax(lr, warmup, decay, min_lr):
    """Every count up to lr_decay_iters + 2, including the first update's
    rate of 0."""
    counts = np.arange(decay + 3)
    want = np.asarray(jax.vmap(joptim.cosine_schedule(lr, warmup, decay, min_lr))(jnp.asarray(counts)))
    sched = cosine_schedule(lr, warmup, decay, min_lr)
    got = np.array([sched(int(c)) for c in counts])
    assert got[0] == 0.0
    # optax evaluates in float32: a few float32 ulps (~2e-6 relative) apart
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


class _Tiny(nn.Module):
    """A 2-D (decayed) and a 1-D (not decayed) parameter."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(t(w))
        self.b = nn.Parameter(t(b))


def _grad_loss(model, idx, targets, rng, train):
    """A loss whose gradient is exactly the given (gw, gb)."""
    gw, gb = idx
    return (model.w * gw).sum() + (model.b * gb).sum()


@pytest.mark.parametrize("accumulation", [1, 2])
def test_updates_match_optax(accumulation):
    """TrainStep (clip_grad_norm_, lr from the schedule, AdamW with decay on
    2-D params) against make_optimizer's optax chain, wrapped in
    optax.MultiSteps for accumulation: params after every micro-step, at
    1e-6.  Gradients alternate between clipped (norm > 1) and not; clipping
    differs by c/(norm + 1e-6) vs c/norm, under 1e-6 relative."""
    w0, b0 = randn(0, 8, 16), randn(1, 16)
    grads = [(randn(10 + i, 8, 16) * (1.0 if i % 2 else 0.01), randn(20 + i, 16)) for i in range(6)]
    kw = dict(weight_decay=0.1, warmup_iters=2, lr_decay_iters=10)
    jopt = joptim.make_optimizer(1e-2, grad_clip=1.0, **kw)
    if accumulation > 1:
        jopt = optax.MultiSteps(jopt, accumulation)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = jopt.init(params)
    model = _Tiny(w0, b0)
    opt, sched = make_optimizer(model, 1e-2, **kw)
    step = make_train_step(None, opt, sched, grad_clip=1.0, accumulation=accumulation, loss=_grad_loss)
    for gw, gb in grads:
        updates, state = jopt.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, state, params)
        params = optax.apply_updates(params, updates)
        step(model, (t(gw), t(gb)), None, 0)
        np.testing.assert_allclose(n(model.w), np.asarray(params["w"]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(n(model.b), np.asarray(params["b"]), atol=1e-6, rtol=0)
    assert step.updates == len(grads) // accumulation


def test_optimizer_groups_decay_only_matrices():
    model = tgpt.GPT(TORCH_CFG, param_dtype=torch.float32, device="cpu")
    opt, _ = make_optimizer(model, 1e-3)
    decayed, plain = opt.param_groups
    assert decayed["weight_decay"] == 0.1 and plain["weight_decay"] == 0.0
    assert all(p.dim() >= 2 for p in decayed["params"]) and all(p.dim() < 2 for p in plain["params"])
    assert any(p is model.wte for p in decayed["params"]) and any(p is model.wpe for p in decayed["params"])
    assert len(decayed["params"]) + len(plain["params"]) == len(list(model.parameters()))
    assert opt.defaults["betas"] == (0.9, 0.95) and opt.defaults["eps"] == 1e-8


# -- trainer against JAX's Trainer -----------------------------------------


def _tiny(use_flash=True, max_iters=8):
    """tests/test_training_e2e.py's _tiny_setup, for both packages."""
    text = _jax_demo().synthetic_corpus(20_000, seed=3)
    tok = tloader.CharTokenizer(text)
    data = tok.encode(text)
    shape = dict(vocab_size=max(tok.vocab_size, 8), block_size=128, n_layer=2, n_head=2, n_embd=64, dropout=0.0,
                 use_flash=use_flash)
    tkw = dict(max_iters=max_iters, eval_interval=100, eval_iters=2, log_interval=1, learning_rate=1e-3,
               warmup_iters=2)
    return data, shape, tkw


def _port_trainer(use_flash=True, max_iters=8, **extra):
    data, shape, tkw = _tiny(use_flash, max_iters)
    trainer = Trainer(tgpt.GPTConfig(**shape, dtype=torch.float32), TrainerConfig(**{**tkw, **extra}), seed=0,
                      device="cpu")
    return trainer, data


def _losses(history):
    return np.array([r["train_loss"] for r in history])


def test_trainer_matches_jax_trainer():
    """8 steps from the same params on the same batches: steps 0-1 within
    1e-5; all 8 within 2e-3, since Adam amplifies noise-level gradient
    differences."""
    data, shape, tkw = _tiny()
    jtrainer = JTrainer(jgpt.GPTConfig(**shape, dtype=jnp.float32), JTrainerConfig(**tkw), seed=0)
    tree = jax.tree.map(np.asarray, jtrainer.params)
    tcfg = tgpt.GPTConfig(**shape, dtype=torch.float32)
    model = tgpt.params_from_jax(tree, tcfg, param_dtype=torch.float32, device="cpu")
    trainer = Trainer(tcfg, TrainerConfig(**tkw), model=model)
    want = _losses(jtrainer.fit(jloader.batch_iterator(data, 8, 128, seed=0), log=lambda s: None))
    got = _losses(trainer.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None))
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_flash_vs_dense_loss_curves_match():
    """tests/test_training_e2e.py's flash-vs-dense experiment on the port."""
    t_flash, data = _port_trainer(use_flash=True)
    t_dense, _ = _port_trainer(use_flash=False)
    h_flash = t_flash.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None)
    h_dense = t_dense.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None)
    assert len(h_flash) == 8 and _losses(h_flash)[-1] < _losses(h_flash)[0]
    np.testing.assert_allclose(_losses(h_flash), _losses(h_dense), rtol=2e-3, atol=2e-3)


def test_history_records_and_eval_cadence():
    trainer, data = _port_trainer(max_iters=4, eval_interval=2, log_interval=3)
    history = trainer.fit(
        tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"),
        val_batches=lambda: tloader.batch_iterator(data, 8, 128, seed=9, device="cpu"),
        log=lambda s: None,
    )
    assert [r["iter"] for r in history] == [0, 2, 3]
    assert all(set(r) == {"iter", "train_loss", "wall_s", "val_loss"} for r in history)


def test_trainer_takes_no_sharding_arguments():
    """Without sharding arguments (or with None) the trainer is the
    single-device one; the sharding arguments exist since the parallel
    slice (tests/test_torch_parallel.py drives them), and an argument the
    JAX Trainer does not take is still a TypeError."""
    trainer = Trainer(TORCH_CFG, TrainerConfig(), param_sharding=None, batch_sharding=None, device="cpu")
    assert trainer._row_split == []
    assert not any(getattr(p, "_fa_sums_grads", False) for p in trainer.model.parameters())
    with pytest.raises(TypeError):
        Trainer(TORCH_CFG, TrainerConfig(), mesh=None, device="cpu")


# -- checkpoints -------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    trainer, data = _port_trainer(max_iters=4)
    trainer.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None)
    save_checkpoint(tmp_path / "step_4", {"model": trainer.model.state_dict(), "step": 4})
    state = restore_checkpoint(tmp_path / "step_4")
    assert state["step"] == 4
    fresh, _ = _port_trainer(max_iters=4)
    fresh.model.load_state_dict(state["model"])
    idx = torch.zeros(1, 16, dtype=torch.long)
    with torch.no_grad():
        torch.testing.assert_close(fresh.model(idx), trainer.model(idx), atol=0, rtol=0)


@pytest.mark.parametrize("accumulation", [1, 3])
def test_resume_matches_uninterrupted(tmp_path, accumulation):
    """8 iterations straight against 4 + checkpoint + resume + 4 (with
    accumulation 3 the checkpoint falls mid-accumulation and carries the
    accumulated gradients): same parameters, atol 1e-6."""
    straight, data = _port_trainer(gradient_accumulation=accumulation)
    straight.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None)

    first, _ = _port_trainer(gradient_accumulation=accumulation)
    first.tcfg.max_iters, first.tcfg.checkpoint_every, first.tcfg.checkpoint_dir = 4, 4, str(tmp_path)
    first.fit(tloader.batch_iterator(data, 8, 128, seed=0, device="cpu"), log=lambda s: None)

    resumed, _ = _port_trainer(gradient_accumulation=accumulation)
    assert resumed.resume(str(tmp_path)) == 4
    batches = tloader.batch_iterator(data, 8, 128, seed=0, device="cpu")
    for _ in range(4):
        next(batches)
    history = resumed.fit(batches, log=lambda s: None)
    assert history[-1]["iter"] == 7
    for a, b in zip(straight.model.parameters(), resumed.model.parameters()):
        np.testing.assert_allclose(n(b), n(a), atol=1e-6, rtol=0)


def test_emergency_checkpoint_on_crash(tmp_path):
    crashed, data = _port_trainer(checkpoint_dir=str(tmp_path))
    batches = tloader.batch_iterator(data, 8, 128, seed=0, device="cpu")

    def crashing():
        for i, b in enumerate(batches):
            if i == 3:
                raise RuntimeError("injected data failure")
            yield b

    logs = []
    with pytest.raises(RuntimeError, match="injected"):
        crashed.fit(crashing(), log=logs.append)
    assert crashed.step == 3 and any("emergency checkpoint" in line for line in logs)
    resumed, _ = _port_trainer()
    assert resumed.resume(str(tmp_path)) == 3
    for a, b in zip(crashed.model.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_metrics_logger_writes_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path))
    logger.log({"iter": 0, "train_loss": 1.5})
    logger.summary({"final": 1})
    logger.close()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["train_loss"] == 1.5 and lines[1]["summary"] == {"final": 1}


# -- data and demo -------------------------------------------------------------


def test_data_matches_jax():
    """The same tokenizer, crops and corpus as the JAX package, so both
    trainers can be fed identical batches."""
    text = _jax_demo().synthetic_corpus(30_000, seed=5)
    assert tloader.synthetic_corpus(30_000, seed=5) == text
    jt, tt = jloader.CharTokenizer(text), tloader.CharTokenizer(text)
    np.testing.assert_array_equal(tt.vocab, jt.vocab)
    ids = tt.encode(text)
    np.testing.assert_array_equal(ids, jt.encode(text))
    assert tt.decode(ids[:200]) == jt.decode(ids[:200]) == text[:200]
    for seed in (0, 7):
        for a, b in zip(tloader.sample_batch(ids, seed, 4, 64), jloader.sample_batch(ids, seed, 4, 64)):
            np.testing.assert_array_equal(a, b)
    tx, ty = next(tloader.batch_iterator(ids, 4, 64, seed=3, device="cpu"))
    jx, jy = next(jloader.batch_iterator(ids, 4, 64, seed=3))
    assert tx.dtype == torch.long and tx.device.type == "cpu"
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_array_equal(n(ty), np.asarray(jy))


def test_demo_trains_on_cpu_and_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    kw = dict(max_iters=3, n_layer=1, n_head=2, n_embd=64, block_size=128, batch_size=4, eval_iters=1,
              eval_interval=2, out_dir=str(tmp_path))
    trainer, history = tdemo.train(**kw, device="cpu")
    assert history[-1]["iter"] == 2 and np.isfinite(history[-1]["train_loss"])
    assert json.loads((tmp_path / "history.json").read_text()) == history
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdemo.train(**kw, device="cuda")
    args = tdemo.default_args()
    assert args.device == "cuda" and args.dropout == 0.2 and args.attention == "flash"
