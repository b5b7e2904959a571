"""The cases of the port's `parallel/` tests, run on every gloo rank.

`_torch_ranks.spawn` starts each rank with the same inputs (numpy arrays
and the JAX package's params as numpy trees, made in the test module) and
calls `run`; the test module then checks each case's arrays against the
JAX package.  This module imports torch and the port only: the ranks never
import JAX.  Every rank runs every case of its suite in the same order,
since the cases' collectives must meet.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch import parallel as par
from flash_attention_tpu_torch.inference import init_cache
from flash_attention_tpu_torch.models import gpt, llama
from flash_attention_tpu_torch.parallel.sharding import shardings, whole
from flash_attention_tpu_torch.quant.weights import quantize_llama_params
from flash_attention_tpu_torch.training import Trainer, TrainerConfig

# the module (the package's `ring_attention` is the function)
ra = importlib.import_module("flash_attention_tpu_torch.parallel.ring_attention")


def _t(a, grad: bool = False) -> torch.Tensor:
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _grads(out, g, xs):
    return [_n(d) for d in torch.autograd.grad((out * _t(g)).sum(), xs)]


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return ""


# ---------------------------------------------------------------- ring suite


def _ring(inp: dict, rank: int) -> dict:
    out = {}
    seq = par.make_mesh(seq=4, device="cpu")
    q, k, v = (_t(inp["ring"][x], True) for x in "qkv")
    o = par.ring_attention(q, k, v, seq, causal=True)
    out["ring_parity"] = _n(o)
    out["ring_grad"] = _grads(o, inp["ring"]["g"], (q, k, v))
    # DTensor inputs: the output keeps their placements
    placed = [par.mesh.placements(seq, (None, None, "seq", None))] * 3
    dts = [torch.distributed.tensor.distribute_tensor(x.detach(), seq, p) for x, p in zip((q, k, v), placed)]
    od = par.ring_attention(*dts, seq, causal=True)
    out["ring_dtensor"] = (_n(od.full_tensor()), tuple(od.placements) == tuple(placed[0]), tuple(od.to_local().shape))

    # batch rows over data and tokens over seq on a 2 x 2 mesh; zig-zag
    # inputs already in chunk order (preordered) stay in it
    grid = par.make_mesh(data=2, seq=2, device="cpu")
    q, k, v = (_t(inp["ring"][x]) for x in "qkv")
    q2, k2, v2 = (torch.cat([x, x.flip(2)]) for x in (q, k, v))  # two rows
    zidx = ra.zigzag_indices(q2.shape[2], 2)
    pre = par.ring_attention(*(x.index_select(2, zidx) for x in (q2, k2, v2)), grid, zigzag=True,
                             batch_axis="data", preordered=True)
    out["ring_batch_axis"] = (_n(par.ring_attention(q2, k2, v2, grid, batch_axis="data")),
                              _n(pre.index_select(2, ra.zigzag_inverse(q2.shape[2], 2))))

    x = _t(inp["non_causal"])
    out["ring_non_causal"] = _n(par.ring_attention(x, x, x, seq, causal=False))

    q, k, v = (_t(inp["zigzag"][x], True) for x in "qkv")
    o = par.ring_attention(q, k, v, seq, causal=True, zigzag=True)
    out["zigzag_parity"] = _n(o)
    out["zigzag_grad"] = _grads(o, inp["zigzag"]["g"], (q, k, v))
    out["zigzag_odd"] = _error(lambda: par.ring_attention(q[:, :, :20], k[:, :, :20], v[:, :, :20], seq, zigzag=True))
    out["zigzag_non_causal"] = _error(lambda: par.ring_attention(q, k, v, seq, causal=False, zigzag=True))

    q, k, v = (_t(inp["gqa"][x], True) for x in "qkv")
    o = par.ring_attention(q, k, v, seq, causal=True)
    out["gqa"] = _n(o)
    out["gqa_grad"] = _grads(o, inp["gqa"]["g"], (q, k, v))

    model = par.make_mesh(model=4, device="cpu")
    x = _t(inp["head"]["q"], True)
    o = par.head_parallel_attention(x, x, x, model)
    out["head_parallel"] = (_n(o), _grads(o, inp["head"]["g"], (x,))[0])

    out["mesh"] = (
        par.make_mesh(data=2, model=2, device="cpu").shape,
        par.make_mesh(data=2, model=-1, device="cpu").shape,
        par.make_mesh(seq=-1, device="cpu").shape,
        _error(lambda: par.make_mesh(data=-1, model=-1, device="cpu")),
        _error(lambda: par.make_mesh(data=3, model=-1, device="cpu")),
        _error(lambda: par.make_mesh(data=8, device="cpu")),
        seq.mesh_dim_names,
    )

    # a CUDA tensor over this gloo group raises: nothing is staged through
    # the host (the CPU box has no card, so the route is faked)
    real = ra.kernel_route
    ra.kernel_route = lambda *ts: "cuda"
    try:
        out["cuda_over_gloo"] = _error(lambda: ra.ring_attention_local(q, k, v, seq.get_group("seq")))
    finally:
        ra.kernel_route = real

    out["topology"] = par.topology()
    par.assert_same_across_hosts(7, "seven")
    out["hosts_disagree"] = _error(lambda: par.assert_same_across_hosts(rank, "rank"))
    out["initialize_again"] = par.initialize_multihost(device="cpu")
    return out


# --------------------------------------------------------------- model suite

_TC = TrainerConfig(max_iters=1, learning_rate=1e-3, warmup_iters=1, lr_decay_iters=10, log_interval=1)


def _step(cfg, model, idx, tgt, **sharding) -> tuple[float, dict, dict, Trainer]:
    """One Trainer step from a fresh optimizer, as the JAX tests step:
    (loss, the gradients as the update reads them, averaged over the data
    axis, read where the step clips them, and the updated params, both in
    the JAX layout, trainer)."""
    trainer = Trainer(cfg, _TC, model=model, **sharding)
    fam = llama if isinstance(cfg, llama.LlamaConfig) else gpt
    seen = {}
    clip = torch.nn.utils.clip_grad_norm_

    def record(params, max_norm):
        seen["grads"] = fam.grads_to_jax_layout(trainer.model)
        return clip(params, max_norm)

    torch.nn.utils.clip_grad_norm_ = record
    try:
        loss = trainer.fit(iter([(_t(idx).long(), _t(tgt).long())]), log=lambda s: None)[-1]["train_loss"]
    finally:
        torch.nn.utils.clip_grad_norm_ = clip
    return loss, seen["grads"], fam.grads_to_jax_layout(trainer.model, params=True), trainer


def _model_case(cfg, fam, tree, idx, tgt) -> dict:
    """Forward logits, loss and gradients (JAX layout) of a sharded config."""
    model = fam.params_from_jax(tree, cfg, param_dtype=torch.float32, device="cpu")
    logits = _n(model(_t(idx).long()))
    loss = fam.loss_fn(model, _t(idx).long(), _t(tgt).long())
    loss.backward()
    return {"logits": logits, "loss": float(loss), "grads": fam.grads_to_jax_layout(model)}


def _model(inp: dict, rank: int) -> dict:
    out = {}
    d = inp["dp_tp"]
    cfg = gpt.GPTConfig(**d["cfg"], dtype=torch.float32)
    mesh = par.make_mesh(data=2, model=2, device="cpu")
    model = gpt.params_from_jax(d["params"], cfg, param_dtype=torch.float32, device="cpu")
    loss, grads, params, tr = _step(cfg, model, d["idx"], d["tgt"],
                                    param_sharding=par.gpt_param_sharding(mesh, model),
                                    batch_sharding=par.batch_sharding(mesh))
    wqkv = tr.model.blocks[0].attn.wqkv.weight
    out["dp_tp"] = (loss, grads, params, tuple(wqkv.to_local().shape), type(tr.optimizer).__name__)

    # the placed wqkv: this model rank's head group of q | k | v rows, and
    # `whole` gives back the unsharded weight
    placed = gpt.params_from_jax(d["params"], cfg, param_dtype=torch.float32, device="cpu")
    attn = placed.blocks[0].attn
    w, bias = attn.wqkv.weight.detach().clone(), attn.wqkv.bias.detach().clone()
    par.shard_params(placed, mesh)
    r, tp, e = mesh.get_local_rank("model"), mesh.size(1), cfg.n_embd
    rows = torch.cat([torch.arange(part * e + r * e // tp, part * e + (r + 1) * e // tp) for part in range(3)])
    out["wqkv_head_group"] = (
        torch.equal(attn.wqkv.weight.to_local(), w[rows]), torch.equal(attn.wqkv.bias.to_local(), bias[rows]),
        torch.equal(whole(attn.wqkv.weight), w), torch.equal(whole(attn.wqkv.bias), bias),
    )

    d = inp["llama_dp_tp"]
    lcfg = llama.LlamaConfig(**d["cfg"], dtype=torch.float32)
    lm = llama.params_from_jax(d["params"], lcfg, param_dtype=torch.float32, device="cpu")
    loss, grads, params, tr = _step(lcfg, lm, d["idx"], d["tgt"],
                                    param_sharding=shardings(mesh, par.llama_param_specs(lm)),
                                    batch_sharding=par.batch_sharding(mesh))
    out["llama_dp_tp"] = (loss, grads, params, tuple(tr.model.blocks[0].wq.weight.to_local().shape))

    d = inp["tp_inference"]
    lcfg = llama.LlamaConfig(**d["cfg"], dtype=torch.float32)
    tp = par.make_mesh(model=4, device="cpu")
    lm = llama.params_from_jax(d["params"], lcfg, device="cpu")
    cache = init_cache(lcfg.n_layer, 2, lcfg.n_kv_head, lcfg.max_seq, lcfg.head_dim, dtype=lcfg.dtype, device="cpu")
    lm, cache = par.shard_llama_for_inference(lm, cache, tp)
    prompt = _t(d["prompt"])
    cache, logits = par.tp_prefill(lm, prompt, cache, 0, tp)
    cache, _ = par.tp_prefill(lm, prompt, cache, 1, tp)
    first = torch.full((2,), int(logits.argmax()), dtype=torch.int32)
    cache, toks = par.tp_decode_loop(lm, cache, first, 6, tp)
    out["tp_inference"] = (_n(logits), _n(toks), tuple(cache.k.to_local().shape), tuple(cache.lengths.to_local()))
    for bits in (8, 4):  # weight-only payloads sharded with their weights (int4 re-packed per shard)
        served = []
        for shard in (False, True):
            lm = quantize_llama_params(llama.params_from_jax(d["params"], lcfg, device="cpu"), bits=bits)
            cache = init_cache(lcfg.n_layer, 1, lcfg.n_kv_head, lcfg.max_seq, lcfg.head_dim, dtype=lcfg.dtype,
                               device="cpu")
            if shard:
                lm, cache = par.shard_llama_for_inference(lm, cache, tp)
            cache, logits = par.tp_prefill(lm, prompt, cache, 0, tp)
            first = torch.full((1,), int(logits.argmax()), dtype=torch.int32)
            served += [_n(logits), _n(par.tp_decode_loop(lm, cache, first, 6, tp)[1])]
        out[f"tp_quant{bits}"] = served
    bad = llama.LlamaConfig(vocab_size=64, n_layer=1, n_head=3, n_kv_head=3, n_embd=24, intermediate=48, max_seq=64,
                            dtype=torch.float32)
    out["tp_rejects"] = _error(lambda: par.shard_llama_for_inference(
        llama.Llama(bad, device="cpu"), init_cache(1, 1, 3, 64, bad.head_dim, dtype=bad.dtype, device="cpu"), tp))

    d = inp["cp"]
    seq = par.make_mesh(seq=4, device="cpu")
    base = gpt.GPTConfig(**d["cfg"], dtype=torch.float32)
    for zig in (False, True):
        out[f"gpt_cp_{zig}"] = _model_case(dataclasses.replace(base, seq_mesh=seq, seq_zigzag=zig), gpt,
                                          d["params"], d["idx"], d["tgt"])

    d = inp["llama_cp"]
    base = llama.LlamaConfig(**d["cfg"], dtype=torch.float32)
    for zig in (False, True):
        out[f"llama_cp_{zig}"] = _model_case(dataclasses.replace(base, seq_mesh=seq, seq_zigzag=zig), llama,
                                            d["params"], d["idx"], d["tgt"])

    d = inp["dp_cp"]
    cp = par.make_mesh(data=2, seq=2, device="cpu")
    base = gpt.GPTConfig(**d["cfg"], dtype=torch.float32)
    cfg = dataclasses.replace(base, seq_mesh=cp, seq_batch_axis=par.DATA_AXIS, seq_zigzag=True)
    model = gpt.params_from_jax(d["params"], cfg, param_dtype=torch.float32, device="cpu")
    loss, grads, params, _ = _step(cfg, model, d["idx"], d["tgt"], batch_sharding=par.seq_batch_sharding(cp))
    out["dp_cp"] = (loss, grads, params)
    dist.barrier()
    return out


def run(rank: int, world: int, inputs: dict) -> dict:
    return {"ring": _ring, "model": _model}[inputs["suite"]](inputs, rank)
