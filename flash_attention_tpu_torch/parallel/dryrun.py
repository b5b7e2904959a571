"""Multi-rank dry run of the sharded paths on gloo CPU ranks.

Port of `flash_attention_tpu/parallel/dryrun.py`.  The JAX dry run uses N
virtual CPU devices in one process; torch.distributed runs one process per
device, so `dryrun_train_step(n)` starts n gloo ranks on the CPU, which
meet through a file in a temporary directory.  Each rank runs the same
four checks, at tiny shapes:

* a dp x tp GPT train step (parameters as DTensors, the batch's rows over
  the data axis): loss and updated parameters equal to the unsharded step's;
* ring attention over every rank, contiguous and zig-zag, against each
  other and dense attention;
* a dp x seq context-parallel GPT train step (ring attention inside the
  model, gradients through the backward ring): loss equal to the unsharded
  step's;
* tensor-parallel Llama serving (prefill + decode loop, cache sharded over
  kv heads): the unsharded path's tokens.

    python -m flash_attention_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile


def _check(rank: int, n: int) -> str:
    import torch

    from ..inference import init_cache
    from ..kernels import vanilla_attention
    from ..models import gpt, llama
    from ..training import Trainer, TrainerConfig
    from .inference_tp import shard_llama_for_inference, tp_decode_loop, tp_prefill
    from .mesh import batch_sharding, make_mesh, seq_batch_sharding
    from .ring_attention import ring_attention
    from .sharding import gpt_param_sharding

    torch.set_num_threads(1)
    dp = 2 if n % 2 == 0 else 1
    tp = n // dp
    mesh = make_mesh(data=dp, model=tp, device="cpu")
    cfg = gpt.GPTConfig(vocab_size=128, block_size=128, n_layer=2, n_head=max(tp, 2), n_embd=max(tp, 2) * 16,
                        dtype=torch.float32)
    # two steps: the schedule's first learning rate is 0
    tcfg = TrainerConfig(max_iters=2, learning_rate=1e-3, warmup_iters=1, lr_decay_iters=10, log_interval=1)
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, cfg.vocab_size, (dp * 2, cfg.block_size), generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (dp * 2, cfg.block_size), generator=gen)

    def fit(trainer):
        return trainer.fit(iter([(idx, tgt)] * 2), log=lambda s: None)[-1]["train_loss"]

    ref = Trainer(cfg, tcfg, device="cpu")
    loss_ref = fit(ref)
    sharded = Trainer(cfg, tcfg, device="cpu", param_sharding=gpt_param_sharding(mesh, ref.model),
                      batch_sharding=batch_sharding(mesh))
    loss = fit(sharded)
    want = gpt.grads_to_jax_layout(ref.model, params=True)
    got = gpt.grads_to_jax_layout(sharded.model, params=True)
    perr = max(float(abs(a - b).max()) for a, b in zip(_leaves(want), _leaves(got)))
    assert abs(loss - loss_ref) < 1e-5 and perr < 1e-5, f"dp x tp step: loss {loss} vs {loss_ref}, params {perr:.2e}"

    seq_mesh = make_mesh(seq=n, device="cpu")
    b, h, l, d = 1, 2, 128 * n, 64
    q = torch.randn(b, h, l, d, generator=gen)
    out = ring_attention(q, q, q, seq_mesh, causal=True)
    out_z = ring_attention(q, q, q, seq_mesh, causal=True, zigzag=True)
    dense = vanilla_attention(q, q, q, causal=True, sm_scale=d ** -0.5)
    zerr = float((out - out_z).abs().max())
    assert zerr < 1e-4 and float((out - dense).abs().max()) < 1e-4, f"ring mismatch {zerr}"

    sp = 4 if n % 4 == 0 else n
    dpc = n // sp
    cp_mesh = make_mesh(data=dpc, seq=sp, device="cpu")
    cp_base = dataclasses.replace(cfg, block_size=64 * sp)
    cp_cfg = dataclasses.replace(cp_base, seq_mesh=cp_mesh, seq_batch_axis="data", seq_zigzag=True)
    cp_idx = torch.randint(0, cfg.vocab_size, (max(dpc, 2), cp_base.block_size), generator=gen)
    cp_tgt = torch.randint(0, cfg.vocab_size, (max(dpc, 2), cp_base.block_size), generator=gen)
    cp_ref = Trainer(cp_base, tcfg, device="cpu", seed=4).fit(iter([(cp_idx, cp_tgt)] * 2), log=lambda s: None)
    cp_run = Trainer(cp_cfg, tcfg, device="cpu", seed=4, batch_sharding=seq_batch_sharding(cp_mesh))
    cp_loss = cp_run.fit(iter([(cp_idx, cp_tgt)] * 2), log=lambda s: None)[-1]["train_loss"]
    cp_err = abs(cp_loss - cp_ref[-1]["train_loss"])
    assert cp_err < 1e-5, f"context-parallel loss {cp_loss} vs {cp_ref[-1]['train_loss']}"

    lcfg = llama.LlamaConfig(vocab_size=64, n_layer=2, n_head=n, n_kv_head=n, n_embd=n * 16,
                             intermediate=n * 32, max_seq=64, dtype=torch.float32)
    tp_mesh = make_mesh(model=n, device="cpu")
    prompt = torch.tensor([3, 1, 4, 1, 5])

    def serve(shard: bool):
        m = llama.Llama(lcfg, device="cpu")
        c = init_cache(lcfg.n_layer, 2, lcfg.n_kv_head, lcfg.max_seq, lcfg.head_dim, dtype=lcfg.dtype, device="cpu")
        if shard:
            m, c = shard_llama_for_inference(m, c, tp_mesh)
            c, logits = tp_prefill(m, prompt, c, 0, tp_mesh)
            first = torch.full((2,), int(logits.argmax()), dtype=torch.int32)
            return tp_decode_loop(m, c, first, 3, tp_mesh)[1]
        c, logits = llama.prefill(m, prompt, c, 0)
        first = torch.full((2,), int(logits.argmax()), dtype=torch.int32)
        return llama.decode_loop(m, c, first, 3)[1]

    assert torch.equal(serve(True), serve(False)), "TP serving tokens differ from the unsharded ones"
    return (f"dryrun ok: dp={dp} tp={tp} train-step loss={loss:.4f} (unsharded {loss_ref:.4f}); ring attention "
            f"over seq={n} at L={l} (zigzag matches: max|diff|={zerr:.2e}); context-parallel train step "
            f"dp={dpc} x seq={sp}: loss {cp_loss:.4f} (|diff| {cp_err:.1e}); tp={n} llama serving "
            f"tokens equal")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def _rank_main(rank: int, n: int, init: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n)
    try:
        msg = _check(rank, n)
        if rank == 0:
            print(msg, flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_train_step(n_devices: int, timeout: float = 600.0) -> None:
    """Run the four checks on `n_devices` gloo CPU ranks (one process
    each); raises if any rank fails."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory(prefix="fa_dryrun_") as tmp:
        init = f"file://{os.path.join(tmp, 'pg')}"
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n_devices)]
        procs = [
            subprocess.Popen([sys.executable, "-m", "flash_attention_tpu_torch.parallel.dryrun", str(n_devices),
                              "--rank", str(r), "--init", init], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n_devices)
        ]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if any(rcs):
        raise RuntimeError(f"dry run failed on ranks {[r for r, rc in enumerate(rcs) if rc]}:\n" + "\n".join(outs))
    print(outs[0].strip())


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--rank", type=int)
    p.add_argument("--init")
    a = p.parse_args()
    if a.rank is None:
        dryrun_train_step(a.n)
    else:
        _rank_main(a.rank, a.n, a.init)
