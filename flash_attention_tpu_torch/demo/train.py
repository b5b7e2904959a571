"""Char-level GPT training demo on the PyTorch/CUDA port.

Port of the JAX package's `demo/train.py`: a shakespeare-char-class config
with overrides, char tokenizer and random-crop batches, AdamW with 2-D-only
decay and the warmup + cosine schedule, periodic eval, the flash-vs-dense
switch, checkpoint/resume, a trace of one step (`--profile`), a loss-curve
plot (`--plot`), and a short sample at the end.

Run:  python -m flash_attention_tpu_torch.demo.train --max-iters 200 --data corpus.txt
      python -m flash_attention_tpu_torch.demo.train --attention dense --plot
      python -m flash_attention_tpu_torch.demo.train --profile
      python -m flash_attention_tpu_torch.demo.train --device cpu --max-iters 3
      torchrun --nproc-per-node 4 -m flash_attention_tpu_torch.demo.train --cp 4 --cp-zigzag

`--device` defaults to cuda, which raises without a card.  Without --data a
deterministic synthetic corpus is generated.  `--profile` runs one warm
step, then one step under `utils.profiling.trace` into <out-dir>/profile,
and exits.  `--cp N` shards each sequence over N ranks (ring attention
inside the model); it runs under `torchrun --nproc-per-node N`, one process
per card (NCCL; gloo ranks with `--device cpu`), and every rank draws the
same batches.  --compile-cache is XLA-only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from ..config import resolve_device
from ..data import CharTokenizer, batch_iterator, load_bin, synthetic_corpus
from ..models import gpt
from ..training import Trainer, TrainerConfig


def plot_losses(history: list[dict], path: pathlib.Path) -> None:
    """Train and val loss curves into `path` (matplotlib, imported here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot([r["iter"] for r in history], [r["train_loss"] for r in history], label="train loss")
    evals = [(r["iter"], r["val_loss"]) for r in history if "val_loss" in r]
    if evals:
        ax.plot(*zip(*evals), marker="o", label="val loss")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_ylim(bottom=0)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def train(**overrides):
    """Programmatic entry point: train(**config_overrides) with the flags'
    names (underscored).  Returns (trainer, history)."""
    args = argparse.Namespace(**{**vars(default_args()), **overrides})
    return _run(args)


def default_args() -> argparse.Namespace:
    return build_parser().parse_args([])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", type=str, default=None, help="text corpus path, or a uint16 .bin")
    p.add_argument("--out-dir", type=str, default="out-demo")
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--n-layer", type=int, default=6)
    p.add_argument("--n-head", type=int, default=6)
    p.add_argument("--n-embd", type=int, default=384)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--max-iters", type=int, default=2000)
    p.add_argument("--eval-interval", type=int, default=250)
    p.add_argument("--eval-iters", type=int, default=20)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--attention", choices=["flash", "dense"], default="flash")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument(
        "--vocab-size", type=int, default=None,
        help=".bin corpora: vocab size (skips the full-mmap max() scan and covers ids absent from the data)",
    )
    p.add_argument("--remat", action="store_true", help="recompute each block in the backward pass")
    p.add_argument("--profile", action="store_true", help="trace one step into <out-dir>/profile and exit")
    p.add_argument("--plot", action="store_true", help="also write <out-dir>/loss_curve.png")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="continue from the latest step_* checkpoint under --out-dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument(
        "--cp", type=int, default=1,
        help="context parallelism: shard the sequence over this many ranks with ring attention inside the model "
             "(requires block_size %% cp == 0; launch under torchrun --nproc-per-node N)",
    )
    p.add_argument("--cp-zigzag", action="store_true", help="with --cp: zig-zag striped sharding (causal load balance)")
    return p


def _run(args: argparse.Namespace):
    device = resolve_device(args.device)
    text = tok = None
    if args.data and args.data.endswith(".bin"):
        # pre-tokenized uint16 corpus, memory-mapped; no tokenizer, no sample
        data = load_bin(args.data)
        vocab = args.vocab_size or int(data.max()) + 1
        print(f"corpus: {len(data)} tokens (mmap), vocab {vocab}")
    else:
        if args.data:
            text = pathlib.Path(args.data).read_text()
        else:
            print("no --data given; using synthetic corpus")
            text = synthetic_corpus()
        tok = CharTokenizer(text)
        data = tok.encode(text)
        vocab = tok.vocab_size
        print(f"corpus: {len(data)} tokens, vocab {vocab}")
    split = int(0.9 * len(data))
    train_data, val_data = data[:split], data[split:]

    cfg = gpt.GPTConfig(
        vocab_size=max(vocab, 8),
        block_size=args.block_size,
        n_layer=args.n_layer,
        n_head=args.n_head,
        n_embd=args.n_embd,
        dropout=args.dropout,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        use_flash=args.attention == "flash",
        remat=args.remat,
    )
    batch_sharding = None
    lead = True  # the rank that writes files
    if args.cp > 1:
        import dataclasses

        import torch.distributed as dist

        from ..parallel import initialize_multihost, make_mesh, seq_batch_sharding

        if args.block_size % args.cp:
            raise SystemExit(f"--cp {args.cp} must divide block_size")
        world = initialize_multihost(device=device)["process_count"]
        if world < args.cp:
            raise SystemExit(
                f"--cp {args.cp} needs {args.cp} devices, have {world} "
                f"(launch under torchrun --nproc-per-node {args.cp})"
            )
        cp_mesh = make_mesh(seq=args.cp, device=device)
        cfg = dataclasses.replace(cfg, seq_mesh=cp_mesh, seq_zigzag=args.cp_zigzag)
        batch_sharding = seq_batch_sharding(cp_mesh)
        lead = dist.get_rank() == 0
        print(f"context parallel: sequence sharded over {args.cp} devices" + (" (zigzag)" if args.cp_zigzag else ""))
    outdir = pathlib.Path(args.out_dir)
    tcfg = TrainerConfig(
        max_iters=args.max_iters,
        eval_interval=args.eval_interval,
        eval_iters=args.eval_iters,
        learning_rate=args.learning_rate,
        # under --cp only rank 0 saves (every rank holds the same state)
        checkpoint_every=args.checkpoint_every if lead else 0,
        checkpoint_dir=str(outdir) if args.checkpoint_every and lead else None,
    )
    trainer = Trainer(cfg, tcfg, seed=args.seed, device=device, batch_sharding=batch_sharding)
    print(f"model: {gpt.num_params(trainer.model) / 1e6:.2f}M params, attention={args.attention}, device={device}")
    if args.resume:
        step = trainer.resume(str(outdir))
        if step is None:
            print(f"--resume: no step_* checkpoint under {outdir}; starting fresh")
        else:
            print(f"resumed from step {step}")

    train_iter = batch_iterator(train_data, args.batch_size, cfg.block_size, seed=args.seed, device=device)
    for _ in range(trainer.step):
        # skip the batches the pre-checkpoint run consumed, so the resumed
        # run sees the same data sequence as an uninterrupted one
        next(train_iter)

    def val_batches():
        return batch_iterator(val_data, args.batch_size, cfg.block_size, seed=1234, device=device)

    if args.profile:
        from ..utils.profiling import trace

        idx, tgt = next(train_iter)
        profile_dir = outdir / "profile"
        trainer._train_step(trainer.model, idx, tgt, 0)  # warm: kernels built, allocator filled
        with trace(str(profile_dir)):
            trainer._train_step(trainer.model, idx, tgt, 0)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        print(f"profile written to {profile_dir}")
        return trainer, []

    start_step = trainer.step
    t0 = time.time()
    history = trainer.fit(train_iter, val_batches=val_batches)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    tokens = (args.max_iters - start_step) * args.batch_size * cfg.block_size
    print(f"done: {wall:.1f}s, {tokens / wall:.0f} tokens/s")

    if not lead:
        return trainer, history
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "history.json").write_text(json.dumps(history, indent=1))
    if args.plot and history:
        plot_losses(history, outdir / "loss_curve.png")
        print(f"loss curve: {outdir / 'loss_curve.png'}")
    if tok is not None:
        start = torch.as_tensor(tok.encode(text[:8])[None, :].astype(np.int64), device=device)
        sample_ids = gpt.generate(
            trainer.model, start, max_new_tokens=100, temperature=0.8, top_k=20,
            generator=torch.Generator(device=device).manual_seed(42),
        )
        print("sample:", tok.decode(sample_ids[0].cpu().numpy().astype(np.uint16)))
    return trainer, history


if __name__ == "__main__":
    _run(build_parser().parse_args())
