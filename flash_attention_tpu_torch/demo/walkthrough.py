"""The flash-attention story, end to end, on the PyTorch port.

Port of the JAX package's `demo/walkthrough.py`, which rebuilds the
reference's demo notebook in four acts: (1) dense attention's memory
blow-up at the reference's OOM shape, (2) where the memory lives (the
per-variable table and the live bytes over the run), (3) the one-line fix,
(4) flash and dense training trajectories that coincide.

Run:  python -m flash_attention_tpu_torch.demo.walkthrough [--device cuda] [--out-dir DIR]
      python -m flash_attention_tpu_torch.demo.walkthrough --device cpu --iters 4

`--device` defaults to cuda (the CUDA kernels; raises without a card); on
cpu every kernel runs its plain version.  The memory figures are counted
by `utils.profiling` (storage created and freed, operator by operator) and
are the same on both; on the card the allocator's peak is printed beside
them.  The figures go to --out-dir (matplotlib).
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from ..config import resolve_device

MB = 1024 * 1024


def act1_the_problem(device: torch.device) -> None:
    """Dense attention materialises the O(L^2) score matrix."""
    from ..kernels import flash_attention, vanilla_attention
    from ..utils.profiling import memory_report

    print("=" * 72)
    print("Act 1 - the problem: attention memory is quadratic in context")
    print("=" * 72)
    b, h, l, d = 1, 16, 2048, 64  # the reference's OOM shape
    q = torch.zeros(b, h, l, d, device=device)
    print(f"shape: batch {b}, heads {h}, seq {l}, head_dim {d} (fp32), on {device}")
    print(f"score matrix alone: {b * h * l * l * 4 / MB:.0f} MB")
    dense = memory_report(lambda q, k, v: vanilla_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    flash = memory_report(lambda q, k, v: flash_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    print(f"dense: {dense}")
    print(f"flash: {flash}")
    print(f"dense temps {dense.temp_bytes / MB:8.1f} MB, flash temps {flash.temp_bytes / MB:8.1f} MB "
          f"({dense.temp_bytes / max(flash.temp_bytes, 1):.1f}x smaller)")
    print("On the reference's hardware the dense path runs out of memory at this shape "
          "(its tests/python/test_scaled_dot_product_attention.py:116-153).\n")


def act2_profile(device: torch.device, out: pathlib.Path) -> None:
    """Find the memory: the per-variable table and the liveness curve."""
    from ..kernels import flash_attention, vanilla_attention
    from ..models import gpt
    from ..utils.profiling import format_variable_table, liveness, plot_liveness, variable_table

    print("=" * 72)
    print("Act 2 - profile it: where does the memory live?")
    print("=" * 72)
    cfg = gpt.GPTConfig(vocab_size=65, block_size=1024, n_layer=6, n_head=6, n_embd=384, dtype=torch.float32)
    model = gpt.GPT(cfg, device=device)
    print("model parameters (the reference's per-variable report):")
    print(format_variable_table(variable_table(model, name="params"), top=8))
    print()

    b, h, l, d = 1, 8, 1024, 64
    q = torch.zeros(b, h, l, d, device=device)
    s_d, live_d = liveness(lambda q, k, v: vanilla_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    s_f, live_f = liveness(lambda q, k, v: flash_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    print(f"liveness peak, dense: {live_d.max() / MB:7.1f} MB over {len(s_d)} operators (the scores and "
          f"their softmax)")
    print(f"liveness peak, flash: {live_f.max() / MB:7.1f} MB over {len(s_f)} operators")
    out.mkdir(parents=True, exist_ok=True)
    plot_liveness({"dense attention": (s_d, live_d), "flash attention": (s_f, live_f)}, str(out / "liveness.png"),
                  title=f"attention live bytes, b{b} h{h} L{l} D{d} fp32, {device.type}")
    print(f"liveness plot -> {out / 'liveness.png'}\n")


def act3_the_fix(device: torch.device) -> None:
    """The one-line fix: route attention through the flash kernel."""
    import torch.nn.functional as F

    from ..kernels import flash_attention
    from ..ops.sdpa import install_patch, uninstall_patch

    print("=" * 72)
    print("Act 3 - the fix is one line")
    print("=" * 72)
    print("""Model-level:     GPTConfig(use_flash=True)                 # models/gpt.py
Existing code:   import flash_attention_tpu_torch.auto     # patches F.scaled_dot_product_attention
Explicit:        flash_attention_tpu_torch.flash_attention(q, k, v, causal=True)""")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 256, 64, generator=gen).to(device) for _ in range(3))
    import flash_attention_tpu_torch.auto  # noqa: F401

    install_patch()  # again: a module imports once a process, and act 3 removes the patch when done
    try:
        routed = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    finally:
        uninstall_patch()
    err = (routed - flash_attention(q, k, v, causal=True)).abs().max().item()
    print(f"after `import flash_attention_tpu_torch.auto`, F.scaled_dot_product_attention(is_causal=True) "
          f"is flash_attention: max |diff| {err:.1e}\n")
    assert err == 0.0, "the patched SDPA did not route to flash_attention"


def act4_parity(device: torch.device, out: pathlib.Path, iters: int) -> None:
    """Same seeds, flash vs dense: the loss curves coincide."""
    from ..data import CharTokenizer, batch_iterator, synthetic_corpus
    from ..models import gpt
    from ..training import Trainer, TrainerConfig

    print("=" * 72)
    print(f"Act 4 - training parity: flash vs dense, {iters} iters, same seed")
    print("=" * 72)
    text = synthetic_corpus(30_000, seed=3)
    tok = CharTokenizer(text)
    data = tok.encode(text)
    histories = {}
    for mode in ("flash", "dense"):
        cfg = gpt.GPTConfig(vocab_size=max(tok.vocab_size, 8), block_size=128, n_layer=2, n_head=2, n_embd=64,
                            dropout=0.0, dtype=torch.float32, use_flash=mode == "flash")
        tcfg = TrainerConfig(max_iters=iters, log_interval=2, learning_rate=1e-3, warmup_iters=2)
        trainer = Trainer(cfg, tcfg, seed=0, device=device)
        histories[mode] = trainer.fit(batch_iterator(data, 8, cfg.block_size, seed=0, device=device),
                                      log=lambda s: None)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    for mode, hist in histories.items():
        ax.plot([r["iter"] for r in hist], [r["train_loss"] for r in hist], marker="o", label=f"{mode} attention")
    ax.set_xlabel("iteration")
    ax.set_ylabel("train loss")
    ax.set_title(f"identical trajectories ({device.type})")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    out.mkdir(parents=True, exist_ok=True)
    fig.savefig(out / "loss_parity.png", dpi=120)
    plt.close(fig)

    worst = max(abs(a["train_loss"] - b["train_loss"]) for a, b in zip(histories["flash"], histories["dense"]))
    print(f"max |flash - dense| train loss over the run: {worst:.2e}")
    print(f"parity plot -> {out / 'loss_parity.png'}\n")
    assert worst < 5e-2, "trajectories diverged: a kernel fault"


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out-dir", default="out-walkthrough")
    p.add_argument("--iters", type=int, default=16)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out = pathlib.Path(args.out_dir)
    act1_the_problem(device)
    act2_profile(device, out)
    act3_the_fix(device)
    act4_parity(device, out, args.iters)


if __name__ == "__main__":
    main()
