"""The port's walkthrough and its training demo's --profile and --plot, on
the CPU at a small size."""

from __future__ import annotations

import json

import _torch_port  # noqa: F401  (caps torch's threads)
from flash_attention_tpu_torch.demo import train as demo_train
from flash_attention_tpu_torch.demo import walkthrough


def test_walkthrough_runs_on_the_cpu(tmp_path, capsys):
    """All four acts: the memory blow-up, the table and the liveness plot,
    the one-line fix, flash and dense losses within 5e-2."""
    walkthrough.main(["--device", "cpu", "--iters", "4", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    for act in ("Act 1", "Act 2", "Act 3", "Act 4"):
        assert act in out
    assert "score matrix alone: 256 MB" in out and "params['blocks'][0]['mlp']['wfc']['weight']" in out
    assert (tmp_path / "liveness.png").stat().st_size > 0
    assert (tmp_path / "loss_parity.png").stat().st_size > 0


_SMALL = dict(device="cpu", n_layer=1, n_head=2, n_embd=32, block_size=64, batch_size=2, eval_iters=1)


def test_demo_plot_writes_the_loss_curve(tmp_path):
    _, history = demo_train.train(**_SMALL, max_iters=3, eval_interval=2, plot=True, out_dir=str(tmp_path))
    assert [r["iter"] for r in history] == [0, 2]
    assert (tmp_path / "loss_curve.png").stat().st_size > 0
    assert json.loads((tmp_path / "history.json").read_text()) == history


def test_demo_profile_traces_one_step_and_exits(tmp_path):
    trainer, history = demo_train.train(**_SMALL, max_iters=50, profile=True, out_dir=str(tmp_path))
    assert history == [] and trainer.step == 0  # the traced steps are not fit's
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    assert len(events) > 0
    assert not (tmp_path / "history.json").exists()
