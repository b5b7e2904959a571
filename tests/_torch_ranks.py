"""Run a cases module on N gloo CPU ranks, one process each.

The parity tests of `parallel/` (tests/test_torch_parallel.py,
tests/test_torch_ring.py) spawn their ranks once per test file: a
module-scoped fixture calls `spawn`, every rank runs the cases module's
`run(rank, world, inputs)` on the same numpy inputs, and each test then
checks the arrays of one case.  Ranks meet through a file under the
test's temporary directory (no port is shared between pytest workers), and
each runs one intra-op thread.

As a script (what `spawn` starts): python _torch_ranks.py <module> <rank> <world> <dir>
"""

from __future__ import annotations

import importlib
import os
import pathlib
import subprocess
import sys

_HERE = pathlib.Path(__file__).resolve().parent


def spawn(module: str, world: int, workdir, inputs: dict, timeout: float = 300.0) -> list[dict]:
    """Run `module.run(rank, world, inputs)` on `world` gloo ranks; returns
    each rank's result dict (rank order)."""
    import torch

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_HERE.parent), str(_HERE), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [
        subprocess.Popen([sys.executable, str(_HERE / "_torch_ranks.py"), module, str(r), str(world), str(workdir)],
                         env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)
    ]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n" + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs) if rc)
        raise RuntimeError(f"ranks failed: {rcs}\n{tails}")
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(world)]


def _main(module: str, rank: int, world: int, workdir: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'pg'}", rank=rank, world_size=world)
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        out = importlib.import_module(module).run(rank, world, inputs)
        torch.save(out, workdir / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), pathlib.Path(sys.argv[4]))
