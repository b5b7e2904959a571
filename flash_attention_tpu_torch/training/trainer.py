"""Training steps and loop, as the JAX package's `training/trainer.py`.

* `make_train_step` builds a `TrainStep`: each call takes one micro-batch
  through forward and backward; every `accumulation`-th call it averages
  the accumulated gradients, clips them by global norm, sets the learning
  rate from the schedule and updates.  That is what `optax.MultiSteps`
  does around the JAX chain: the loss it returns is the micro-batch's, the
  parameters change only on every k-th call, and the schedule advances
  once per update.
* `Trainer` runs the loop with the JAX trainer's eval cadence, history
  records, periodic checkpoints, `resume`, and an emergency checkpoint
  when `fit` fails.

The model family is dispatched on the config's type, as in the JAX
package: a GPTConfig builds a `GPT` and trains with the dropout-aware GPT
loss, a LlamaConfig a `Llama` with `llama.loss_fn`.

`TrainerConfig.autotune_blocks` tunes the flash-attention tiles for the
model's training shape before the first step (`Trainer.warmup_autotune`,
kernels/autotune.py).

Sharded training (`parallel/`): `param_sharding` places the parameters
as DTensors (tensor parallelism over the model axis); `batch_sharding`
says how each global batch is split.  Every rank draws the same global
batch from the seed.  Rows sharded over the data axis (dp): each rank
keeps its rows, and a hook on each parameter averages its gradient over
those ranks in the backward (`parallel.collectives.sum_grads_over`).
Under `cfg.seq_mesh` (cp) the model itself keeps its rows and tokens and
sums loss and gradients over the mesh, so the trainer hands it the whole
batch.  Either way the loss
and the update are the unsharded step's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..models import gpt, llama
from .optimizer import make_optimizer


def _default_loss(cfg) -> Callable:
    """(model, idx, targets, rng, train) -> scalar loss for `cfg`'s model
    family: the dropout-aware gpt loss for a GPTConfig, the llama one (no
    dropout in the architecture) for a LlamaConfig."""
    if isinstance(cfg, llama.LlamaConfig):
        return lambda m, i, t, rng, train: llama.loss_fn(m, i, t)
    if not isinstance(cfg, gpt.GPTConfig):
        raise TypeError(f"no default loss for {type(cfg).__name__}: pass loss=")
    return lambda m, i, t, rng, train: gpt.loss_fn(m, i, t, rng=rng if train else None, deterministic=not train)


class TrainStep:
    """One training iteration on one micro-batch (see the module docstring).

    updates: optimizer updates taken so far (the schedule's count);
    micro: micro-batches accumulated since the last update.
    """

    def __init__(
        self,
        cfg,
        optimizer: torch.optim.Optimizer,
        schedule: Callable[[int], float],
        *,
        grad_clip: float = 1.0,
        accumulation: int = 1,
        loss: Callable | None = None,
    ):
        if accumulation < 1:
            raise ValueError(f"accumulation must be >= 1, got {accumulation}")
        self.loss = loss or _default_loss(cfg)
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.accumulation = accumulation
        self.updates = 0
        self.micro = 0

    def __call__(self, model: torch.nn.Module, idx: torch.Tensor, targets: torch.Tensor, rng: int) -> torch.Tensor:
        """Returns the micro-batch's loss (a detached scalar tensor)."""
        loss = self.loss(model, idx, targets, rng, True)
        loss.backward()
        self.micro += 1
        if self.micro == self.accumulation:
            params = [p for g in self.optimizer.param_groups for p in g["params"] if p.grad is not None]
            if self.accumulation > 1:
                torch._foreach_mul_([p.grad for p in params], 1.0 / self.accumulation)
            # clip_grad_norm_ scales by c / (norm + 1e-6) where optax scales
            # by c / norm (both only when norm >= c): under 1e-6 relative.
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
            lr = self.schedule(self.updates)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.updates += 1
            self.micro = 0
        return loss.detach()

    def state_dict(self, model: torch.nn.Module) -> dict:
        """Counters, and the gradients accumulated so far when mid-way
        through an accumulation."""
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        return {"updates": self.updates, "micro": self.micro, "grads": grads if self.micro else {}}

    def load_state_dict(self, model: torch.nn.Module, state: dict) -> None:
        self.updates = int(state["updates"])
        self.micro = int(state["micro"])
        for n, p in model.named_parameters():
            p.grad = state["grads"][n].to(p.device) if n in state["grads"] else None


def make_train_step(
    cfg,
    optimizer: torch.optim.Optimizer,
    schedule: Callable[[int], float],
    *,
    grad_clip: float = 1.0,
    accumulation: int = 1,
    loss: Callable | None = None,
) -> TrainStep:
    """`loss(model, idx, targets, rng, train)` overrides the default (the
    dropout-aware GPT loss)."""
    return TrainStep(cfg, optimizer, schedule, grad_clip=grad_clip, accumulation=accumulation, loss=loss)


def make_eval_step(cfg, loss: Callable | None = None) -> Callable:
    """(model, idx, targets) -> loss, deterministic and without grad."""
    loss = loss or _default_loss(cfg)

    @torch.no_grad()
    def eval_step(model, idx, targets):
        return loss(model, idx, targets, None, False)

    return eval_step


@dataclasses.dataclass
class TrainerConfig:
    """The JAX TrainerConfig's knobs."""

    max_iters: int = 2000
    eval_interval: int = 250
    eval_iters: int = 20
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_iters: int = 100
    lr_decay_iters: int | None = None  # default: max_iters
    gradient_accumulation: int = 1
    log_interval: int = 50
    # every `checkpoint_every` iters (and at the end) the full training
    # state is saved to `checkpoint_dir/step_N`
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    # Measured tile tuning (kernels/autotune.py): before the first step,
    # sweep the model's attention shape on the model's device and cache the
    # winner, which flash_attention's default path then uses.  One sweep per
    # (shape, device), kept in the cache file across runs.
    autotune_blocks: bool = False


class Trainer:
    """Training loop with periodic eval.

    cfg: a GPTConfig or a LlamaConfig.  model: the GPT or Llama to train
    (its weights are trained in place); default a fresh one of cfg's family
    with fp32 master weights, drawn from `seed` (a GPT's on the CPU, a
    Llama's by a generator on `device`).  device: where a fresh model lives
    (default the card, "cuda", which raises without one; "cpu" when asked
    for).  param_sharding: {parameter name: parallel.mesh.Sharding}
    (`parallel.gpt_param_sharding`), applied to the model before the
    optimizer is built.  batch_sharding: the `Sharding` of each [B, T]
    batch (`parallel.batch_sharding`, or `parallel.seq_batch_sharding`
    with cfg.seq_mesh); see the module docstring.
    """

    def __init__(self, cfg, tcfg: TrainerConfig, *, model=None, seed: int = 0, device=None,
                 param_sharding=None, batch_sharding=None):
        self.cfg = cfg
        self.tcfg = tcfg
        init_seed, rng_seed = np.random.SeedSequence(seed).generate_state(2)
        if model is None:
            device = resolve_device(device)
            if isinstance(cfg, llama.LlamaConfig):
                model_cls, gen = llama.Llama, torch.Generator(device=device)
            else:
                model_cls, gen = gpt.GPT, torch.Generator()
            model = model_cls(
                cfg, generator=gen.manual_seed(int(init_seed)), device=device, param_dtype=torch.float32
            )
        if param_sharding is not None:
            from ..parallel.sharding import distribute_params

            distribute_params(model, param_sharding)
        self.model = model
        self._row_split = _row_split(cfg, batch_sharding)
        if self._row_split:
            from ..parallel.collectives import sum_grads_over

            sum_grads_over(model, [g for g, _ in self._row_split],
                           scale=1.0 / int(np.prod([n for _, n in self._row_split])))
        # The host generator that draws each step's dropout seed.
        self.rng = torch.Generator().manual_seed(int(rng_seed))
        self.optimizer, self.schedule = make_optimizer(
            model,
            tcfg.learning_rate,
            weight_decay=tcfg.weight_decay,
            warmup_iters=tcfg.warmup_iters,
            lr_decay_iters=tcfg.lr_decay_iters or tcfg.max_iters,
        )
        self._train_step = make_train_step(
            cfg, self.optimizer, self.schedule,
            grad_clip=tcfg.grad_clip, accumulation=tcfg.gradient_accumulation,
        )
        self._eval_step = make_eval_step(cfg)
        self.history: list[dict] = []
        self.step = 0

    # -- data parallelism -------------------------------------------------

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (the whole batch unless the
        rows are sharded without cfg.seq_mesh)."""
        for group, n in self._row_split:
            x = x.chunk(n, dim=0)[dist.get_rank(group)]
        return x

    def _mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The batch's loss from each rank's loss over its rows."""
        loss = loss.detach().clone()
        for group, n in self._row_split:
            dist.all_reduce(loss, group=group)
            loss = loss / n
        return loss

    # -- checkpoint / resume ------------------------------------------------

    def _ckpt_state(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "train_step": self._train_step.state_dict(self.model),
            "step": self.step,
            "rng": self.rng.get_state(),
        }

    def save(self, root: str | None = None) -> str:
        """Save the full training state to ``root/step_{step}``; returns the path."""
        from .checkpoint import save_checkpoint

        root = root or self.tcfg.checkpoint_dir
        if root is None:
            raise ValueError("no checkpoint dir: pass root= or set tcfg.checkpoint_dir")
        path = pathlib.Path(root).resolve() / f"step_{self.step}"
        save_checkpoint(path, self._ckpt_state())
        return str(path)

    def resume(self, root: str | None = None) -> int | None:
        """Restore from the latest ``step_*`` checkpoint under root.

        Returns the restored step (``fit`` continues from there, with the
        schedule's count restored) or None if no checkpoint exists."""
        from .checkpoint import latest_step_dir, restore_checkpoint

        root = root or self.tcfg.checkpoint_dir
        if root is None:
            raise ValueError("no checkpoint dir: pass root= or set tcfg.checkpoint_dir")
        path = latest_step_dir(root)
        if path is None:
            return None
        state = restore_checkpoint(path, map_location=self.model.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._train_step.load_state_dict(self.model, state["train_step"])
        self.step = int(state["step"])
        self.rng.set_state(state["rng"].cpu())
        return self.step

    def fit(
        self,
        train_batches: Iterator,
        *,
        val_batches: Callable[[], Iterator] | None = None,
        log: Callable[[str], None] = print,
        metrics=None,
    ) -> list[dict]:
        """metrics: optional training.metrics.MetricsLogger (JSONL/wandb).

        An exception is recorded to the metrics summary and, when
        checkpointing is configured, the full state is saved at the failure
        point (so `resume` continues from the crash) before it is re-raised.
        """
        try:
            return self._fit(train_batches, val_batches, log, metrics)
        except Exception as exc:
            if metrics is not None:
                metrics.summary({"error": repr(exc)})
            if self.tcfg.checkpoint_dir is not None:
                try:
                    path = self.save()
                    log(f"emergency checkpoint after {exc!r}: {path}")
                except Exception as save_exc:  # noqa: BLE001 - the original error is re-raised below
                    log(f"emergency checkpoint FAILED: {save_exc!r}")
            raise

    def warmup_autotune(self, batch_size: int, seq_len: int | None = None):
        """Tune the attention tiles for this model's training shape on its
        device and cache them (kernels/autotune.py), so that the train
        step's flash_attention picks them up; returns the tiling.  `fit`
        calls this before the first step when tcfg.autotune_blocks is set."""
        from ..kernels.autotune import autotune_for_model

        return autotune_for_model(self.cfg, batch_size, seq_len=seq_len, device=self.model.device)

    def _fit(self, train_batches, val_batches, log, metrics) -> list[dict]:
        t0 = time.time()
        ckpt_every = self.tcfg.checkpoint_every
        tuned = False
        for it in range(self.step, self.tcfg.max_iters):
            idx, targets = next(train_batches)
            if self.tcfg.autotune_blocks and not tuned:
                bs = self.warmup_autotune(idx.shape[0], idx.shape[1])
                log(f"autotuned attention blocks: {bs}")
                tuned = True
            sub = int(torch.randint(0, 2**62, (1,), generator=self.rng))
            loss = self._mean(self._train_step(self.model, self._rows(idx), self._rows(targets), sub))
            self.step = it + 1
            last = it == self.tcfg.max_iters - 1
            if ckpt_every and (self.step % ckpt_every == 0 or last):
                log(f"checkpoint: {self.save()}")
            do_log = it % self.tcfg.log_interval == 0 or last
            do_eval = val_batches is not None and (it % self.tcfg.eval_interval == 0 or last)
            # eval cadence is independent of log cadence: an eval hit always
            # produces a record even off the log grid.
            if do_log or do_eval:
                rec = {"iter": it, "train_loss": float(loss), "wall_s": time.time() - t0}
                if do_eval:
                    vlosses = [
                        float(self._mean(self._eval_step(self.model, self._rows(vi), self._rows(vt))))
                        for _, (vi, vt) in zip(range(self.tcfg.eval_iters), val_batches())
                    ]
                    rec["val_loss"] = sum(vlosses) / max(len(vlosses), 1)
                self.history.append(rec)
                log(f"{rec}")
                if metrics is not None:
                    metrics.log(rec)
        if metrics is not None and self.history:
            metrics.summary({"final": self.history[-1]})
        return self.history


def _row_split(cfg, batch_sharding) -> list:
    """[(group, size)] of the mesh axes a batch's rows are split over by
    `batch_sharding` when the trainer keeps the rows itself (no
    cfg.seq_mesh).  Under cfg.seq_mesh the model takes its part of the
    global batch, so the sharding must be the one its config implies."""
    if batch_sharding is None:
        return []
    from torch.distributed.tensor import Shard

    from ..parallel.mesh import placements

    mesh, placed = batch_sharding
    if cfg.seq_mesh is not None:
        want = placements(cfg.seq_mesh, (cfg.seq_batch_axis, cfg.seq_axis))
        if any(p != w for dim, (p, w) in enumerate(zip(placed, want)) if mesh.size(dim) > 1):
            raise ValueError(f"batch_sharding {tuple(placed)} does not match the config's context parallelism "
                             f"({want}: rows over seq_batch_axis, tokens over seq_axis)")
        return []
    split = []
    for dim, p in enumerate(placed):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError("sharding the tokens of a batch needs cfg.seq_mesh (context parallelism)")
            split.append((mesh.get_group(dim), mesh.size(dim)))
    return split
