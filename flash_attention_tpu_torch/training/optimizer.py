"""Optimizer construction, as the JAX package's `training/optimizer.py`.

* AdamW (betas 0.9 / 0.95, eps 1e-8) with weight decay 0.1 applied only to
  tensors with >= 2 dims: the embeddings and the matmul weights, not the
  biases or LayerNorm parameters (`decay_mask`).  Decay is decoupled and
  scaled by the learning rate in both frameworks.
* `cosine_schedule`: linear warmup from 0 then cosine decay to min_lr,
  equal to `optax.warmup_cosine_decay_schedule` as the JAX package calls
  it: the count starts at 0 (so the first update's rate is 0), peaks at
  `warmup_iters`, and `decay_steps` counts the warmup.
* Clipping by global norm happens in the train step
  (`torch.nn.utils.clip_grad_norm_`), where the JAX chain has
  `optax.clip_by_global_norm`.

`torch.optim.AdamW(fused=True)` on CUDA takes the place of the JAX
package's `fused_clip_adamw`, which is not ported.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def cosine_schedule(
    learning_rate: float,
    warmup_iters: int,
    lr_decay_iters: int,
    min_lr: float,
) -> Callable[[int], float]:
    """Learning rate of update `count` (0-based): optax's
    warmup_cosine_decay_schedule(init_value=0, peak_value=learning_rate,
    warmup_steps=max(warmup_iters, 1), decay_steps=max(lr_decay_iters,
    warmup_iters + 1), end_value=min_lr)."""
    warmup = max(warmup_iters, 1)
    decay = max(lr_decay_iters, warmup_iters + 1) - warmup
    alpha = min_lr / learning_rate if learning_rate else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            return learning_rate * count / warmup
        done = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * done / decay))
        return learning_rate * ((1.0 - alpha) * cosine + alpha)

    return schedule


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """True for >= 2-D parameters (decayed), by parameter name."""
    return {name: p.dim() >= 2 for name, p in model.named_parameters()}


def make_optimizer(
    model: nn.Module,
    learning_rate: float = 3e-4,
    *,
    weight_decay: float = 0.1,
    beta1: float = 0.9,
    beta2: float = 0.95,
    warmup_iters: int = 100,
    lr_decay_iters: int = 2000,
    min_lr: float | None = None,
) -> tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(AdamW over the model's parameters in two groups, schedule).  The
    caller sets each group's lr to schedule(count) before update `count`.
    fused=True when the parameters lie on a CUDA device."""
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [params[n] for n, d in mask.items() if d], "weight_decay": weight_decay},
        {"params": [params[n] for n, d in mask.items() if not d], "weight_decay": 0.0},
    ]
    fused = next(iter(params.values())).device.type == "cuda"
    opt = torch.optim.AdamW(groups, lr=0.0, betas=(beta1, beta2), eps=1e-8, fused=fused)
    schedule = cosine_schedule(
        learning_rate, warmup_iters, lr_decay_iters, min_lr if min_lr is not None else learning_rate / 10
    )
    return opt, schedule
