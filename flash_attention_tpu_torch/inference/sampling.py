"""Token sampling: greedy, temperature, top-k, top-p (nucleus).

Port of `flash_attention_tpu/inference/sampling.py`.  Randomness comes from
an explicit `torch.Generator` on the logits' device.  Its stream differs
from `jax.random`'s for the same seed, so sampled tokens are compared
between the packages by their support, not token by token.
"""

from __future__ import annotations

import torch


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick, as
    jax.random.categorical does; -inf logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def _top_p_filter(
    scaled: torch.Tensor, top_p: torch.Tensor, sorted_desc: torch.Tensor | None = None
) -> torch.Tensor:
    """Mask logits outside the nucleus: keep the smallest set of tokens whose
    cumulative probability reaches top_p [batch] (the most probable token
    always stays).  scaled [batch, vocab], already divided by temperature;
    `sorted_desc` reuses a descending sort."""
    if sorted_desc is None:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_n = ((cum - probs) < top_p[:, None]).sum(dim=-1)
    keep_n = keep_n.clamp(1, scaled.shape[-1])
    kth = torch.gather(sorted_desc, -1, (keep_n - 1)[:, None])
    return torch.where(scaled < kth, -torch.inf, scaled)


def sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """logits [batch, vocab] -> token ids [batch]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        logits = _top_p_filter(logits, torch.full((logits.shape[0],), top_p, device=logits.device))
    return _categorical(logits, generator)


def sample_tokens(
    logits: torch.Tensor,
    generator: torch.Generator,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot sampling on the device, with no host sync.

    logits [slots, vocab]; temperature [slots] (<= 0 means greedy); top_k
    [slots] int (the vocab size disables it); top_p [slots] float (1.0
    disables it), or None to skip the nucleus work for every slot.
    """
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.where(temperature <= 0.0, 1.0, temperature)[:, None]
    scaled = logits / temp
    k = top_k.clamp(1, vocab).long()
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    filtered = torch.where(scaled < kth, -torch.inf, scaled)
    if top_p is not None:
        # entries past each slot's k become -inf, which sort to the tail
        col = torch.arange(vocab, device=logits.device)[None, :]
        sorted_f = torch.where(col < k[:, None], sorted_desc, -torch.inf)
        filtered = _top_p_filter(filtered, top_p.clamp(1e-6, 1.0), sorted_desc=sorted_f)
    sampled = _categorical(filtered, generator)
    return torch.where(temperature <= 0.0, greedy, sampled)
