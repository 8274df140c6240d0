"""Categorical action distributions (port of `mava_tpu/distributions.py:25-93`).

Same surface as the reference: `sample`, `sample_from_noise`, `raw_params`,
`log_prob`, `entropy` and `mode`. Randomness comes from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK_NEG = torch.finfo(torch.float32).min


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, drawn as `jax.random.gumbel` draws it:
    -log(-log(U)) with U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


class Categorical:
    """Categorical over the last axis of `logits`."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = gumbel(self.logits.shape, generator, self.logits.device)
        return self.sample_from_noise(noise)

    def sample_from_noise(self, gumbel_noise: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sampling with pre-drawn noise: argmax(logits + g)."""
        return torch.argmax(self.logits + gumbel_noise, dim=-1)

    def raw_params(self) -> torch.Tensor:
        return self.logits

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        log_probs = torch.log_softmax(self.logits, dim=-1)
        # Out-of-range actions clamp, as the reference's one-hot select does (:63).
        value = value.long().clamp(0, self.num_categories - 1)
        return torch.gather(log_probs, -1, value[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        log_probs = torch.log_softmax(self.logits, dim=-1)
        probs = torch.exp(log_probs)
        # 0 * log 0 -> 0 for masked entries.
        plogp = torch.where(probs > 0, probs * log_probs, 0.0)
        return -plogp.sum(-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal-action logits become float32.min (reference `:84-86`)."""
    return torch.where(mask, logits, _MASK_NEG)


class MaskedCategorical(Categorical):
    """Categorical with an action mask applied to the logits."""

    def __init__(self, logits: torch.Tensor, mask: torch.Tensor):
        super().__init__(masked_logits(logits, mask))
