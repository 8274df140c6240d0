"""Categorical action distributions (port of `mava_tpu/distributions.py:25-93`
and `:182-212`).

Same surface as the reference: `sample`, `sample_from_noise`, `raw_params`,
`log_prob`, `entropy` and `mode`. Randomness comes from an explicit
`torch.Generator`, or is handed in as Gumbel noise.
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


def masked_greedy(q_values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Greedy masked argmax over the last axis: `MaskedEpsGreedy.mode()` without
    building the distribution (the fused double-DQN target pass)."""
    return torch.argmax(torch.where(mask, q_values, _MASK_NEG), dim=-1)


class MaskedEpsGreedy(Categorical):
    """Epsilon-greedy over masked Q-values (reference `distributions.py:187-212`):
    probs = eps * uniform(legal actions) + (1 - eps) * onehot(greedy), kept as the
    logits log(clip(probs, 1e-12)) of the base `Categorical`, so that sampling
    (also at eps = 0) is the Gumbel-max draw the reference makes."""

    def __init__(self, q_values: torch.Tensor, epsilon, mask: torch.Tensor):
        self.q_values = q_values
        mask_f = mask.to(q_values.dtype)
        uniform = mask_f / mask_f.sum(-1, keepdim=True)
        self._greedy = masked_greedy(q_values, mask)
        greedy = torch.nn.functional.one_hot(self._greedy, q_values.shape[-1]).to(q_values.dtype)
        probs = epsilon * uniform + (1.0 - epsilon) * greedy
        super().__init__(torch.log(torch.clamp(probs, min=1e-12)))

    def mode(self) -> torch.Tensor:
        return self._greedy
