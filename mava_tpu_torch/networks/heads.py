"""Action heads (port of `mava_tpu/networks/heads.py`)."""

from __future__ import annotations

import torch
from torch import nn

from mava_tpu_torch.distributions import MaskedCategorical, TanhNormal
from mava_tpu_torch.networks.torsos import orthogonal_linear
from mava_tpu_torch.types import Observation


class DiscreteActionHead(nn.Module):
    """Dense (orthogonal 0.01) -> logits, masked by `observation.action_mask`."""

    def __init__(self, in_features: int, action_dim: int):
        super().__init__()
        self.linear = orthogonal_linear(in_features, action_dim, 0.01)

    def forward(
        self, obs_embedding: torch.Tensor, observation: Observation
    ) -> MaskedCategorical:
        return MaskedCategorical(self.linear(obs_embedding), observation.action_mask)


class ContinuousActionHead(nn.Module):
    """Tanh-squashed Normal head, actions in [-1, 1] (reference `heads.py:30-48`).

    The loc is a Dense (orthogonal 0.01), `linear`. The log-std is a
    zero-initialised parameter `log_std` with `independent_std`, else a second
    Dense `log_std_linear` (orthogonal 0.01) of the embedding, as SAC builds it.
    scale = softplus(log_std) + `min_scale`, the softplus as `logaddexp(., 0)`
    like the reference's.
    """

    def __init__(self, in_features: int, action_dim: int, min_scale: float = 1e-3,
                 independent_std: bool = True):
        super().__init__()
        self.min_scale = min_scale
        self.linear = orthogonal_linear(in_features, action_dim, 0.01)
        if independent_std:
            self.log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            self.log_std_linear = orthogonal_linear(in_features, action_dim, 0.01)

    def forward(self, obs_embedding: torch.Tensor, observation: Observation) -> TanhNormal:
        loc = self.linear(obs_embedding)
        log_std = self.log_std if hasattr(self, "log_std") else self.log_std_linear(obs_embedding)
        scale = torch.logaddexp(log_std, torch.zeros_like(log_std)) + self.min_scale
        return TanhNormal(loc, torch.broadcast_to(scale, loc.shape))
