"""Action heads (port of `mava_tpu/networks/heads.py`)."""

from __future__ import annotations

import torch
from torch import nn

from mava_tpu_torch.distributions import MaskedCategorical
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
