"""Network torsos (port of `mava_tpu/networks/torsos.py`).

Flax infers input widths on first call; here `in_features` is given at
construction.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def parse_activation_fn(name: str):
    return {"relu": torch.relu, "tanh": torch.tanh}[name]


def orthogonal_linear(in_features: int, out_features: int, scale: float) -> nn.Linear:
    """`nn.Linear` with flax's `orthogonal(scale)` kernel and a zero bias."""
    layer = nn.Linear(in_features, out_features)
    nn.init.orthogonal_(layer.weight, gain=scale)
    nn.init.zeros_(layer.bias)
    return layer


class MLPTorso(nn.Module):
    """A stack of Dense layers with orthogonal(sqrt(2)) kernels."""

    def __init__(
        self,
        in_features: int,
        layer_sizes: Sequence[int],
        activation: str = "relu",
        use_layer_norm: bool = False,
    ):
        super().__init__()
        if use_layer_norm:
            raise NotImplementedError(
                "MLPTorso(use_layer_norm=True) is not yet ported to mava_tpu_torch."
            )
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            orthogonal_linear(i, o, math.sqrt(2)) for i, o in zip(sizes[:-1], sizes[1:])
        )
        self.out_features = sizes[-1]
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self._act(layer(x))
        return x
