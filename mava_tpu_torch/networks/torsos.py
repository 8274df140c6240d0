"""Network torsos (port of `mava_tpu/networks/torsos.py`).

Flax infers input widths on first call; here `in_features` is given at
construction.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
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
    """A stack of Dense layers with orthogonal(sqrt(2)) kernels.

    With `use_layer_norm` each Dense is followed, before the activation, by
    flax's `LayerNorm(use_scale=False)`: a bias and no scale, epsilon 1e-6. The
    biases are `norm_biases.{k}`, beside `layers.{k}` of the k-th Dense.
    """

    def __init__(
        self,
        in_features: int,
        layer_sizes: Sequence[int],
        activation: str = "relu",
        use_layer_norm: bool = False,
    ):
        super().__init__()
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            orthogonal_linear(i, o, math.sqrt(2)) for i, o in zip(sizes[:-1], sizes[1:])
        )
        self.norm_biases = nn.ParameterList(
            nn.Parameter(torch.zeros(o)) for o in (sizes[1:] if use_layer_norm else [])
        )
        self.out_features = sizes[-1]
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k, layer in enumerate(self.layers):
            x = layer(x)
            if len(self.norm_biases):
                x = F.layer_norm(x, x.shape[-1:], None, self.norm_biases[k], eps=1e-6)
            x = self._act(x)
        return x
