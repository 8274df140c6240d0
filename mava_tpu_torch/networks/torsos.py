"""Network torsos (port of `mava_tpu/networks/torsos.py`).

Flax infers input widths on first call; here the input's width (`MLPTorso`)
or per-sample shape (`CNNTorso`: rows, cols, channels) is given at
construction, and each torso reports its `out_features`.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

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


def lecun_normal_(w: torch.Tensor, fan_in: int | None = None) -> torch.Tensor:
    """flax `lecun_normal`: a normal truncated at 2 std, rescaled to variance
    1/fan_in (by default fan_in = w.shape[0], the (in, out) layout)."""
    fan_in = w.shape[0] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


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


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int, int]:
    """XLA's "SAME" padding of one spatial dim, as flax's `nn.Conv` defaults to:
    (pad before, pad after, output size). The output has ceil(size / stride)
    entries; the padding that needs is split with the odd one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2, out


class CNNTorso(nn.Module):
    """A stack of square convolutions with flax's "SAME" padding, then the
    trailing (rows, cols, channels) collapsed into one feature axis in that
    order, as `jax.lax.collapse` does (reference `torsos.py:46-75`). Any leading
    dims (time, env, agent, ...) are kept: they are flattened into one batch
    for the convolutions and restored after.

    Inputs are channels-last (..., R, C, ch) as the reference's; each
    convolution runs NCHW with the kernel in PyTorch's (out, in, kh, kw)
    layout. Kernels are flax's default `lecun_normal` on fan_in = kh * kw * in,
    biases zero. With `use_layer_norm` each convolution is followed, before the
    activation, by flax's `LayerNorm(use_scale=False)` over the channels
    (epsilon 1e-6; its bias is `norm_biases.{k}`).

    `compute_dtype="bfloat16"` casts the input, the kernels and their biases to
    bf16 for the convolutions; each LayerNorm computes in float32 and returns
    bf16, as flax's does; the parameters stay float32 and the output is
    float32. The float32 default runs cuDNN's convolutions in full
    fp32: the entry points turn TF32 off (`systems/anakin.py`,
    `start_experiment`), since cuDNN would otherwise run fp32 convolutions as
    TF32.
    """

    def __init__(
        self,
        in_shape: Sequence[int],
        channel_sizes: Sequence[int],
        kernel_sizes: Sequence[int],
        strides: Sequence[int],
        activation: str = "relu",
        use_layer_norm: bool = False,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if len(in_shape) != 3:
            raise ValueError(f"CNNTorso takes (rows, cols, channels) views, not {tuple(in_shape)}")
        if not len(channel_sizes) == len(kernel_sizes) == len(strides):
            raise ValueError("channel_sizes, kernel_sizes and strides differ in length")
        self.compute_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
        rows, cols, channels = in_shape
        self.convs = nn.ModuleList()
        self.pads = []
        for out_channels, kernel, stride in zip(channel_sizes, kernel_sizes, strides):
            conv = nn.Conv2d(channels, out_channels, kernel, stride)
            lecun_normal_(conv.weight, fan_in=kernel * kernel * channels)
            nn.init.zeros_(conv.bias)
            self.convs.append(conv)
            top, bottom, rows = same_padding(rows, kernel, stride)
            left, right, cols = same_padding(cols, kernel, stride)
            self.pads.append((left, right, top, bottom))  # F.pad's order: last dim first
            channels = out_channels
        self.norm_biases = nn.ParameterList(
            nn.Parameter(torch.zeros(c)) for c in (channel_sizes if use_layer_norm else [])
        )
        self.out_shape = (rows, cols, channels)
        self.out_features = rows * cols * channels
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        dtype = self.compute_dtype
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).to(dtype)  # (N, ch, R, C)
        for k, conv in enumerate(self.convs):
            # As flax's Conv: the convolution, then its bias added in the compute dtype.
            x = F.conv2d(F.pad(x, self.pads[k]), conv.weight.to(dtype), None, conv.stride)
            x = x + conv.bias.to(dtype)[:, None, None]
            if len(self.norm_biases):
                # As flax's LayerNorm: normalised and biased in fp32, then cast.
                x = x.permute(0, 2, 3, 1).float()
                x = F.layer_norm(x, x.shape[-1:], None, self.norm_biases[k], eps=1e-6)
                x = x.to(dtype).permute(0, 3, 1, 2)
            x = self._act(x)
        # (N, out, R', C') -> (..., R' * C' * out) in the reference's (R, C, ch) order.
        return x.permute(0, 2, 3, 1).reshape(*lead, self.out_features).to(torch.float32)
