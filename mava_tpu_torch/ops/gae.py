"""Generalised Advantage Estimation (port of `mava_tpu/ops/gae.py`).

One implementation, a reverse loop over T of

    gae_t = delta_t + gamma * lambda * (1 - done) * gae_{t+1}

which the reference solves either as an associative scan or as a sequential
scan (`system.gae_impl`, a TPU-compiler workaround this port ignores).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _suffix_linear_scan(c: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """y_t = delta_t + c_t * y_{t+1}, y_T = 0, over axis 0."""
    ys = torch.empty_like(delta)
    y = torch.zeros_like(delta[0])
    for t in reversed(range(delta.shape[0])):
        y = delta[t] + c[t] * y
        ys[t] = y
    return ys


def calculate_gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, targets = advantages + values)."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    not_done = 1.0 - dones.to(rewards.dtype)
    delta = rewards + gamma * next_values * not_done - values
    advantages = _suffix_linear_scan(gamma * gae_lambda * not_done, delta)
    return advantages, advantages + values


def calculate_gae_with_next_done(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_dones: torch.Tensor,
    last_done: torch.Tensor,
    last_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE whose bootstrap at step t is masked by next_dones[t+1] (last_done
    closes the horizon), as the recurrent systems carry it (reference :99-118)."""
    mask_done = torch.cat([next_dones[1:], last_done[None]], dim=0)
    return calculate_gae(rewards, values, mask_done, last_value, gamma, gae_lambda)
