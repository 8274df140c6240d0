"""PPO loss primitives (port of `mava_tpu/ops/losses.py`)."""

from __future__ import annotations

import torch


def clipped_ppo_policy_loss(
    log_prob: torch.Tensor,
    old_log_prob: torch.Tensor,
    gae: torch.Tensor,
    clip_eps: float,
) -> torch.Tensor:
    """Clipped PPO surrogate with per-minibatch advantage normalisation
    (population std, as `jnp.std`)."""
    ratio = torch.exp(log_prob - old_log_prob)
    gae = (gae - gae.mean()) / (gae.std(correction=0) + 1e-8)
    loss1 = ratio * gae
    loss2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * gae
    return -torch.minimum(loss1, loss2).mean()


def clipped_value_loss(
    value: torch.Tensor,
    old_value: torch.Tensor,
    targets: torch.Tensor,
    clip_eps: float,
) -> torch.Tensor:
    """0.5 * max(unclipped, clipped) squared error."""
    value_clipped = old_value + torch.clamp(value - old_value, -clip_eps, clip_eps)
    losses = torch.square(value - targets)
    losses_clipped = torch.square(value_clipped - targets)
    return 0.5 * torch.maximum(losses, losses_clipped).mean()
