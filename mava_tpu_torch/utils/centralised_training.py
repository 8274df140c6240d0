"""Joint actions for centralised critics over continuous actions (port of
`mava_tpu/utils/centralised_training.py`)."""

from __future__ import annotations

import torch


def get_joint_action(actions: torch.Tensor) -> torch.Tensor:
    """(B, A, act) -> (B, A, A*act): every agent's critic sees the joint action."""
    batch, agents, act = actions.shape
    return actions.reshape(batch, 1, agents * act).expand(batch, agents, agents * act)


def get_updated_joint_actions(old_actions: torch.Tensor, new_actions: torch.Tensor) -> torch.Tensor:
    """For each agent a, the joint action in which every agent plays its
    replayed action but a, who plays its fresh action (MASAC's actor loss):
    agent a's fresh action on the diagonal of (B, A, A, act)."""
    batch, agents, act = old_actions.shape
    joint = old_actions.reshape(batch, 1, agents, act).expand(batch, agents, agents, act)
    diagonal = torch.eye(agents, dtype=torch.bool, device=old_actions.device)[None, :, :, None]
    joint = torch.where(diagonal, new_actions[:, :, None, :], joint)
    return joint.reshape(batch, agents, agents * act)
