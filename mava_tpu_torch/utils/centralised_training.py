"""Joint actions for centralised critics over continuous actions (port of
`mava_tpu/utils/centralised_training.py`)."""

from __future__ import annotations

import torch


def get_joint_action(actions: torch.Tensor) -> torch.Tensor:
    """(..., A, act) -> (..., A, A*act): every agent's critic sees the joint
    action (any leading axes: a batch, or a stack of entries and a batch)."""
    *lead, agents, act = actions.shape
    return actions.reshape(*lead, 1, agents * act).expand(*lead, agents, agents * act)


def get_updated_joint_actions(old_actions: torch.Tensor, new_actions: torch.Tensor) -> torch.Tensor:
    """For each agent a, the joint action in which every agent plays its
    replayed action but a, who plays its fresh action (MASAC's actor loss):
    agent a's fresh action on the diagonal of (..., A, A, act)."""
    *lead, agents, act = old_actions.shape
    joint = old_actions.reshape(*lead, 1, agents, act).expand(*lead, agents, agents, act)
    diagonal = torch.eye(agents, dtype=torch.bool, device=old_actions.device)[:, :, None]
    joint = torch.where(diagonal, new_actions[..., :, None, :], joint)
    return joint.reshape(*lead, agents, agents * act)
