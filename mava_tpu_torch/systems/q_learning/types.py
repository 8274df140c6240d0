"""Q-learning state containers (port of `mava_tpu/systems/q_learning/types.py`).

The reference's containers for its scans (`ActionSelectionState`,
`ActionState`, `TrainState`) have no counterpart: the port's learner is a
Python loop over the same state.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from mava_tpu_torch.replay import TrajectoryBufferState
from mava_tpu_torch.utils.training import ClippedAdam


class Transition(NamedTuple):
    """One stored transition. Both obs and next_obs are kept because the
    auto-reset replaces the terminal observation with the reset one."""

    obs: Any
    action: torch.Tensor
    reward: torch.Tensor
    terminal: torch.Tensor  # (1,) true termination (discount == 0)
    term_or_trunc: torch.Tensor  # (1,) timestep.last()
    next_obs: Any


class QNetParams(NamedTuple):
    online: torch.nn.Module
    target: torch.nn.Module


class LearnerState(NamedTuple):
    # Interaction
    obs: Any
    terminal: torch.Tensor  # (E, 1) bool
    term_or_trunc: torch.Tensor  # (E, 1) bool
    hidden_state: torch.Tensor  # (E, A, H)
    env_state: Any
    time_steps: int  # env steps taken, over every env
    # Training
    train_steps: int
    opt_state: ClippedAdam
    # Shared
    buffer_state: TrajectoryBufferState
    params: QNetParams
    key: torch.Generator


class Draws(NamedTuple):
    """What one update of rec-IQL draws, to be handed in (a test hands in the
    reference's); a None field is drawn from the learner's generator.

    action_noise: (rollout, E, A, actions) Gumbel noise of the epsilon-greedy
    samples; env_noise: one `env.step_noise` per rollout step; rows and starts:
    (epochs, sample_batch_size) the buffer's sequences of each epoch.
    """

    action_noise: Optional[torch.Tensor] = None
    env_noise: Optional[list] = None
    rows: Optional[torch.Tensor] = None
    starts: Optional[torch.Tensor] = None
