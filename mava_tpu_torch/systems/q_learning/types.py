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


class Carry(NamedTuple):
    """What the act steps carry from step to step, and an update to the next."""

    obs: Any
    terminal: torch.Tensor  # (E, 1) bool
    term_or_trunc: torch.Tensor  # (E, 1) bool
    hidden_state: torch.Tensor  # (E, A, H)
    env_state: Any


class UpdateInputs(NamedTuple):
    """Every input of an update's body besides the parameters, the optimizer
    and the ring: the carry, copied in by value, and the draws, with what the
    host counters say of this update made into device tensors.

    epsilon: (rollout,) each act step's epsilon; positions: (rollout,) the ring
    position each act step writes; rows and starts: (epochs, sample_batch_size)
    the sequences of each epoch, their starts as ring positions; replace:
    (epochs,) bool, whether a hard update replaces the target after each
    epoch's step (None with the soft update). A stacked program's inputs put
    the entry axis in front of the carry's, the action noise's and the
    sequences' ((S, epochs, sample_batch_size)); the epsilons, positions and
    flags serve every entry.
    """

    carry: Carry
    action_noise: torch.Tensor
    env_noise: list
    epsilon: torch.Tensor
    positions: torch.Tensor
    rows: torch.Tensor
    starts: torch.Tensor
    replace: Optional[torch.Tensor]


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
