"""SAC state containers (port of `mava_tpu/systems/sac/types.py`).

Parameters are modules (the actor, the Q-networks) and the `log_alpha`
tensor, updated in place by their `ClippedAdam`s; the reference's optax
states are those optimizers.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from mava_tpu_torch.replay import ItemBufferState
from mava_tpu_torch.utils.training import ClippedAdam


class QVals(NamedTuple):
    q1: torch.nn.Module
    q2: torch.nn.Module


class QValsAndTarget(NamedTuple):
    online: QVals
    targets: QVals


class SacParams(NamedTuple):
    actor: torch.nn.Module
    q: QValsAndTarget
    log_alpha: torch.Tensor  # (1, A)


class OptStates(NamedTuple):
    actor: ClippedAdam
    q: ClippedAdam  # over q1 and q2 together: one global-norm clip
    alpha: ClippedAdam


class Transition(NamedTuple):
    """One stored item, per agent; `obs` and `next_obs` hold the global state
    once (`compress_stored_obs`)."""

    obs: Any
    action: torch.Tensor  # (A, act)
    reward: torch.Tensor  # (A,)
    done: torch.Tensor  # (A,) bool: discount == 0
    next_obs: Any  # the terminal observation where the episode ended


class LearnerState(NamedTuple):
    obs: Any
    env_state: Any
    buffer_state: ItemBufferState
    params: SacParams
    opt_states: OptStates
    t: int  # env steps taken, over every env
    key: torch.Generator


class Draws(NamedTuple):
    """What one update (or the explore phase) of SAC draws, to be handed in (a
    test hands in the reference's); a None field is drawn from the learner's
    generator.

    act_noise: (rollout, E, A, act) standard normals of the act samples;
    explore: (explore steps, E, A, act) the explore phase's Uniform[-1, 1]
    actions; rows: (epochs, batch_size) the buffer rows of each epoch;
    q_noise: (epochs, batch_size, A, act) the normals of `update_q`'s next
    actions; actor_noise and alpha_noise: (epochs, policy_update_delay,
    batch_size, A, act) the normals of each actor and each alpha step (read on
    the epochs that update the actor); env_noise: one `env.step_noise` per act
    or explore step.
    """

    act_noise: Optional[torch.Tensor] = None
    explore: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    q_noise: Optional[torch.Tensor] = None
    actor_noise: Optional[torch.Tensor] = None
    alpha_noise: Optional[torch.Tensor] = None
    env_noise: Optional[list] = None


class TrainDraws(NamedTuple):
    """The random numbers of one update's train phase, made before it runs
    (`get_learner_fns`' draw, in the order the epochs' loop draws them), so
    that the train steps read only device tensors. `rows`: (epochs, [S,] B)
    buffer rows; `q_noise`: (epochs, [S,] B, A, act); `actor_noise` and
    `alpha_noise`: ([S,] delay, B, A, act) for each epoch that updates the
    actor (`epoch % policy_update_delay == 0`), in order. [S,] is a stacked
    learner's entry axis."""

    rows: torch.Tensor
    q_noise: torch.Tensor
    actor_noise: torch.Tensor
    alpha_noise: torch.Tensor
