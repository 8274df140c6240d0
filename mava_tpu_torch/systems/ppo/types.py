"""PPO-family state containers (port of `mava_tpu/systems/ppo/types.py`).

In PyTorch the parameters live in `nn.Module`s and the optimizer state in the
optimizer objects, so `Params` holds the modules and `OptStates` the
optimizers; both are updated in place. The JAX key becomes a `torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


class Params(NamedTuple):
    actor_params: Any  # FeedForwardActor or RecurrentActor
    critic_params: Any  # FeedForwardValueNet or RecurrentValueNet


class OptStates(NamedTuple):
    actor_opt_state: Any  # utils.training.ClippedAdam
    critic_opt_state: Any


class HiddenStates(NamedTuple):
    policy_hidden_state: torch.Tensor
    critic_hidden_state: torch.Tensor


class LearnerState(NamedTuple):
    """State carried from one feed-forward PPO update to the next."""

    params: Params
    opt_states: OptStates
    key: torch.Generator
    env_state: Any
    timestep: Any


class RNNLearnerState(NamedTuple):
    """State carried from one recurrent PPO update to the next."""

    params: Params
    opt_states: OptStates
    key: torch.Generator
    env_state: Any
    timestep: Any
    dones: torch.Tensor  # (num_envs, num_agents) bool: done of the last timestep
    hstates: HiddenStates


class PPOTransition(NamedTuple):
    done: torch.Tensor
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    log_prob: torch.Tensor
    obs: Any
    info: Dict


class RNNPPOTransition(NamedTuple):
    done: torch.Tensor
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    log_prob: torch.Tensor
    obs: Any
    hstates: HiddenStates
    info: Dict
