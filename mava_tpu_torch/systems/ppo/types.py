"""PPO-family state containers (port of `mava_tpu/systems/ppo/types.py`).

In PyTorch the parameters live in `nn.Module`s and the optimizer state in the
optimizer objects, so `Params` holds the modules and `OptStates` the
optimizers; both are updated in place. The JAX key becomes a `torch.Generator`.

An update is its inputs (`UpdateInputs`: the carry by value and the draws)
and a body on device tensors (`ff_ippo.py`, `rec_ippo.py`), which a CUDA
graph captures on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

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


class Carry(NamedTuple):
    """What the rollout carries from step to step, and an update to the next:
    the env state and the last timestep; for the recurrent systems also the
    last done flags and both hidden states (None for the feed-forward ones)."""

    env_state: Any
    timestep: Any
    dones: Optional[torch.Tensor] = None  # (E, A) bool
    hstates: Optional[HiddenStates] = None


class Draws(NamedTuple):
    """What one PPO update draws, to be handed in (a test hands in the
    reference's); a None field is drawn from the learner's generator.

    noise: (rollout, E, A, actions) the rollout's sampling noise (Gumbel or
    normal); env_noise: one `env.step_noise` per rollout step; permutations:
    (epochs, rows) the epochs' shuffles (rows are T * E feed-forward, whole
    sequences recurrent); entropy_noise: (epochs, minibatches, *loc) the
    standard normals of a tanh-Normal's entropy estimate.
    """

    noise: Optional[torch.Tensor] = None
    env_noise: Optional[List[Any]] = None
    permutations: Optional[torch.Tensor] = None
    entropy_noise: Optional[torch.Tensor] = None


class UpdateInputs(NamedTuple):
    """Every input of a PPO update's body besides the parameters and the
    optimizers: the carry, copied in by value, and the draws in the order an
    update takes them (the sampling noise, each rollout step's env noise, the
    epochs' shuffles, then a tanh-Normal's entropy normals, one a minibatch;
    None for a discrete head, whose entropy draws nothing)."""

    carry: Carry
    noise: torch.Tensor
    env_noise: List[Any]
    permutations: torch.Tensor
    entropy_noise: Optional[torch.Tensor]
