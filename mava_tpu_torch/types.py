"""Core type contracts, batched over a leading env axis.

Port of `mava_tpu/types.py`. Where the reference vmaps a per-env function, the
port's environments are batched natively: every field of a `TimeStep` and an
`Observation` has a leading env axis `E`. All containers are NamedTuples (or
dicts), so `torch.utils._pytree` maps over them.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, NamedTuple, Tuple

import torch

Array = torch.Tensor
Metrics = Dict[str, Array]


class StepType(enum.IntEnum):
    """First/mid/last marker for a timestep (dm_env convention)."""

    FIRST = 0
    MID = 1
    LAST = 2


class TimeStep(NamedTuple):
    """A batch of environment transitions.

    step_type (E,) int32; reward and discount (E, num_agents) float32.
    """

    step_type: Array
    reward: Array
    discount: Array
    observation: Any
    extras: Dict[str, Any]

    def first(self) -> Array:
        return self.step_type == StepType.FIRST

    def mid(self) -> Array:
        return self.step_type == StepType.MID

    def last(self) -> Array:
        return self.step_type == StepType.LAST


def _timestep(
    step_type: StepType, reward: Array, discount: float, observation: Any,
    extras: Dict[str, Any], num_agents: int,
) -> TimeStep:
    view = observation.agents_view
    n, device = view.shape[0], view.device
    return TimeStep(
        step_type=torch.full((n,), int(step_type), dtype=torch.int32, device=device),
        reward=reward,
        discount=torch.full((n, num_agents), discount, dtype=torch.float32, device=device),
        observation=observation,
        extras=extras,
    )


def restart(observation: Any, extras: Dict[str, Any], num_agents: int) -> TimeStep:
    """Initial TimeSteps of a batch of episodes."""
    view = observation.agents_view
    reward = torch.zeros(view.shape[0], num_agents, dtype=torch.float32, device=view.device)
    return _timestep(StepType.FIRST, reward, 1.0, observation, extras, num_agents)


def transition(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """Mid-episode TimeSteps."""
    return _timestep(StepType.MID, reward, 1.0, observation, extras, num_agents)


def termination(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """Terminal TimeSteps (discount 0)."""
    return _timestep(StepType.LAST, reward, 0.0, observation, extras, num_agents)


def truncation(
    reward: Array, observation: Any, extras: Dict[str, Any], num_agents: int
) -> TimeStep:
    """Time-limit TimeSteps (last, but discount 1 so bootstrapping continues)."""
    return _timestep(StepType.LAST, reward, 1.0, observation, extras, num_agents)


class Observation(NamedTuple):
    """Per-agent observation (reference `mava_tpu/types.py:111-116`)."""

    agents_view: Array  # (E, num_agents, num_obs_features) or a grid (E, num_agents, R, C, ch)
    action_mask: Array  # (E, num_agents, num_actions) bool
    step_count: Array  # (E, num_agents) int32


class ObservationGlobalState(NamedTuple):
    """Observation with a global state for centralised critics
    (reference `mava_tpu/types.py:119-126`)."""

    agents_view: Array  # (E, num_agents, num_obs_features)
    action_mask: Array  # (E, num_agents, num_actions) bool
    global_state: Array  # (E, num_agents, num_global_state_features) or a grid
    step_count: Array  # (E, num_agents) int32


# What the recurrent networks take: (observation, done), both time-major.
RNNObservation = Tuple[Observation, Array]
RNNGlobalObservation = Tuple[ObservationGlobalState, Array]


class ExperimentOutput(NamedTuple):
    """Output of one learner call (`num_updates_per_eval` updates)."""

    learner_state: Any
    episode_metrics: Metrics
    train_metrics: Metrics
