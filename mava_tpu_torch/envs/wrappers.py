"""Environment wrappers over batched environments.

Port of `mava_tpu/envs/wrappers.py`: the global state of centralised critics,
AgentID one-hot concat, auto-reset with `real_next_obs` in extras, and
episode-metric recording. The reference's
per-env `lax.cond` auto-reset becomes a `torch.where` over the env axis: every
step also computes a reset for every env and keeps it where the episode ended
(the cost profile of the reference's vmapped select).

Randomness follows the wrapped env's split into noise and dynamics:
`step_noise(E, generator)` returns what `step` consumes, so tests can inject it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.types import ObservationGlobalState, TimeStep

OBS_IN_EXTRAS_KEY = "real_next_obs"


class Wrapper:
    """Base wrapper: forwards everything to the wrapped env."""

    def __init__(self, env: Any):
        self._env = env
        self.num_agents = env.num_agents
        self.time_limit = env.time_limit
        self.action_dim = env.action_dim

    def __getattr__(self, name: str) -> Any:
        return getattr(self._env, name)

    def reset_noise(self, num_envs: int, generator: torch.Generator) -> Any:
        return self._env.reset_noise(num_envs, generator)

    def step_noise(self, num_envs: int, generator: torch.Generator) -> Any:
        return self._env.step_noise(num_envs, generator)

    def reset(self, noise: Any) -> Tuple[Any, TimeStep]:
        return self._env.reset(noise)

    def step(self, state: Any, action: torch.Tensor, noise: Any) -> Tuple[Any, TimeStep]:
        return self._env.step(state, action, noise)


def obs_shape(env: Any) -> Tuple[int, ...]:
    """The shape of one agent's view: (features,) for a vector view, or the
    env's `obs_shape`, (rows, cols, channels), for a grid view."""
    shape = getattr(env, "obs_shape", None)
    return tuple(shape) if shape is not None else (env.num_obs_features,)


class GlobalStateWrapper(Wrapper):
    """Adds a global state for centralised critics: every agent's view,
    flattened and concatenated per env, tiled to one copy per agent
    (reference `wrappers.py:65-117`). An env's own
    `get_global_state(obs, state)` takes its place where there is one, and then
    the env also says its shape per agent (`global_state_shape`, a grid's) or
    width (`num_global_state_features`).
    """

    @property
    def global_state_shape(self) -> Tuple[int, ...]:
        if hasattr(self._env, "get_global_state"):
            shape = getattr(self._env, "global_state_shape", None)
            return tuple(shape) if shape is not None else (self._env.num_global_state_features,)
        return (self.num_agents * math.prod(obs_shape(self._env)),)

    @property
    def num_global_state_features(self) -> int:
        return math.prod(self.global_state_shape)

    def _add_global_state(self, timestep: TimeStep, state: Any) -> TimeStep:
        obs = timestep.observation
        if hasattr(self._env, "get_global_state"):
            global_state = self._env.get_global_state(obs, state)
        else:
            flat = obs.agents_view.flatten(1)  # (E, A * F)
            global_state = flat[:, None, :].expand(-1, self.num_agents, -1)
        observation = ObservationGlobalState(
            agents_view=obs.agents_view,
            action_mask=obs.action_mask,
            global_state=global_state,
            step_count=obs.step_count,
        )
        return timestep._replace(observation=observation)

    def reset(self, noise: Any) -> Tuple[Any, TimeStep]:
        state, timestep = self._env.reset(noise)
        return state, self._add_global_state(timestep, state)

    def step(self, state: Any, action: torch.Tensor, noise: Any) -> Tuple[Any, TimeStep]:
        state, timestep = self._env.step(state, action, noise)
        return state, self._add_global_state(timestep, state)


class AgentIDWrapper(Wrapper):
    """Concatenates a one-hot agent id onto `agents_view`
    (reference `wrappers.py:120-144`). Vector views only: the grid envs see
    their own position in their view (`env.implicit_agent_id`), and the
    reference's concatenation fails on a grid view too."""

    def __init__(self, env: Any):
        if len(obs_shape(env)) != 1:
            raise ValueError(
                f"AgentIDWrapper takes vector views, not {obs_shape(env)}: "
                "set env.implicit_agent_id=True for a grid env."
            )
        super().__init__(env)

    @property
    def num_obs_features(self) -> int:
        return self._env.num_obs_features + self.num_agents

    def _add_ids(self, timestep: TimeStep) -> TimeStep:
        obs = timestep.observation
        view = obs.agents_view
        ids = torch.eye(self.num_agents, dtype=view.dtype, device=view.device)
        ids = ids.expand(view.shape[0], -1, -1)
        new_view = torch.cat([ids, view], dim=-1)
        return timestep._replace(observation=obs._replace(agents_view=new_view))

    def reset(self, noise: Any) -> Tuple[Any, TimeStep]:
        state, timestep = self._env.reset(noise)
        return state, self._add_ids(timestep)

    def step(self, state: Any, action: torch.Tensor, noise: Any) -> Tuple[Any, TimeStep]:
        state, timestep = self._env.step(state, action, noise)
        return state, self._add_ids(timestep)


def _select_envs(done: torch.Tensor, if_done: Any, otherwise: Any) -> Any:
    """Per-env select over two pytrees whose leaves lead with the env axis."""

    def sel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(done.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    return pytree.tree_map(sel, if_done, otherwise)


class AutoResetWrapper(Wrapper):
    """Resets each env whose episode ended, inside the step.

    The terminal observation is kept in `extras["real_next_obs"]`; the
    timestep's observation becomes the reset observation (reference
    `wrappers.py:147-176`). `step_noise` is the pair (inner step noise, reset
    noise).
    """

    def step_noise(self, num_envs: int, generator: torch.Generator) -> Any:
        return (
            self._env.step_noise(num_envs, generator),
            self._env.reset_noise(num_envs, generator),
        )

    @staticmethod
    def _obs_in_extras(timestep: TimeStep) -> TimeStep:
        extras = dict(timestep.extras)
        extras[OBS_IN_EXTRAS_KEY] = timestep.observation
        return timestep._replace(extras=extras)

    def reset(self, noise: Any) -> Tuple[Any, TimeStep]:
        state, timestep = self._env.reset(noise)
        return state, self._obs_in_extras(timestep)

    def step(self, state: Any, action: torch.Tensor, noise: Any) -> Tuple[Any, TimeStep]:
        step_noise, reset_noise = noise
        state, timestep = self._env.step(state, action, step_noise)
        timestep = self._obs_in_extras(timestep)
        reset_state, reset_timestep = self._env.reset(reset_noise)
        done = timestep.last()
        state = _select_envs(done, reset_state, state)
        observation = _select_envs(
            done, reset_timestep.observation, timestep.observation
        )
        return state, timestep._replace(observation=observation)


class RecordEpisodeMetricsState(NamedTuple):
    env_state: Any
    running_count_episode_return: torch.Tensor  # (E,) float32
    running_count_episode_length: torch.Tensor  # (E,) int32
    episode_return: torch.Tensor
    episode_length: torch.Tensor


class RecordEpisodeMetrics(Wrapper):
    """Tracks episode return/length and emits them in `extras["episode_metrics"]`
    (reference `wrappers.py:189-241`)."""

    def reset(self, noise: Any) -> Tuple[RecordEpisodeMetricsState, TimeStep]:
        state, timestep = self._env.reset(noise)
        e = timestep.step_type.shape[0]
        dev = timestep.step_type.device
        zf = torch.zeros(e, dtype=torch.float32, device=dev)
        zi = torch.zeros(e, dtype=torch.int32, device=dev)
        wrapped = RecordEpisodeMetricsState(state, zf, zi, zf, zi)
        extras = dict(timestep.extras)
        extras["episode_metrics"] = {
            "episode_return": zf,
            "episode_length": zi,
            "is_terminal_step": torch.zeros(e, dtype=torch.bool, device=dev),
        }
        return wrapped, timestep._replace(extras=extras)

    def step(
        self, state: RecordEpisodeMetricsState, action: torch.Tensor, noise: Any
    ) -> Tuple[RecordEpisodeMetricsState, TimeStep]:
        env_state, timestep = self._env.step(state.env_state, action, noise)
        done = timestep.last()
        new_return = state.running_count_episode_return + timestep.reward.mean(-1)
        new_length = state.running_count_episode_length + 1
        episode_return = torch.where(done, new_return, state.episode_return)
        episode_length = torch.where(done, new_length, state.episode_length)
        extras = dict(timestep.extras)
        extras["episode_metrics"] = {
            "episode_return": episode_return,
            "episode_length": episode_length,
            "is_terminal_step": done,
        }
        state = RecordEpisodeMetricsState(
            env_state=env_state,
            running_count_episode_return=torch.where(done, 0.0, new_return),
            running_count_episode_length=torch.where(
                done, torch.zeros_like(new_length), new_length
            ),
            episode_return=episode_return,
            episode_length=episode_length,
        )
        return state, timestep._replace(extras=extras)


def get_final_step_metrics(
    metrics: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, np.ndarray], bool]:
    """Metrics at terminal steps, as host arrays for logging
    (reference `wrappers.py:244-266`)."""
    metrics = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    is_final_ep = metrics.pop("is_terminal_step")
    has_final_ep_step = bool(np.any(is_final_ep))
    if not has_final_ep_step:
        return {k: np.zeros_like(v) for k, v in metrics.items()}, False
    return {k: v[is_final_ep] for k, v in metrics.items()}, True
