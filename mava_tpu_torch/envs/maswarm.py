"""MaSwarm: cooperative continuous-action particle control, batched over a
leading env axis (port of `mava_tpu/envs/maswarm.py`).

`spread`: N agents cover N landmarks. The team reward is minus the sum over
landmarks of the distance to the closest agent, minus one per colliding pair
of agents. An action is a 2-D acceleration in [-1, 1]; velocity damping 0.25,
dt 0.1, force scale 5, speed clip 1.3 (MPE's values). An agent observes
[own vel (2), own pos (2), landmarks relative to it (2L), the other agents
relative to it (2(A-1))]. The action mask is all ones. Episodes end only by
truncation at `time_limit` (LAST with discount 1).

`reset_noise` draws the uniform agent and landmark positions in [-1, 1]^2 that
a reset takes; the step draws nothing (`step_noise` returns None).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

_DT = 0.1
_DAMPING = 0.25
_FORCE_SCALE = 5.0
_MAX_SPEED = 1.3
_COLLIDE_DIST = 0.15
_ARENA = 1.0  # agents and landmarks start in [-1, 1]^2


class MaSwarmState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    pos: torch.Tensor  # (E, A, 2)
    vel: torch.Tensor  # (E, A, 2)
    landmarks: torch.Tensor  # (E, L, 2)


class MaSwarmResetNoise(NamedTuple):
    pos: torch.Tensor  # (E, A, 2) uniform on [-1, 1]
    landmarks: torch.Tensor  # (E, L, 2) uniform on [-1, 1]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.norm` over the last axis, in its order: sqrt(sum(x * x))."""
    return torch.sqrt((x * x).sum(-1))


class MaSwarm(ContinuousEnvSpecs):
    """Batched MaSwarm on one device."""

    def __init__(self, num_agents: int = 3, num_landmarks: Optional[int] = None,
                 time_limit: int = 100, device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.num_agents = num_agents
        self.num_landmarks = num_landmarks or num_agents
        self.time_limit = time_limit
        self.action_dim = 2
        self.num_obs_features = 4 + 2 * self.num_landmarks + 2 * (num_agents - 1)
        iota = torch.arange(num_agents, device=dev)
        # Each agent's row of the others, rolled so that self comes first.
        self._roll = (iota[None, :] + iota[:, None]) % num_agents
        self._not_self = ~torch.eye(num_agents, dtype=torch.bool, device=dev)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> MaSwarmResetNoise:
        kw = dict(generator=generator, device=self.device)
        pos = torch.rand(num_envs, self.num_agents, 2, **kw) * (2 * _ARENA) - _ARENA
        landmarks = torch.rand(num_envs, self.num_landmarks, 2, **kw) * (2 * _ARENA) - _ARENA
        return MaSwarmResetNoise(pos, landmarks)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: MaSwarmState) -> Observation:
        e, a = state.pos.shape[:2]
        rel_land = state.landmarks[:, None, :, :] - state.pos[:, :, None, :]  # (E, A, L, 2)
        rel_agents = state.pos[:, None, :, :] - state.pos[:, :, None, :]  # (E, A, A, 2)
        # Drop self (zeros on the diagonal): roll each row so self is first, cut it.
        idx = self._roll[None, :, :, None].expand(e, a, a, 2)
        rel_agents = torch.gather(rel_agents, 2, idx)[:, :, 1:]
        agents_view = torch.cat(
            [state.vel, state.pos, rel_land.reshape(e, a, -1), rel_agents.reshape(e, a, -1)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def _reward(self, state: MaSwarmState) -> torch.Tensor:
        dists = _norm(state.landmarks[:, :, None, :] - state.pos[:, None, :, :])  # (E, L, A)
        cover = -dists.min(dim=2).values.sum(-1)
        agent_dists = _norm(state.pos[:, :, None, :] - state.pos[:, None, :, :])
        colliding = (agent_dists < _COLLIDE_DIST) & self._not_self
        penalty = -colliding.sum((1, 2)) / 2.0  # each pair counted twice
        team = cover + penalty
        return team[:, None].expand(-1, self.num_agents).contiguous()

    def reset(self, noise: MaSwarmResetNoise) -> Tuple[MaSwarmState, TimeStep]:
        e = noise.pos.shape[0]
        state = MaSwarmState(
            step_count=torch.zeros(e, dtype=torch.int32, device=self.device),
            pos=noise.pos,
            vel=torch.zeros_like(noise.pos),
            landmarks=noise.landmarks,
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: MaSwarmState, action: torch.Tensor,
             noise: None = None) -> Tuple[MaSwarmState, TimeStep]:
        action = torch.clamp(action, -1.0, 1.0)
        vel = state.vel * (1.0 - _DAMPING) + action * _FORCE_SCALE * _DT
        speed = _norm(vel)[..., None]
        vel = torch.where(speed > _MAX_SPEED, vel / speed * _MAX_SPEED, vel)
        pos = torch.clamp(state.pos + vel * _DT, -3.0, 3.0)
        step_count = state.step_count + 1
        new_state = MaSwarmState(step_count, pos, vel, state.landmarks)
        reward = self._reward(new_state)
        # Running out of time is a truncation: LAST, and the discount stays 1.
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=torch.where(time_up, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.ones_like(reward),
            observation=self._observe(new_state),
            extras={},
        )
        return new_state, timestep
