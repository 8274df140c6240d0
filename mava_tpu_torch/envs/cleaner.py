"""Cleaner: cooperative grid cleaning, batched over a leading env axis (port of
`mava_tpu/envs/cleaner.py`).

A maze whose free tiles all start dirty; every tile an agent enters is
cleaned; the team reward is the number of tiles newly cleaned in the step
(a tile entered by two agents counts once); the episode is won, and
terminates (discount 0), when the grid is clean, and is truncated (discount
1) at `time_limit`. The maze is a pillar lattice: walls at odd/odd
coordinates. Every agent starts at the top-left corner, whose tile starts
clean. Actions 0 = up, 1 = right, 2 = down, 3 = left; a move out of bounds or
into a wall is masked, and a masked move leaves the agent where it is.

Each agent views the whole grid (R, C, 4): [dirty, wall, every agent's
position, its own position], float32. The global state is the first three
channels.

The reset is deterministic and a step draws nothing: `reset_noise` and
`step_noise` return None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mava_tpu_torch.specs import DiscreteEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

NUM_ACTIONS = 4
_MOVES = ((-1, 0), (0, 1), (1, 0), (0, -1))  # up, right, down, left


class CleanerState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    agent_pos: torch.Tensor  # (E, A, 2) int64
    dirty: torch.Tensor  # (E, R, C) bool


class Cleaner(DiscreteEnvSpecs):
    """Batched Cleaner on one device."""

    def __init__(self, num_rows: int = 10, num_cols: int = 10, num_agents: int = 3,
                 time_limit: int = 100, device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.num_rows, self.num_cols = num_rows, num_cols
        self.num_agents = num_agents
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        self.obs_shape = (num_rows, num_cols, 4)
        self.global_state_shape = (num_rows, num_cols, 3)
        rows = torch.arange(num_rows, device=dev)[:, None]
        cols = torch.arange(num_cols, device=dev)[None, :]
        self._wall = (rows % 2 == 1) & (cols % 2 == 1)  # (R, C)
        init_dirty = ~self._wall
        init_dirty[0, 0] = False  # the start tile is clean
        self._init_dirty = init_dirty
        self._moves = torch.tensor(_MOVES, device=dev)
        # What the step writes into its grids, on the device: a Python value
        # written by index is copied from the host, which a CUDA graph refuses.
        self._one = torch.ones((), device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._limits = torch.tensor([num_rows - 1, num_cols - 1], device=dev)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> int:
        # Nothing is drawn; the reset only needs to know how many envs.
        return num_envs

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _legal(self, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(in bounds and not a wall, the target clamped into the grid)."""
        in_bounds = ((targets >= 0) & (targets <= self._limits)).all(-1)
        safe = torch.minimum(targets.clamp(min=0), self._limits)
        return in_bounds & ~self._wall[safe[..., 0], safe[..., 1]], safe

    def _observe(self, state: CleanerState) -> Observation:
        e, a = state.agent_pos.shape[:2]
        r, c = self.num_rows, self.num_cols
        own = torch.zeros(e, a, r, c, device=self.device)
        env_idx = torch.arange(e, device=self.device)[:, None].expand(e, a)
        agent_idx = torch.arange(a, device=self.device)[None, :].expand(e, a)
        own[env_idx, agent_idx, state.agent_pos[..., 0], state.agent_pos[..., 1]] = self._one
        agents = own.sum(1, keepdim=True).expand(e, a, r, c)
        dirty = state.dirty.float()[:, None].expand(e, a, r, c)
        wall = self._wall.float().expand(e, a, r, c)
        view = torch.stack([dirty, wall, agents, own], dim=-1)  # (E, A, R, C, 4)
        mask, _ = self._legal(state.agent_pos[:, :, None, :] + self._moves)  # (E, A, 4)
        return Observation(view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, num_envs: int) -> Tuple[CleanerState, TimeStep]:
        dev = self.device
        state = CleanerState(
            step_count=torch.zeros(num_envs, dtype=torch.int32, device=dev),
            agent_pos=torch.zeros(num_envs, self.num_agents, 2, dtype=torch.int64, device=dev),
            dirty=self._init_dirty.expand(num_envs, -1, -1).clone(),
        )
        extras = {"won_episode": torch.zeros(num_envs, dtype=torch.bool, device=dev)}
        return state, restart(self._observe(state), extras, self.num_agents)

    def step(self, state: CleanerState, action: torch.Tensor,
             noise: None = None) -> Tuple[CleanerState, TimeStep]:
        action = action.long().clamp(0, NUM_ACTIONS - 1)
        valid, safe = self._legal(state.agent_pos + self._moves[action])
        agent_pos = torch.where(valid[..., None], safe, state.agent_pos)
        e = agent_pos.shape[0]
        occupied = torch.zeros_like(state.dirty)
        env_idx = torch.arange(e, device=self.device)[:, None].expand_as(agent_pos[..., 0])
        occupied[env_idx, agent_pos[..., 0], agent_pos[..., 1]] = self._true
        dirty = state.dirty & ~occupied
        num_cleaned = state.dirty.sum((1, 2)) - dirty.sum((1, 2))
        reward = num_cleaned.float()[:, None].expand(e, self.num_agents).contiguous()
        step_count = state.step_count + 1
        new_state = CleanerState(step_count, agent_pos, dirty)
        # A clean grid terminates the episode (discount 0); time up truncates it.
        all_clean = ~dirty.any(2).any(1)
        done = all_clean | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.where(all_clean, 0.0, 1.0)[:, None].expand(e, self.num_agents).contiguous(),
            observation=self._observe(new_state),
            extras={"won_episode": all_clean},
        )
        return new_state, timestep

    def get_global_state(self, obs: Observation, state: CleanerState) -> torch.Tensor:
        return obs.agents_view[..., :3]
