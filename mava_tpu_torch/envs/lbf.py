"""Level-Based Foraging (LBF), batched over a leading env axis (port of
`mava_tpu/envs/lbf.py`).

Agents and foods on a grid. Actions 0 = noop, 1 = up, 2 = down, 3 = left,
4 = right, 5 = load. A move into a cell held by an agent or an uneaten food,
or out of the grid, fails; two agents that move into one cell both stay. A
food is eaten when the levels of the loading agents orthogonally next to it
sum to at least its level; each of them gets food_level * its level /
(that sum * the sum of every food's level at reset), so a whole episode gives
the team at most 1. With `use_individual_rewards` False every agent gets the
team's sum. The episode terminates (discount 0) when every food is eaten, and
is truncated at `time_limit`.

Each agent observes (y, x, level) of every food, then of every agent (itself
first, then the others in index order), with -1 for what is eaten or out of
its view (Chebyshev distance above `fov`).

`reset_noise(E, generator)` draws what a reset takes (`LbfResetNoise`): (E,
G * G) uniforms, whose n_agents + n_food largest (in descending order with the
lower cell first on a tie, as `jax.lax.top_k`) place the agents and then the
foods; the agent levels, uniform on 1..max_agent_level; the food levels,
uniform on 1..(sum of the three highest agent levels of the env) unless
`force_coop`, where every food's level is the sum of all agent levels and the
drawn ones are not read. A step draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mava_tpu_torch.envs.connector import top_cells
from mava_tpu_torch.specs import DiscreteEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

NOOP, UP, DOWN, LEFT, RIGHT, LOAD = range(6)
NUM_ACTIONS = 6
_MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, 0))
_ADJ = ((-1, 0), (1, 0), (0, -1), (0, 1))


class LbfState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    agent_pos: torch.Tensor  # (E, A, 2) int64
    agent_level: torch.Tensor  # (E, A) int64
    food_pos: torch.Tensor  # (E, F, 2) int64
    food_level: torch.Tensor  # (E, F) int64
    food_eaten: torch.Tensor  # (E, F) bool
    total_food_level: torch.Tensor  # (E,) float32, the reward's normaliser


class LbfResetNoise(NamedTuple):
    cells: torch.Tensor  # (E, G * G) uniforms
    agent_level: torch.Tensor  # (E, A) ints in 1..max_agent_level
    food_level: torch.Tensor  # (E, F) ints; read only when not force_coop


class LevelBasedForaging(DiscreteEnvSpecs):
    """Batched LBF on one device."""

    def __init__(self, grid_size: int = 8, fov: int = 8, num_agents: int = 2, num_food: int = 2,
                 max_agent_level: int = 2, force_coop: bool = False,
                 use_individual_rewards: bool = False, time_limit: int = 100,
                 device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.grid_size = grid_size
        self.fov = fov
        self.num_agents = num_agents
        self.num_food = num_food
        self.max_agent_level = max_agent_level
        self.force_coop = force_coop
        self.use_individual_rewards = use_individual_rewards
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        self.num_obs_features = 3 * num_food + 3 * num_agents
        self._moves = torch.tensor(_MOVES, device=dev)
        self._adj = torch.tensor(_ADJ, device=dev)
        iota = torch.arange(num_agents, device=dev)
        self._self_first = (iota[None, :] + iota[:, None]) % num_agents  # row i: i, i+1, ...
        self._other = ~torch.eye(num_agents, dtype=torch.bool, device=dev)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> LbfResetNoise:
        kw = dict(generator=generator, device=self.device)
        cells = torch.rand(num_envs, self.grid_size ** 2, **kw)
        agent_level = torch.randint(1, self.max_agent_level + 1, (num_envs, self.num_agents), **kw)
        # The food's upper bound differs from env to env: map uniforms onto 1..bound.
        top3 = agent_level.sort(-1).values[:, -3:]
        bound = top3.sum(-1, keepdim=True).clamp(min=1)
        u = torch.rand(num_envs, self.num_food, **kw)
        food_level = 1 + torch.minimum((u * bound).long(), bound - 1)
        return LbfResetNoise(cells, agent_level, food_level)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _flat(self, pos: torch.Tensor) -> torch.Tensor:
        return pos[..., 0] * self.grid_size + pos[..., 1]

    def _blocked_at(self, state: LbfState, query: torch.Tensor) -> torch.Tensor:
        """query (E, ..., 2) -> (E, ...): held by an agent or an uneaten food."""
        flat_q = self._flat(query)
        lead = (slice(None),) + (None,) * (flat_q.dim() - 1)
        agents = self._flat(state.agent_pos)[lead]  # (E, 1.., A)
        foods = self._flat(state.food_pos)[lead]
        agent_hit = (flat_q[..., None] == agents).any(-1)
        food_hit = ((flat_q[..., None] == foods) & ~state.food_eaten[lead]).any(-1)
        return agent_hit | food_hit

    def _observe(self, state: LbfState) -> Observation:
        e, a = state.agent_pos.shape[:2]

        def feats(pos, level, seen):  # each agent's view of entities: (E, A, N, 3)
            in_view = (pos[:, None] - state.agent_pos[:, :, None]).abs().amax(-1) <= self.fov
            table = torch.cat([pos.float(), level.float()[..., None]], dim=-1)[:, None]
            return torch.where((in_view & seen[:, None])[..., None], table, -1.0)

        food = feats(state.food_pos, state.food_level, ~state.food_eaten)
        agents = feats(state.agent_pos, state.agent_level,
                       torch.ones_like(state.agent_level, dtype=torch.bool))
        idx = self._self_first[None, :, :, None].expand(e, a, a, 3)
        agents = torch.gather(agents, 2, idx)  # self first, then the others in index order
        view = torch.cat([food.flatten(2), agents.flatten(2)], dim=-1)
        return Observation(view, self._action_mask(state),
                           state.step_count[:, None].expand(e, a).contiguous())

    def _action_mask(self, state: LbfState) -> torch.Tensor:
        targets = state.agent_pos[:, :, None, :] + self._moves[1:5]  # (E, A, 4, 2)
        in_bounds = ((targets >= 0) & (targets < self.grid_size)).all(-1)
        move_ok = in_bounds & ~self._blocked_at(state, targets.clamp(0, self.grid_size - 1))
        # Load: an uneaten food orthogonally next to the agent.
        adj = state.agent_pos[:, :, None, :] + self._adj  # (E, A, 4, 2)
        same = (adj[:, :, :, None, :] == state.food_pos[:, None, None, :, :]).all(-1)
        load_ok = (same & ~state.food_eaten[:, None, None, :]).any(-1).any(-1)
        noop = torch.ones_like(load_ok)
        return torch.cat([noop[..., None], move_ok, load_ok[..., None]], dim=-1)

    def reset(self, noise: LbfResetNoise) -> Tuple[LbfState, TimeStep]:
        e, a, dev = noise.cells.shape[0], self.num_agents, self.device
        cells = top_cells(noise.cells, a + self.num_food)
        coords = torch.stack([cells // self.grid_size, cells % self.grid_size], dim=-1)
        agent_level = noise.agent_level.long()
        if self.force_coop:
            food_level = agent_level.sum(-1, keepdim=True).expand(e, self.num_food).contiguous()
        else:
            food_level = noise.food_level.long()
        state = LbfState(
            step_count=torch.zeros(e, dtype=torch.int32, device=dev),
            agent_pos=coords[:, :a],
            agent_level=agent_level,
            food_pos=coords[:, a:],
            food_level=food_level,
            food_eaten=torch.zeros(e, self.num_food, dtype=torch.bool, device=dev),
            total_food_level=food_level.sum(-1).float(),
        )
        return state, restart(self._observe(state), {}, a)

    def step(self, state: LbfState, action: torch.Tensor,
             noise: None = None) -> Tuple[LbfState, TimeStep]:
        action = action.long()
        targets = state.agent_pos + self._moves[action]
        in_bounds = ((targets >= 0) & (targets < self.grid_size)).all(-1)
        safe = targets.clamp(0, self.grid_size - 1)
        # Blocked by a food or by any agent's cell before the move.
        valid = in_bounds & ~self._blocked_at(state, safe) & (action >= UP) & (action <= RIGHT)
        proposed = torch.where(valid[..., None], safe, state.agent_pos)
        flat = self._flat(proposed)
        clash = ((flat[:, :, None] == flat[:, None, :]) & self._other).any(-1)
        new_pos = torch.where(clash[..., None], state.agent_pos, proposed)

        # Loading: the levels of loading agents next to each uneaten food.
        loading = action == LOAD
        diff = (new_pos[:, :, None, :] - state.food_pos[:, None, :, :]).abs()
        adjacent = (diff.sum(-1) == 1) & ~state.food_eaten[:, None, :]  # (E, A, F)
        load_levels = torch.where(loading[..., None] & adjacent, state.agent_level[..., None], 0)
        level_sum = load_levels.sum(1)  # (E, F)
        eaten_now = (level_sum >= state.food_level) & (level_sum > 0)
        contrib = torch.where(
            eaten_now[:, None, :],
            load_levels * state.food_level[:, None, :] / level_sum.clamp(min=1)[:, None, :],
            0.0,
        )
        individual = contrib.sum(-1) / state.total_food_level.clamp(min=1.0)[:, None]
        e = individual.shape[0]
        if self.use_individual_rewards:
            reward = individual.float()
        else:
            reward = individual.sum(-1, keepdim=True).float().expand(e, self.num_agents).contiguous()

        food_eaten = state.food_eaten | eaten_now
        step_count = state.step_count + 1
        new_state = state._replace(step_count=step_count, agent_pos=new_pos, food_eaten=food_eaten)
        # Every food eaten terminates the episode (discount 0); time up truncates it.
        all_eaten = food_eaten.all(-1)
        done = all_eaten | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.where(all_eaten, 0.0, 1.0)[:, None].expand(e, self.num_agents).contiguous(),
            observation=self._observe(new_state),
            extras={},
        )
        return new_state, timestep
