"""MaConnector: cooperative wire routing, batched over a leading env axis (port
of `mava_tpu/envs/connector.py`).

Each agent walks its head from a random start cell to its own target cell and
leaves an impassable path behind it; the episode is won, and terminates
(discount 0), when every agent has connected, and is truncated at
`time_limit`. Actions 0 = noop, 1 = up, 2 = right, 3 = down, 4 = left. A move
is legal when its cell is in the grid and holds no path, no head and no other
agent's target; two heads that move into the same cell both stay; a connected
agent may only noop. Rewards: +1 to an agent on connecting, -0.03 a step to
each agent still unconnected, summed over the team and given to every agent.

Each agent views (G, G, 5): [every head, every target (both as the agent's
id + 1 over A), paths, its own head, its own target]. The global state is the
first three channels.

`reset_noise(E, generator)` draws (E, G * G) uniforms; the reset puts heads
and then targets on the cells of the 2A largest, in descending order with the
lower cell first on a tie (as `jax.lax.top_k`). A step draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mava_tpu_torch.specs import DiscreteEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

NUM_ACTIONS = 5
_MOVES = ((0, 0), (-1, 0), (0, 1), (1, 0), (0, -1))  # noop, up, right, down, left


class ConnectorState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    head_pos: torch.Tensor  # (E, A, 2) int64
    target_pos: torch.Tensor  # (E, A, 2) int64
    paths: torch.Tensor  # (E, G, G) bool: every agent's trail
    connected: torch.Tensor  # (E, A) bool


def top_cells(uniforms: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of each row, in descending order with the lower
    index first on a tie: `jax.lax.top_k`'s order."""
    return torch.sort(uniforms, dim=-1, descending=True, stable=True).indices[..., :k]


class MaConnector(DiscreteEnvSpecs):
    """Batched MaConnector on one device."""

    def __init__(self, grid_size: int = 10, num_agents: int = 5, time_limit: int = 50,
                 device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.grid_size = grid_size
        self.num_agents = num_agents
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        self.obs_shape = (grid_size, grid_size, 5)
        self.global_state_shape = (grid_size, grid_size, 3)
        self._moves = torch.tensor(_MOVES, device=dev)
        self._cells = torch.arange(grid_size * grid_size, device=dev)
        self._ids = (torch.arange(num_agents, dtype=torch.float32, device=dev) + 1.0) / num_agents
        self._other = ~torch.eye(num_agents, dtype=torch.bool, device=dev)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.rand(num_envs, self.grid_size ** 2, generator=generator, device=self.device)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _flat(self, pos: torch.Tensor) -> torch.Tensor:
        return pos[..., 0] * self.grid_size + pos[..., 1]

    def _onehot(self, pos: torch.Tensor) -> torch.Tensor:
        """(E, A, G * G) float occupancy of each agent's cell."""
        return (self._flat(pos)[..., None] == self._cells).float()

    def _in_grid(self, cells: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(in bounds, the cells clamped into the grid)."""
        in_bounds = ((cells >= 0) & (cells < self.grid_size)).all(-1)
        return in_bounds, cells.clamp(0, self.grid_size - 1)

    def _blocked_at(self, state: ConnectorState, query: torch.Tensor) -> torch.Tensor:
        """query (E, A, Q, 2): each agent's candidate cells -> (E, A, Q): held by
        a path, by any head, or by another agent's target."""
        flat_q = self._flat(query)
        path_hit = torch.gather(state.paths.flatten(1), 1, flat_q.flatten(1)).view_as(flat_q)
        head_hit = (flat_q[..., None] == self._flat(state.head_pos)[:, None, None, :]).any(-1)
        tgt_eq = flat_q[..., None] == self._flat(state.target_pos)[:, None, None, :]
        other_tgt_hit = (tgt_eq & self._other[:, None, :]).any(-1)
        return path_hit | head_hit | other_tgt_hit

    def _observe(self, state: ConnectorState) -> Observation:
        e, a = state.head_pos.shape[:2]
        g = self.grid_size
        head_onehot = self._onehot(state.head_pos)  # (E, A, GG)
        target_onehot = self._onehot(state.target_pos)
        heads = torch.einsum("eac,a->ec", head_onehot, self._ids).reshape(e, 1, g, g)
        targets = torch.einsum("eac,a->ec", target_onehot, self._ids).reshape(e, 1, g, g)
        paths = state.paths.float()[:, None]
        view = torch.stack([
            heads.expand(e, a, g, g),
            targets.expand(e, a, g, g),
            paths.expand(e, a, g, g),
            head_onehot.reshape(e, a, g, g),
            target_onehot.reshape(e, a, g, g),
        ], dim=-1)  # (E, A, G, G, 5)
        in_bounds, safe = self._in_grid(state.head_pos[:, :, None, :] + self._moves[1:])
        move_ok = in_bounds & ~self._blocked_at(state, safe) & ~state.connected[..., None]
        noop = torch.ones(e, a, 1, dtype=torch.bool, device=self.device)
        mask = torch.cat([noop, move_ok], dim=-1)
        return Observation(view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[ConnectorState, TimeStep]:
        e, a, dev = noise.shape[0], self.num_agents, self.device
        cells = top_cells(noise, 2 * a)
        coords = torch.stack([cells // self.grid_size, cells % self.grid_size], dim=-1)
        state = ConnectorState(
            step_count=torch.zeros(e, dtype=torch.int32, device=dev),
            head_pos=coords[:, :a],
            target_pos=coords[:, a:],
            paths=torch.zeros(e, self.grid_size, self.grid_size, dtype=torch.bool, device=dev),
            connected=torch.zeros(e, a, dtype=torch.bool, device=dev),
        )
        extras = {"won_episode": torch.zeros(e, dtype=torch.bool, device=dev)}
        return state, restart(self._observe(state), extras, a)

    def step(self, state: ConnectorState, action: torch.Tensor,
             noise: None = None) -> Tuple[ConnectorState, TimeStep]:
        action = action.long().clamp(0, NUM_ACTIONS - 1)
        in_bounds, safe = self._in_grid(state.head_pos + self._moves[action])
        free = ~self._blocked_at(state, safe[:, :, None, :])[..., 0]
        moving = (action != 0) & in_bounds & free & ~state.connected
        new_pos = torch.where(moving[..., None], safe, state.head_pos)
        # Two heads in one cell: both stay.
        flat = self._flat(new_pos)
        clash = ((flat[:, :, None] == flat[:, None, :]) & self._other).any(-1) & moving
        moving = moving & ~clash
        new_pos = torch.where(moving[..., None], new_pos, state.head_pos)
        # The cell a head left becomes path.
        left = (self._onehot(state.head_pos) > 0) & moving[..., None]
        paths = state.paths | left.any(1).view_as(state.paths)

        newly_connected = (new_pos == state.target_pos).all(-1) & ~state.connected
        connected = state.connected | newly_connected
        per_agent = newly_connected.float() - 0.03 * (~connected).float()
        e = per_agent.shape[0]
        reward = per_agent.sum(-1, keepdim=True).expand(e, self.num_agents).contiguous()
        step_count = state.step_count + 1
        new_state = ConnectorState(step_count, new_pos, state.target_pos, paths, connected)
        # Every agent connected terminates the episode (discount 0); time up truncates it.
        all_connected = connected.all(-1)
        done = all_connected | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.where(all_connected, 0.0, 1.0)[:, None].expand(e, self.num_agents).contiguous(),
            observation=self._observe(new_state),
            extras={"won_episode": all_connected},
        )
        return new_state, timestep

    def get_global_state(self, obs: Observation, state: ConnectorState) -> torch.Tensor:
        return obs.agents_view[..., :3]
