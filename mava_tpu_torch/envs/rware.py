"""RobotWarehouse (RWARE), batched over a leading env axis.

Port of `mava_tpu/envs/rware.py` with the same rules (see that module's
docstring): a grid of shelf blocks with goals at the bottom centre, actions
0=noop, 1=forward, 2=turn-left, 3=turn-right, 4=toggle-load, +1 team reward per
delivered requested shelf, and termination on agent collision.

Where the reference vmaps a per-env function, every method here takes and
returns tensors with a leading env axis `E`. The randomness is drawn apart from
the dynamics, so a test can inject the reference's draws:

  * `reset_noise(E, generator)` draws the uniforms whose top-k picks the agent
    cells and the requested shelves (reference `:229-252`), and the agent
    directions;
  * `step_noise(E, generator)` draws the Gumbel noise of the per-agent new
    request (the reference's `jax.random.categorical` is argmax(logits + Gumbel),
    `:340-343`).

`reset(noise)` and `step(state, action, noise)` are then deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mava_tpu_torch.specs import DiscreteEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

# Direction encoding: 0=up, 1=right, 2=down, 3=left (clockwise).
_DIR_VECS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int64)

NOOP, FORWARD, LEFT, RIGHT, TOGGLE = 0, 1, 2, 3, 4
NUM_ACTIONS = 5


class RwareState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    agent_pos: torch.Tensor  # (E, A, 2) int64, (row, col)
    agent_dir: torch.Tensor  # (E, A) int64
    agent_carrying: torch.Tensor  # (E, A) int64, shelf id or -1
    shelf_pos: torch.Tensor  # (E, S, 2) int64
    shelf_requested: torch.Tensor  # (E, S) bool


class RwareResetNoise(NamedTuple):
    cell_uniform: torch.Tensor  # (E, height*width): top-k picks the agent cells
    agent_dir: torch.Tensor  # (E, A) int64 in [0, 4)
    request_uniform: torch.Tensor  # (E, S): top-k picks the requested shelves


def _build_layout(
    shelf_rows: int, shelf_columns: int, column_height: int
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Returns (storage_mask (H,W), goals (2,2) as (row, col), (H, W))."""
    height = (column_height + 1) * shelf_rows + 2
    width = 3 * shelf_columns + 1
    goals = np.array(
        [[height - 1, width // 2 - 1], [height - 1, width // 2]], dtype=np.int64
    )
    ys, xs = np.mgrid[0:height, 0:width]
    highway = (
        (xs % 3 == 0)
        | (ys % (column_height + 1) == 0)
        | (ys == height - 1)
        | (
            (ys > height - (column_height + 3))
            & ((xs == goals[0, 1]) | (xs == goals[1, 1]))
        )
    )
    return ~highway, goals, (height, width)


class RobotWarehouse(DiscreteEnvSpecs):
    """Batched RWARE on one device."""

    def __init__(
        self,
        shelf_rows: int = 1,
        shelf_columns: int = 3,
        column_height: int = 8,
        num_agents: int = 2,
        sensor_range: int = 1,
        request_queue_size: int = 2,
        time_limit: int = 500,
        device: torch.device | str = "cpu",
    ):
        storage_mask, goals, (height, width) = _build_layout(
            shelf_rows, shelf_columns, column_height
        )
        self.device = torch.device(device)
        self.height, self.width = height, width
        self.num_agents = num_agents
        self.sensor_range = sensor_range
        self.request_queue_size = request_queue_size
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS

        dev = self.device
        shelf_cells = np.argwhere(storage_mask)
        self.num_shelves = int(shelf_cells.shape[0])
        self._init_shelf_pos = torch.as_tensor(shelf_cells, dtype=torch.int64, device=dev)
        self._goal_flat = torch.as_tensor(goals[:, 0] * width + goals[:, 1], device=dev)
        self._storage_flat = torch.as_tensor(storage_mask.reshape(-1), device=dev)
        self._shelf_iota = torch.arange(self.num_shelves, device=dev)
        self._dir_vecs = torch.as_tensor(_DIR_VECS, device=dev)
        self._bounds = torch.tensor([height - 1, width - 1], device=dev)
        self._eye = torch.eye(num_agents, dtype=torch.bool, device=dev)

        window = 2 * sensor_range + 1
        dys, dxs = np.mgrid[-sensor_range : sensor_range + 1,
                            -sensor_range : sensor_range + 1]
        # Row-major (dy outer, dx inner), as the reference's window features.
        self._window_offsets = torch.as_tensor(
            np.stack([dys.ravel(), dxs.ravel()], axis=-1), dtype=torch.int64, device=dev
        )  # (K, 2)
        self.num_obs_features = 3 + window * window * 7

    # ------------------------------------------------------------------ helpers
    def _flat(self, pos: torch.Tensor) -> torch.Tensor:
        return pos[..., 0] * self.width + pos[..., 1]

    def _in_bounds(self, pos: torch.Tensor) -> torch.Tensor:
        return (
            (pos[..., 0] >= 0)
            & (pos[..., 0] < self.height)
            & (pos[..., 1] >= 0)
            & (pos[..., 1] < self.width)
        )

    def _shelf_id_at(self, flat_shelf: torch.Tensor, flat_query: torch.Tensor) -> torch.Tensor:
        """Shelf id + 1 at each queried cell (0 = empty). (E,S), (E,Q) -> (E,Q)."""
        hit = flat_query[..., :, None] == flat_shelf[..., None, :]
        return torch.sum(hit * (self._shelf_iota + 1), dim=-1)

    def _observe(self, state: RwareState) -> Observation:
        e, a = state.agent_pos.shape[:2]
        flat_shelf = self._flat(state.shelf_pos)  # (E, S)
        flat_agent = self._flat(state.agent_pos)  # (E, A)

        qpos = state.agent_pos[:, :, None, :] + self._window_offsets  # (E, A, K, 2)
        valid = self._in_bounds(qpos)
        flat_q = torch.where(valid, self._flat(qpos), -1)  # (E, A, K)

        eq_agent = flat_q[..., None] == flat_agent[:, None, None, :]  # (E, A, K, A)
        eq_shelf = flat_q[..., None] == flat_shelf[:, None, None, :]  # (E, A, K, S)
        # (E, A, 4), by comparison: `one_hot` reads its range back on CPU tensors.
        dir_onehot = (state.agent_dir[..., None] == torch.arange(4, device=self.device)).float()

        agent_f = eq_agent.any(-1).float()
        dir_f = torch.einsum("eqka,ead->eqkd", eq_agent.float(), dir_onehot)
        shelf_f = eq_shelf.any(-1).float()
        req_f = torch.einsum(
            "eqks,es->eqk", eq_shelf.float(), state.shelf_requested.float()
        )
        cell_features = torch.cat(
            [agent_f[..., None], dir_f, shelf_f[..., None], req_f[..., None]], dim=-1
        )  # (E, A, K, 7)
        windows = cell_features.reshape(e, a, -1)
        own = torch.cat(
            [
                state.agent_pos.float(),
                (state.agent_carrying >= 0).float()[..., None],
            ],
            dim=-1,
        )
        agents_view = torch.cat([own, windows], dim=-1)
        action_mask = self._action_mask(state, flat_shelf)
        step_count = state.step_count[:, None].expand(e, a).contiguous()
        return Observation(agents_view, action_mask, step_count)

    def _action_mask(self, state: RwareState, flat_shelf: torch.Tensor) -> torch.Tensor:
        target = state.agent_pos + self._dir_vecs[state.agent_dir]
        in_bounds = self._in_bounds(target)
        safe_target = torch.minimum(target.clamp(min=0), self._bounds)
        shelf_at_target = self._shelf_id_at(flat_shelf, self._flat(safe_target)) > 0
        carrying = state.agent_carrying >= 0
        fwd_ok = in_bounds & ~(carrying & shelf_at_target)

        flat_here = self._flat(state.agent_pos)
        shelf_here = self._shelf_id_at(flat_shelf, flat_here) > 0
        on_storage = self._storage_flat[flat_here]
        toggle_ok = torch.where(carrying, on_storage, shelf_here)
        ones = torch.ones_like(fwd_ok)
        return torch.stack([ones, fwd_ok, ones, ones, toggle_ok], dim=-1)

    # ------------------------------------------------------------------ noise
    def reset_noise(self, num_envs: int, generator: torch.Generator) -> RwareResetNoise:
        kw = dict(generator=generator, device=self.device)
        return RwareResetNoise(
            cell_uniform=torch.rand(num_envs, self.height * self.width, **kw),
            agent_dir=torch.randint(0, 4, (num_envs, self.num_agents), **kw),
            request_uniform=torch.rand(num_envs, self.num_shelves, **kw),
        )

    def step_noise(self, num_envs: int, generator: torch.Generator) -> torch.Tensor:
        """Gumbel noise (E, A, S) for each agent's potential new request."""
        u = torch.rand(
            num_envs, self.num_agents, self.num_shelves,
            generator=generator, device=self.device,
        )
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u.clamp(min=tiny)))

    # ------------------------------------------------------------------ API
    def reset(self, noise: RwareResetNoise) -> Tuple[RwareState, TimeStep]:
        e = noise.cell_uniform.shape[0]
        # Distinct uniform samples via top-k over iid uniforms (reference :231-252).
        cells = torch.topk(noise.cell_uniform, self.num_agents, dim=-1).indices
        agent_pos = torch.stack([cells // self.width, cells % self.width], dim=-1)
        req_idx = torch.topk(noise.request_uniform, self.request_queue_size, dim=-1).indices
        shelf_requested = torch.any(req_idx[..., None] == self._shelf_iota, dim=-2)
        state = RwareState(
            step_count=torch.zeros(e, dtype=torch.int32, device=self.device),
            agent_pos=agent_pos,
            agent_dir=noise.agent_dir.to(torch.int64),
            agent_carrying=torch.full(
                (e, self.num_agents), -1, dtype=torch.int64, device=self.device
            ),
            shelf_pos=self._init_shelf_pos.expand(e, -1, -1).clone(),
            shelf_requested=shelf_requested,
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: RwareState, action: torch.Tensor, noise: torch.Tensor
    ) -> Tuple[RwareState, TimeStep]:
        action = action.to(torch.int64)
        flat_shelf_pre = self._flat(state.shelf_pos)
        carrying = state.agent_carrying >= 0

        # --- movement ---------------------------------------------------------
        fwd = state.agent_pos + self._dir_vecs[state.agent_dir]
        in_bounds = self._in_bounds(fwd)
        safe_fwd = torch.minimum(fwd.clamp(min=0), self._bounds)
        shelf_at_fwd = self._shelf_id_at(flat_shelf_pre, self._flat(safe_fwd)) > 0
        can_move = in_bounds & ~(carrying & shelf_at_fwd)
        moves = (action == FORWARD) & can_move
        new_pos = torch.where(moves[..., None], safe_fwd, state.agent_pos)

        new_dir = state.agent_dir
        new_dir = torch.where(action == LEFT, (new_dir - 1) % 4, new_dir)
        new_dir = torch.where(action == RIGHT, (new_dir + 1) % 4, new_dir)

        # --- collision detection (episode terminates) --------------------------
        flat_new = self._flat(new_pos)
        flat_old = self._flat(state.agent_pos)
        same_cell = (flat_new[:, :, None] == flat_new[:, None, :]) & ~self._eye
        swap = (
            (flat_new[:, :, None] == flat_old[:, None, :])
            & (flat_old[:, :, None] == flat_new[:, None, :])
            & ~self._eye
        )
        collision = same_cell.flatten(1).any(-1) | swap.flatten(1).any(-1)  # (E,)

        # Carried shelves travel with their agent.
        move_mat = (
            state.agent_carrying[:, None, :] == self._shelf_iota[None, :, None]
        ) & (carrying & moves)[:, None, :]  # (E, S, A)
        moved = move_mat.any(-1)
        # Integer sum over agents (CUDA has no integer matmul for an einsum).
        dest = (move_mat[..., None] * new_pos[:, None, :, :]).sum(dim=2)
        shelf_pos = torch.where(moved[..., None], dest, state.shelf_pos)

        # --- toggle load/unload -------------------------------------------------
        flat_shelf = self._flat(shelf_pos)
        shelf_here = self._shelf_id_at(flat_shelf, flat_new)
        on_storage = self._storage_flat[flat_new]
        toggles = action == TOGGLE
        pickup = toggles & ~carrying & (shelf_here > 0)
        drop = toggles & carrying & on_storage
        new_carrying = torch.where(pickup, shelf_here - 1, state.agent_carrying)
        new_carrying = torch.where(drop, -1, new_carrying)

        # --- deliveries: sequential over agents for distinct new requests -------
        at_goal = torch.any(flat_new[..., None] == self._goal_flat, dim=-1)  # (E, A)
        requested = state.shelf_requested
        team_reward = torch.zeros(state.step_count.shape, device=self.device)
        for i in range(self.num_agents):
            carried = new_carrying[:, i]
            sid = carried.clamp(0, self.num_shelves - 1)
            sid_onehot = self._shelf_iota == sid[:, None]  # (E, S)
            do = (carried >= 0) & torch.any(requested & sid_onehot, -1) & at_goal[:, i]
            # New request: uniform over the shelves not yet requested (the
            # delivered shelf is still requested here, so it is excluded).
            logits = torch.where(requested, -torch.inf, 0.0)
            new_req = torch.argmax(noise[:, i] + logits, dim=-1)
            updated = requested | (self._shelf_iota == new_req[:, None])
            updated = updated & ~sid_onehot
            requested = torch.where(do[:, None], updated, requested)
            team_reward = team_reward + do.float()

        step_count = state.step_count + 1
        new_state = RwareState(
            step_count=step_count,
            agent_pos=new_pos,
            agent_dir=new_dir,
            agent_carrying=new_carrying,
            shelf_pos=shelf_pos,
            shelf_requested=requested,
        )
        obs = self._observe(new_state)
        e = step_count.shape[0]
        reward = team_reward[:, None].expand(e, self.num_agents).contiguous()
        done = collision | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(
                torch.int32
            ),
            reward=reward,
            # collision -> termination (discount 0); time limit -> truncation.
            discount=torch.where(collision, 0.0, 1.0)[:, None]
            .expand(e, self.num_agents)
            .contiguous(),
            observation=obs,
            extras={},
        )
        return new_state, timestep
