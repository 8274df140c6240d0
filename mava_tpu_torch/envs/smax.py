"""SMAX: simplified StarCraft multi-agent combat, batched over a leading env axis.

Port of `mava_tpu/envs/smax.py` with the same engine (see that module's
docstring): two teams of heterogeneous units on a 32 x 32 map, per-unit actions
0 = stop, 1-4 = move N/E/S/W, 5 + i = attack enemy i; a scripted enemy that
attacks the closest (or a random) ally in range, else walks towards the closest
ally; simultaneous damage; SMAC rewards, (damage + 10 * kills + 200 * win) /
max_reward * 20; a win (every enemy dead) reported in `extras["won_episode"]`.

Where the reference vmaps a per-env function, every method here takes and
returns tensors with a leading env axis `E`. The randomness is drawn apart from
the dynamics, as in `envs/rware.py`, so a test can inject the reference's draws:

  * `reset_noise(E, generator)` draws the standard normals of the start
    positions (E, N, 2) and, for the `smacv2_*` scenarios, the indices into the
    unit pool (E, N) of the resampled unit types;
  * `step_noise(E, generator)` draws the enemy's uniforms (E, n_enemies,
    n_agents) of `attack_mode="random"`, and is None for "closest".

`reset(noise)` and `step(state, action, noise)` are then deterministic.
Distances are `sqrt(sum(rel * rel))` as the reference computes them: a
one-ulp difference would flip `dist <= range` in the attack mask and the enemy
AI.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mava_tpu_torch.specs import DiscreteEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

# Unit stats: [hp, dps (per env step), attack_range, sight_range, speed]
_UNIT_NAMES = [
    "marine", "marauder", "stalker", "zealot", "zergling", "hydralisk", "colossus",
]
_UNIT_STATS = np.array(
    [
        # hp     dps    atk_r  sight  speed
        [45.0, 10.0, 5.0, 9.0, 3.15],  # marine
        [125.0, 9.0, 6.0, 10.0, 3.15],  # marauder
        [160.0, 10.0, 6.0, 10.0, 4.13],  # stalker (hp+shield)
        [150.0, 18.0, 1.5, 9.0, 3.15],  # zealot (hp+shield, melee)
        [35.0, 10.0, 1.0, 8.0, 4.70],  # zergling
        [80.0, 20.0, 5.0, 9.0, 3.15],  # hydralisk
        [350.0, 19.0, 7.0, 10.0, 3.15],  # colossus
    ],
    dtype=np.float32,
)
NUM_UNIT_TYPES = len(_UNIT_NAMES)

MAP_WIDTH = 32.0
MAP_HEIGHT = 32.0
_STEP_SCALE = 0.5  # game seconds per env step
_MOVE_DIRS = np.array(
    [[0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [-1.0, 0.0]], dtype=np.float32
)  # N, E, S, W in (x, y)

_T = {name: i for i, name in enumerate(_UNIT_NAMES)}


def _comp(counts: Dict[str, int]) -> List[int]:
    out: List[int] = []
    for name, n in counts.items():
        out += [_T[name]] * n
    return out


# scenario -> (ally unit types, enemy unit types, time_limit)
SCENARIOS: Dict[str, Tuple[List[int], List[int], int]] = {
    "2s3z": (_comp({"stalker": 2, "zealot": 3}), _comp({"stalker": 2, "zealot": 3}), 120),
    "3s5z": (_comp({"stalker": 3, "zealot": 5}), _comp({"stalker": 3, "zealot": 5}), 150),
    "5m_vs_6m": (_comp({"marine": 5}), _comp({"marine": 6}), 120),
    "10m_vs_11m": (_comp({"marine": 10}), _comp({"marine": 11}), 150),
    "27m_vs_30m": (_comp({"marine": 27}), _comp({"marine": 30}), 180),
    "3s5z_vs_3s6z": (
        _comp({"stalker": 3, "zealot": 5}),
        _comp({"stalker": 3, "zealot": 6}),
        170,
    ),
    "3s_vs_5z": (_comp({"stalker": 3}), _comp({"zealot": 5}), 200),
    "6h_vs_8z": (_comp({"hydralisk": 6}), _comp({"zealot": 8}), 150),
    "smacv2_5_units": ([0] * 5, [0] * 5, 150),
    "smacv2_10_units": ([0] * 10, [0] * 10, 150),
    "smacv2_20_units": ([0] * 20, [0] * 20, 150),
}
_SMACV2_POOL = np.array(
    [_T["marine"], _T["marauder"], _T["stalker"], _T["zealot"], _T["hydralisk"]],
    dtype=np.int64,
)


class SmaxState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    unit_pos: torch.Tensor  # (E, N, 2) float32 (x, y)
    unit_hp: torch.Tensor  # (E, N) float32
    unit_types: torch.Tensor  # (E, N) int64
    max_reward: torch.Tensor  # (E,) float32


class SmaxResetNoise(NamedTuple):
    position: torch.Tensor  # (E, N, 2) standard normals, scaled by the scenario's scatter
    pool_index: Optional[torch.Tensor] = None  # (E, N) int64 into the smacv2 pool


def _norm(rel: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, in the reference's order."""
    return torch.sqrt((rel * rel).sum(-1))


class Smax(DiscreteEnvSpecs):
    """Batched SMAX on one device."""

    def __init__(
        self,
        scenario: str = "3s5z",
        see_enemy_actions: bool = True,  # accepted for config parity, as in the reference
        walls_cause_death: bool = True,  # no walls in this engine; accepted
        attack_mode: str = "closest",
        time_limit: int | None = None,
        device: torch.device | str = "cpu",
    ):
        if scenario not in SCENARIOS:
            raise ValueError(f"Unknown SMAX scenario '{scenario}'.")
        if attack_mode not in ("closest", "random"):
            raise ValueError(f"Unknown SMAX attack_mode '{attack_mode}' (closest | random).")
        ally_types, enemy_types, default_limit = SCENARIOS[scenario]
        self.device = dev = torch.device(device)
        self.scenario = scenario
        self.is_smacv2 = scenario.startswith("smacv2")
        self.num_agents = len(ally_types)
        self.num_enemies = len(enemy_types)
        self.num_units = self.num_agents + self.num_enemies
        self.time_limit = int(time_limit or default_limit)
        self.attack_mode = attack_mode
        self.action_dim = 5 + self.num_enemies  # stop, 4 moves, attack each enemy

        types = np.array(ally_types + enemy_types, dtype=np.int64)
        self._init_types = torch.as_tensor(types, device=dev)
        self._stats = torch.as_tensor(_UNIT_STATS, device=dev)
        self._eye_types = torch.eye(NUM_UNIT_TYPES, device=dev)
        self._pool = torch.as_tensor(_SMACV2_POOL, device=dev)
        self._move_dirs = torch.as_tensor(_MOVE_DIRS, device=dev)
        self._map = torch.tensor([MAP_WIDTH, MAP_HEIGHT], device=dev)
        self._unit_iota = torch.arange(self.num_units, device=dev)
        self._is_ally = self._unit_iota < self.num_agents
        # Each agent's row of the other units, rolled so that self comes first.
        self._roll = (self._unit_iota[None, :] + self._unit_iota[: self.num_agents, None]) % self.num_units
        if self.is_smacv2:
            centers, self._scatter = (0.3, 0.7), 4.0
        else:
            centers, self._scatter = (0.25, 0.75), 2.0
        self._centers = torch.as_tensor(
            np.array(
                [[MAP_WIDTH * centers[0], MAP_HEIGHT * 0.5]] * self.num_agents
                + [[MAP_WIDTH * centers[1], MAP_HEIGHT * 0.5]] * self.num_enemies,
                dtype=np.float32,
            ),
            device=dev,
        )

        per_other = 4 + NUM_UNIT_TYPES
        self.num_obs_features = (3 + NUM_UNIT_TYPES) + (self.num_units - 1) * per_other
        self.num_global_state_features = self.num_units * (3 + NUM_UNIT_TYPES)

    # ------------------------------------------------------------------ noise
    def reset_noise(self, num_envs: int, generator: torch.Generator) -> SmaxResetNoise:
        kw = dict(generator=generator, device=self.device)
        position = torch.randn(num_envs, self.num_units, 2, **kw)
        pool_index = None
        if self.is_smacv2:
            pool_index = torch.randint(0, len(_SMACV2_POOL), (num_envs, self.num_units), **kw)
        return SmaxResetNoise(position, pool_index)

    def step_noise(self, num_envs: int, generator: torch.Generator) -> Optional[torch.Tensor]:
        if self.attack_mode != "random":
            return None
        return torch.rand(
            num_envs, self.num_enemies, self.num_agents, generator=generator, device=self.device
        )

    # ------------------------------------------------------------------ unit tables
    def _unit_stats(self, state: SmaxState) -> torch.Tensor:
        """(E, N, 5) per-unit [hp, dps, atk_range, sight, speed]."""
        return self._stats[state.unit_types]

    def _type_onehot(self, state: SmaxState) -> torch.Tensor:
        return self._eye_types[state.unit_types]

    def _unit_feats(self, state: SmaxState) -> torch.Tensor:
        """(E, N, 3 + T): [hp_frac, x/W, y/H, type-onehot], zeroed for dead units."""
        alive = state.unit_hp > 0
        max_hp = self._unit_stats(state)[..., 0]
        feats = torch.cat(
            [(state.unit_hp / max_hp)[..., None], state.unit_pos / self._map,
             self._type_onehot(state)],
            dim=-1,
        )
        return feats * alive[..., None]

    # ------------------------------------------------------------------ API
    def reset(self, noise: SmaxResetNoise) -> Tuple[SmaxState, TimeStep]:
        e = noise.position.shape[0]
        if self.is_smacv2:
            unit_types = self._pool[noise.pool_index]
        else:
            unit_types = self._init_types.expand(e, -1)
        pos = self._centers + noise.position * self._scatter
        unit_pos = torch.minimum(pos.clamp(min=1.0), self._map - 1.0)
        unit_hp = self._stats[unit_types, 0]
        max_reward = unit_hp[:, self.num_agents:].sum(-1) + 10.0 * self.num_enemies + 200.0
        state = SmaxState(
            step_count=torch.zeros(e, dtype=torch.int32, device=self.device),
            unit_pos=unit_pos,
            unit_hp=unit_hp,
            unit_types=unit_types,
            max_reward=max_reward,
        )
        extras = {"won_episode": torch.zeros(e, dtype=torch.bool, device=self.device)}
        return state, restart(self._observe(state), extras, self.num_agents)

    def _observe(self, state: SmaxState) -> Observation:
        n, a = self.num_units, self.num_agents
        e = state.unit_hp.shape[0]
        alive = state.unit_hp > 0
        stats = self._unit_stats(state)
        hp_frac = state.unit_hp / stats[..., 0]
        sight = stats[..., 3]
        type_onehot = self._type_onehot(state)

        own = torch.cat(
            [hp_frac[:, :a, None], state.unit_pos[:, :a] / self._map, type_onehot[:, :a]], dim=-1
        ) * alive[:, :a, None]

        rel = state.unit_pos[:, None, :, :] - state.unit_pos[:, :a, None, :]  # (E, A, N, 2)
        dist = _norm(rel)
        visible = (dist <= sight[:, :a, None]) & alive[:, None, :] & alive[:, :a, None]
        other = torch.cat(
            [
                visible[..., None].float(),
                hp_frac[:, None, :, None].expand(e, a, n, 1),
                rel / torch.clamp(sight[:, :a, None, None], min=1e-6),
                type_onehot[:, None].expand(e, a, n, NUM_UNIT_TYPES),
            ],
            dim=-1,
        ) * visible[..., None]  # (E, A, N, 4 + T)
        # Drop self from each agent's row: roll it so self is first, cut it.
        idx = self._roll[None, :, :, None].expand(e, a, n, other.shape[-1])
        other = torch.gather(other, 2, idx)[:, :, 1:]
        agents_view = torch.cat([own, other.reshape(e, a, -1)], dim=-1)

        ally_alive = alive[:, :a]
        attack_ok = (
            (dist[:, :, a:] <= stats[:, :a, 2, None]) & alive[:, None, a:] & ally_alive[..., None]
        )
        action_mask = torch.cat(
            [torch.ones_like(ally_alive)[..., None], ally_alive[..., None].expand(e, a, 4),
             attack_ok],
            dim=-1,
        )
        step_count = state.step_count[:, None].expand(e, a).contiguous()
        return Observation(agents_view, action_mask, step_count)

    def _enemy_actions(
        self,
        state: SmaxState,
        noise: Optional[torch.Tensor],
        rel: torch.Tensor,  # (E, e, A, 2) ally positions relative to each enemy
        dist: torch.Tensor,  # (E, e, A)
    ) -> torch.Tensor:
        """The scripted enemy: attack an in-range ally (the closest, or the one
        with the largest uniform), else step towards the closest ally."""
        a, n_e = self.num_agents, self.num_enemies
        alive = state.unit_hp > 0
        dist = torch.where(alive[:, None, :a], dist, torch.inf)
        in_range = dist <= self._unit_stats(state)[:, a:, 2, None]
        score = noise if self.attack_mode == "random" else -dist
        target = torch.argmax(torch.where(in_range, score, -torch.inf), dim=-1)  # (E, e)
        can_attack = in_range.any(-1)

        closest = torch.argmin(dist, dim=-1)  # (E, e)
        to_target = torch.gather(rel, 2, closest[..., None, None].expand(-1, n_e, 1, 2))[:, :, 0]
        move_action = 1 + torch.argmax(to_target @ self._move_dirs.T, dim=-1)

        action = torch.where(can_attack, 5 + target, move_action)
        action = torch.where(alive[:, :a].any(-1, keepdim=True), action, 0)
        return torch.where(alive[:, a:], action, 0)

    def step(
        self, state: SmaxState, action: torch.Tensor, noise: Optional[torch.Tensor]
    ) -> Tuple[SmaxState, TimeStep]:
        a, n_e, n = self.num_agents, self.num_enemies, self.num_units
        e = state.unit_hp.shape[0]

        # Pairwise geometry at the step's start, shared by the enemy AI and the attacks.
        rel_all = state.unit_pos[:, :, None, :] - state.unit_pos[:, None, :, :]  # (E, N, N, 2)
        dist_all = _norm(rel_all)
        enemy_action = self._enemy_actions(state, noise, -rel_all[:, a:, :a], dist_all[:, a:, :a])
        # Enemy attack targets index into the ally team.
        all_actions = torch.cat([action.to(torch.int64), enemy_action], dim=-1)  # (E, N)

        alive = state.unit_hp > 0
        stats = self._unit_stats(state)
        speed, atk_range, dps = stats[..., 4], stats[..., 2], stats[..., 1]

        is_move = (all_actions >= 1) & (all_actions <= 4)
        move_dir = self._move_dirs[torch.clamp(all_actions - 1, 0, 3)]
        new_pos = state.unit_pos + move_dir * (speed * _STEP_SCALE)[..., None] * (
            is_move & alive
        )[..., None].float()
        new_pos = torch.minimum(new_pos.clamp(min=0.5), self._map - 0.5)

        # Attacks, on positions at the step's start (an attack replaces a move).
        is_attack = all_actions >= 5
        raw_target = torch.clamp(all_actions - 5, 0, max(n_e, a) - 1)
        target = torch.where(
            self._is_ally, torch.clamp(raw_target, 0, n_e - 1) + a, torch.clamp(raw_target, 0, a - 1)
        )
        tgt_dist = torch.gather(dist_all, 2, target[..., None])[..., 0]
        valid_attack = (
            is_attack & alive & torch.gather(alive, 1, target) & (tgt_dist <= atk_range)
        )
        damage_out = torch.where(valid_attack, dps, 0.0)
        hits = (target[:, :, None] == self._unit_iota) & valid_attack[:, :, None]  # (E, src, tgt)
        damage_in = (hits * damage_out[:, :, None]).sum(1)
        new_hp = torch.clamp(state.unit_hp - damage_in, min=0.0)
        newly_dead = alive & (new_hp <= 0)

        # Rewards, from the allies' side.
        enemy_damage_taken = torch.minimum(damage_in[:, a:], state.unit_hp[:, a:]).sum(-1)
        enemy_kills = newly_dead[:, a:].sum(-1).float()
        all_enemies_dead = (new_hp[:, a:] <= 0).all(-1)
        all_allies_dead = (new_hp[:, :a] <= 0).all(-1)
        win_bonus = torch.where(all_enemies_dead, 200.0, 0.0)
        team_reward = (
            (enemy_damage_taken + 10.0 * enemy_kills + win_bonus) / state.max_reward * 20.0
        )

        step_count = state.step_count + 1
        new_state = SmaxState(
            step_count=step_count,
            unit_pos=new_pos,
            unit_hp=new_hp,
            unit_types=state.unit_types,
            max_reward=state.max_reward,
        )
        # A wipe-out ends the episode by termination (discount 0), the time limit
        # by truncation (discount 1).
        wiped = all_enemies_dead | all_allies_dead
        done = wiped | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=team_reward[:, None].expand(e, a).contiguous(),
            discount=torch.where(wiped, 0.0, 1.0)[:, None].expand(e, a).contiguous(),
            observation=self._observe(new_state),
            extras={"won_episode": all_enemies_dead},
        )
        return new_state, timestep

    # ------------------------------------------------------------------ global state
    def get_global_state(self, obs: Observation, state: SmaxState) -> torch.Tensor:
        """SMAX's world state: every unit's features, the same for every agent
        (E, A, N * (3 + T))."""
        flat = self._unit_feats(state).flatten(1)
        return flat[:, None, :].expand(-1, self.num_agents, -1)
