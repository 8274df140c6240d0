"""Gigastep-style two-team environment, batched over a leading env axis (port of
`mava_tpu/envs/gigastep.py`).

A continuous 10 x 10 arena; the policy team (A agents) against an adversary
team (N) of random walkers. Actions 0 = stay, 1..8 = the eight compass
directions at speed 0.5; positions are clipped to the arena; an inactive unit
does not move.

  * `hide_and_seek`: an active adversary within 0.7 of an active agent is
    tagged and deactivated, +1 team reward each. The episode terminates
    (discount 0) when either team has no active unit left.
  * `waypoint`: an active agent within 0.7 of the waypoint scores +1 (the
    policy team wins a tie), else an adversary there scores for its team;
    either way a new waypoint is drawn.

Episodes are truncated at `time_limit`. `won_episode`: the policy team has
more active units (hide_and_seek) or more points (waypoint).

Each agent observes [own position / 10 (2), own active (1)], then for every
other unit (the team after itself in index order, then the adversaries)
[visible, relative position / 10 (2), active, is adversary], zeros where not
visible, then the waypoint relative to it / 10 (2). With `partial_obs` a unit
is visible when active and within `sight_radius`, else when active.

Randomness is drawn apart from the dynamics: `reset_noise(E, generator)`
draws the uniforms of the start positions (the team in [0, 5)^2, the
adversaries in [5, 10)^2) and of the waypoint; `step_noise(E, generator)`
draws the adversaries' actions and the uniforms of a new waypoint, every step,
whether or not one is taken. Distances are `sqrt(sum(rel * rel))`, as the
reference computes them: one ulp flips `dist <= radius`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

NUM_ACTIONS = 9
_ARENA = 10.0
_SPEED = 0.5
_TAG_RANGE = 0.7
_WAYPOINT_RANGE = 0.7
_DIRS = np.array(
    [[0, 0], [0, 1], [1, 1], [1, 0], [1, -1], [0, -1], [-1, -1], [-1, 0], [-1, 1]],
    dtype=np.float32,
)
# Unit vectors, rounded as the reference's float32 numpy normalisation rounds them.
_DIRS = _DIRS / np.maximum(np.linalg.norm(_DIRS, axis=-1, keepdims=True), 1.0)


class GigastepState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    team_pos: torch.Tensor  # (E, A, 2)
    adv_pos: torch.Tensor  # (E, N, 2)
    team_active: torch.Tensor  # (E, A) bool
    adv_active: torch.Tensor  # (E, N) bool
    team_score: torch.Tensor  # (E,) float32
    adv_score: torch.Tensor  # (E,) float32
    waypoint: torch.Tensor  # (E, 2)


class GigastepResetNoise(NamedTuple):
    team: torch.Tensor  # (E, A, 2) uniforms in [0, 1)
    adv: torch.Tensor  # (E, N, 2) uniforms in [0, 1)
    waypoint: torch.Tensor  # (E, 2) uniforms in [0, 1)


class GigastepStepNoise(NamedTuple):
    adv_action: torch.Tensor  # (E, N) ints in 0..8
    waypoint: torch.Tensor  # (E, 2) uniforms in [0, 1)


def _uniform(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """`jax.random.uniform(minval=low, maxval=high)` from its [0, 1) draws."""
    return torch.clamp(u * (high - low) + low, min=low)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


class Gigastep:
    """Batched Gigastep on one device."""

    def __init__(self, scenario: str = "hide_and_seek", num_agents: int = 5,
                 num_adversaries: int = 5, partial_obs: bool = False, sight_radius: float = 3.0,
                 time_limit: int = 100, device: torch.device | str = "cpu"):
        if scenario not in ("hide_and_seek", "waypoint"):
            raise ValueError(f"Unknown Gigastep scenario {scenario!r}")
        self.device = dev = torch.device(device)
        self.scenario = scenario
        self.num_agents = num_agents
        self.num_adversaries = num_adversaries
        self.partial_obs = partial_obs
        self.sight_radius = sight_radius
        self.time_limit = time_limit
        self.action_dim = NUM_ACTIONS
        n = num_agents + num_adversaries
        self.num_obs_features = 3 + 5 * (n - 1) + 2
        self._dirs = torch.tensor(_DIRS, device=dev)
        iota = torch.arange(n, device=dev)
        self._roll = (iota[None, :] + torch.arange(num_agents, device=dev)[:, None]) % n
        self._is_adv = torch.cat([torch.zeros(num_agents), torch.ones(num_adversaries)]).to(dev)

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> GigastepResetNoise:
        kw = dict(generator=generator, device=self.device)
        return GigastepResetNoise(
            torch.rand(num_envs, self.num_agents, 2, **kw),
            torch.rand(num_envs, self.num_adversaries, 2, **kw),
            torch.rand(num_envs, 2, **kw),
        )

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> GigastepStepNoise:
        kw = dict(generator=generator, device=self.device)
        return GigastepStepNoise(
            torch.randint(0, NUM_ACTIONS, (num_envs, self.num_adversaries), **kw),
            torch.rand(num_envs, 2, **kw),
        )

    def _observe(self, state: GigastepState) -> Observation:
        e, a = state.team_pos.shape[:2]
        all_pos = torch.cat([state.team_pos, state.adv_pos], dim=1)  # (E, n, 2)
        all_active = torch.cat([state.team_active, state.adv_active], dim=1)
        rel = all_pos[:, None, :, :] - state.team_pos[:, :, None, :]  # (E, A, n, 2)
        active = all_active[:, None, :].expand(e, a, -1)
        visible = active & (_norm(rel) <= self.sight_radius) if self.partial_obs else active
        feats = torch.cat([
            visible[..., None].float(),
            rel / _ARENA,
            active[..., None].float(),
            self._is_adv[:, None].expand(e, a, -1, 1),
        ], dim=-1) * visible[..., None]  # (E, A, n, 5)
        idx = self._roll[None, :, :, None].expand(e, a, -1, 5)
        feats = torch.gather(feats, 2, idx)[:, :, 1:]  # self first, then cut
        own = torch.cat([state.team_pos / _ARENA, state.team_active[..., None].float()], dim=-1)
        wp_rel = (state.waypoint[:, None, :] - state.team_pos) / _ARENA
        view = torch.cat([own, feats.flatten(2), wp_rel], dim=-1)
        move_ok = state.team_active[..., None].expand(e, a, NUM_ACTIONS - 1)
        mask = torch.cat([torch.ones_like(move_ok[..., :1]), move_ok], dim=-1)
        return Observation(view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: GigastepResetNoise) -> Tuple[GigastepState, TimeStep]:
        e, dev = noise.team.shape[0], self.device
        state = GigastepState(
            step_count=torch.zeros(e, dtype=torch.int32, device=dev),
            team_pos=_uniform(noise.team, 0.0, _ARENA / 2),
            adv_pos=_uniform(noise.adv, _ARENA / 2, _ARENA),
            team_active=torch.ones(e, self.num_agents, dtype=torch.bool, device=dev),
            adv_active=torch.ones(e, self.num_adversaries, dtype=torch.bool, device=dev),
            team_score=torch.zeros(e, device=dev),
            adv_score=torch.zeros(e, device=dev),
            waypoint=_uniform(noise.waypoint, 0.0, _ARENA),
        )
        extras = {"won_episode": torch.zeros(e, dtype=torch.bool, device=dev)}
        return state, restart(self._observe(state), extras, self.num_agents)

    def step(self, state: GigastepState, action: torch.Tensor,
             noise: GigastepStepNoise) -> Tuple[GigastepState, TimeStep]:
        action = action.long().clamp(0, NUM_ACTIONS - 1)
        team_pos = state.team_pos + self._dirs[action] * _SPEED * state.team_active[..., None]
        adv_pos = state.adv_pos + self._dirs[noise.adv_action.long()] * _SPEED * state.adv_active[..., None]
        team_pos = team_pos.clamp(0.0, _ARENA)
        adv_pos = adv_pos.clamp(0.0, _ARENA)
        team_active, adv_active = state.team_active, state.adv_active
        waypoint = state.waypoint
        if self.scenario == "hide_and_seek":
            dist = _norm(team_pos[:, :, None, :] - adv_pos[:, None, :, :])  # (E, A, N)
            contact = (dist <= _TAG_RANGE) & team_active[..., None] & adv_active[:, None, :]
            tagged = contact.any(1)
            adv_active = adv_active & ~tagged
            team_reward = tagged.sum(-1).float()
            team_score, adv_score = state.team_score + team_reward, state.adv_score
        else:
            team_at = (_norm(team_pos - waypoint[:, None]) <= _WAYPOINT_RANGE) & team_active
            adv_at = (_norm(adv_pos - waypoint[:, None]) <= _WAYPOINT_RANGE) & adv_active
            team_hit = team_at.any(-1)
            adv_hit = adv_at.any(-1) & ~team_hit  # the policy team wins a tie
            team_reward = team_hit.float()
            team_score = state.team_score + team_reward
            adv_score = state.adv_score + adv_hit.float()
            new_waypoint = _uniform(noise.waypoint, 0.0, _ARENA)
            waypoint = torch.where((team_hit | adv_hit)[:, None], new_waypoint, waypoint)
        e = team_reward.shape[0]
        reward = team_reward[:, None].expand(e, self.num_agents).contiguous()
        step_count = state.step_count + 1
        new_state = GigastepState(step_count, team_pos, adv_pos, team_active, adv_active,
                                  team_score, adv_score, waypoint)
        if self.scenario == "hide_and_seek":
            won = team_active.sum(-1) > adv_active.sum(-1)
            wiped = ~adv_active.any(-1) | ~team_active.any(-1)
        else:
            won = team_score > adv_score
            wiped = torch.zeros_like(won)
        # A wiped-out team terminates the episode (discount 0); time up truncates it.
        done = wiped | (step_count >= self.time_limit)
        timestep = TimeStep(
            step_type=torch.where(done, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.where(wiped, 0.0, 1.0)[:, None].expand(e, self.num_agents).contiguous(),
            observation=self._observe(new_state),
            extras={"won_episode": won},
        )
        return new_state, timestep

