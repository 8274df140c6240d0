"""Matrax: repeated two-player matrix games, batched over a leading env axis.

Port of `mava_tpu/envs/matrax.py`. Task names: `Climbing-{stateless|stateful}-v0`,
`Penalty-{k}-{state}-v0`, the 78 Rapoport 2x2 ordinal games
`NoConflict-{0..20}-{state}-v0` / `Conflict-{0..56}-{state}-v0`
(`envs/matrax_catalog.py`), and `Custom-{state}-v0` with a `payoff` kwarg
(per-agent payoff matrices, shape (2, n, n)), which a scenario yaml sets as
`task_config.payoff`. Stateless games observe a zero vector; stateful games
observe the joint action of the previous step. The action mask is all ones.

The game draws nothing: `reset_noise` returns the number of envs (all a reset
needs) and `step_noise` returns None.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

_CLIMBING = np.array(
    [[11.0, -30.0, 0.0], [-30.0, 7.0, 6.0], [0.0, 0.0, 5.0]], dtype=np.float32
)


def _penalty(k: float) -> np.ndarray:
    return np.array(
        [[-k, 0.0, 10.0], [0.0, 2.0, 0.0], [10.0, 0.0, -k]], dtype=np.float32
    )


def _parse_task(task_name: str, payoff=None) -> Tuple[np.ndarray, bool]:
    """Returns (payoff matrices (num_agents, rows, cols), stateful)."""
    m = re.match(r"Climbing-(stateless|stateful)-v0", task_name)
    if m:
        return np.stack([_CLIMBING, _CLIMBING]), m.group(1) == "stateful"
    m = re.match(r"Penalty-(\d+)-(stateless|stateful)-v0", task_name)
    if m:
        p = _penalty(float(m.group(1)))
        return np.stack([p, p]), m.group(2) == "stateful"
    m = re.match(r"(NoConflict|Conflict)-(\d+)-(stateless|stateful)-v0", task_name)
    if m:
        from mava_tpu_torch.envs.matrax_catalog import catalog_payoff

        return (
            catalog_payoff(m.group(1), int(m.group(2))),
            m.group(3) == "stateful",
        )
    m = re.match(r"Custom-(stateless|stateful)-v0", task_name)
    if m:
        if payoff is None:
            raise ValueError(
                "Matrax Custom-*-v0 needs a `payoff` kwarg: per-agent payoff "
                "matrices, shape (num_agents, rows, cols) — set "
                "task_config.payoff in the scenario yaml."
            )
        arr = np.asarray(payoff, dtype=np.float32)
        # Matrix games are two-player: the step rule indexes
        # payoff[agent, action_0, action_1].
        if arr.ndim != 3 or arr.shape[0] != 2 or arr.shape[1] != arr.shape[2]:
            raise ValueError(
                "Custom payoff must be (2, n_actions, n_actions); "
                f"got {arr.shape}."
            )
        return arr, m.group(1) == "stateful"
    raise ValueError(
        f"Unknown Matrax task '{task_name}'. Supported: Climbing-*-v0, "
        "Penalty-k-*-v0, NoConflict-{0..20}-*-v0, Conflict-{0..56}-*-v0, "
        "Custom-*-v0 (with a payoff kwarg)."
    )


class MatraxState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    last_actions: torch.Tensor  # (E, A) int32


class Matrax:
    """Batched matrix game on one device."""

    def __init__(
        self,
        task_name: str = "Climbing-stateless-v0",
        time_limit: int = 10,
        payoff=None,
        device: torch.device | str = "cpu",
    ):
        payoff, stateful = _parse_task(task_name, payoff)
        self.device = torch.device(device)
        self.payoff = torch.as_tensor(payoff, device=self.device)  # (A, rows, cols)
        self.stateful = stateful
        self.num_agents = payoff.shape[0]
        self.num_actions = payoff.shape[1]
        self.action_dim = self.num_actions
        self.time_limit = time_limit
        self.num_obs_features = self.num_agents if stateful else 1
        self._agent_iota = torch.arange(self.num_agents, device=self.device)

    def _observe(self, state: MatraxState) -> Observation:
        e, a = state.last_actions.shape
        if self.stateful:
            view = state.last_actions.float()[:, None, :].expand(e, a, a).contiguous()
        else:
            view = torch.zeros((e, a, 1), dtype=torch.float32, device=self.device)
        mask = torch.ones((e, a, self.num_actions), dtype=torch.bool, device=self.device)
        return Observation(view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> int:
        return num_envs

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def reset(self, noise: int) -> Tuple[MatraxState, TimeStep]:
        state = MatraxState(
            step_count=torch.zeros(noise, dtype=torch.int32, device=self.device),
            last_actions=torch.zeros(
                (noise, self.num_agents), dtype=torch.int32, device=self.device
            ),
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(
        self, state: MatraxState, action: torch.Tensor, noise: None = None
    ) -> Tuple[MatraxState, TimeStep]:
        action = action.to(torch.int64)
        reward = self.payoff[self._agent_iota, action[:, :1], action[:, 1:2]]  # (E, A)
        step_count = state.step_count + 1
        new_state = MatraxState(step_count=step_count, last_actions=action.to(torch.int32))
        # Running out of time is a truncation: LAST, and the discount stays 1.
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=torch.where(time_up, int(StepType.LAST), int(StepType.MID)).to(
                torch.int32
            ),
            reward=reward,
            discount=torch.ones_like(reward),
            observation=self._observe(new_state),
            extras={},
        )
        return new_state, timestep
