"""MaReacher: a planar N-link arm whose joints are split across agents,
batched over a leading env axis (port of `mava_tpu/envs/mareacher.py`).

reacher_2x1 is 2 agents x 1 joint, reacher_3x2 3 agents x 2 joints. The
equations of motion come, as in the reference, from autodiff of the
Lagrangian of point masses at the link ends:

    T(q, q̇) = ½ Σₖ mₖ |∂pₖ/∂q · q̇|²   (a forward-mode product through the kinematics)
    M(q)     = ∂²T/∂q̇²                 (`torch.func.hessian`)
    C(q,q̇)q̇ = ∂(∂T/∂q̇)/∂q · q̇         (`torch.func.jacfwd` of `torch.func.grad`)
    M q̈      = τ − C q̇ + ∂(T−V)/∂q − β q̇   (`_dynamics.solve`)

integrated with RK4, 4 substeps per env step, and the angles wrapped to
[-π, π) (`_dynamics.Integrator`: q̈ vmapped over the envs, one RK4 substep
traced once per batch shape and device into a graph of plain ATen ops).

The shared team reward is -|fingertip - target| - 0.05 Σa². Episodes end by
truncation at `time_limit`. `reset_noise` draws the joint angles, then the
target's radius and angle; the step draws nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import grad, hessian, jacfwd, jvp

from mava_tpu_torch.envs._dynamics import Integrator, solve
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, StepType, TimeStep, restart

_DT = 0.05
_SUBSTEPS = 4
_DAMPING = 0.5
_TORQUE_SCALE = 1.0
_MAX_SPEED = 20.0  # rad/s safety clip
_CTRL_COST = 0.05


class MaReacherState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    q: torch.Tensor  # (E, J) joint angles
    qd: torch.Tensor  # (E, J) joint velocities
    target: torch.Tensor  # (E, 2)


class MaReacherResetNoise(NamedTuple):
    q: torch.Tensor  # (E, J) uniform on [-π, π)
    radius: torch.Tensor  # (E,) uniform on [0.2, 0.9)
    angle: torch.Tensor  # (E,) uniform on [-π, π)


class MaReacher(ContinuousEnvSpecs):
    """Batched MaReacher on one device."""

    def __init__(self, num_agents: int = 2, joints_per_agent: int = 1, time_limit: int = 100,
                 gravity: float = 0.0, torque_scale: float = _TORQUE_SCALE,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_agents * joints_per_agent
        self.time_limit = time_limit
        self.gravity = float(gravity)
        self.torque_scale = float(torque_scale)
        self.action_dim = joints_per_agent
        # A uniform chain: reach 1.0, equal point masses summing to 1.
        self.link_lengths = torch.full((self.num_joints,), 1.0 / self.num_joints, device=self.device)
        self.masses = torch.full((self.num_joints,), 1.0 / self.num_joints, device=self.device)
        # own joints (cos, sin, vel) + fingertip (2) + target (2) + tip-to-target (2)
        self.num_obs_features = 3 * joints_per_agent + 6
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=0)

    # ------------------------------------------------------------ kinematics, one env
    def _mass_positions(self, q: torch.Tensor) -> torch.Tensor:
        """(J, 2) positions of the point mass at each link end."""
        phi = torch.cumsum(q, 0)
        steps = self.link_lengths[:, None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
        return torch.cumsum(steps, 0)

    def _kinetic(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        vel = jvp(self._mass_positions, (q,), (qd,))[1]  # (J, 2) mass velocities
        return 0.5 * torch.sum(self.masses[:, None] * vel**2)

    def _potential(self, q: torch.Tensor) -> torch.Tensor:
        return self.gravity * torch.sum(self.masses * self._mass_positions(q)[:, 1])

    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        """M(q) = ∂²T/∂q̇² (J, J) of one env's angles (J,)."""
        return hessian(self._kinetic, argnums=1)(q, torch.zeros_like(q))

    def _accel(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """q̈ of one env from the Euler-Lagrange equation."""
        mass = self.mass_matrix(q)
        momentum = lambda q_: grad(self._kinetic, argnums=1)(q_, qd)  # noqa: E731  M(q_) q̇
        coriolis = jacfwd(momentum)(q) @ qd
        dl_dq = grad(lambda q_: self._kinetic(q_, qd) - self._potential(q_))(q)
        rhs = tau - coriolis + dl_dq - _DAMPING * qd
        return solve(mass, rhs)

    def _fingertip(self, q: torch.Tensor) -> torch.Tensor:
        """(E, 2) position of the last link's end (the last mass position)."""
        phi = torch.cumsum(q, 1)
        steps = self.link_lengths[:, None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
        return torch.cumsum(steps, 1)[:, -1]

    # ------------------------------------------------------------------ API
    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> MaReacherResetNoise:
        kw = dict(generator=generator, device=self.device)
        q = torch.rand(num_envs, self.num_joints, **kw) * (2 * math.pi) - math.pi
        radius = torch.rand(num_envs, **kw) * 0.7 + 0.2
        angle = torch.rand(num_envs, **kw) * (2 * math.pi) - math.pi
        return MaReacherResetNoise(q, radius, angle)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: MaReacherState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        e = state.q.shape[0]
        q_own = state.q.reshape(e, a, jpa)
        qd_own = state.qd.reshape(e, a, jpa)
        tip = self._fingertip(state.q)
        shared = torch.cat([tip, state.target, state.target - tip], dim=-1)
        agents_view = torch.cat(
            [torch.cos(q_own), torch.sin(q_own), qd_own / _MAX_SPEED,
             shared[:, None, :].expand(e, a, 6)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def _reward(self, state: MaReacherState, action: torch.Tensor) -> torch.Tensor:
        diff = self._fingertip(state.q) - state.target
        dist = torch.sqrt((diff * diff).sum(-1))
        ctrl = _CTRL_COST * (action**2).sum((1, 2))
        return (-dist - ctrl)[:, None].expand(-1, self.num_agents).contiguous()

    def reset(self, noise: MaReacherResetNoise) -> Tuple[MaReacherState, TimeStep]:
        e = noise.q.shape[0]
        target = noise.radius[:, None] * torch.stack(
            [torch.cos(noise.angle), torch.sin(noise.angle)], dim=-1)
        state = MaReacherState(
            step_count=torch.zeros(e, dtype=torch.int32, device=self.device),
            q=noise.q,
            qd=torch.zeros_like(noise.q),
            target=target,
        )
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: MaReacherState, action: torch.Tensor,
             noise: None = None) -> Tuple[MaReacherState, TimeStep]:
        action = torch.clamp(action, -1.0, 1.0)  # (E, A, jpa)
        tau = action.reshape(-1, self.num_joints) * self.torque_scale
        q, qd = self.integrate(state.q, state.qd, tau)
        step_count = state.step_count + 1
        new_state = MaReacherState(step_count, q, qd, state.target)
        reward = self._reward(new_state, action)
        time_up = step_count >= self.time_limit
        timestep = TimeStep(
            step_type=torch.where(time_up, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
            reward=reward,
            discount=torch.ones_like(reward),
            observation=self._observe(new_state),
            extras={},
        )
        return new_state, timestep
