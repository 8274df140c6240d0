"""MaSwimmer: a free-floating N-link chain in a viscous medium whose joints are
split across agents, batched over a leading env axis (port of
`mava_tpu/envs/maswimmer.py`).

swimmer-2x1 is 2 agents x 1 joint on a 3-link chain. The drag is anisotropic:
each link resists motion normal to its axis far more than along it, so a
travelling wave swims and, with isotropic drag, no gait can. As in the
reference, the equations of motion come from autodiff of the Lagrangian:

    q        = (x, y, th, a_1..a_J)   free base + relative joint angles
    T(q, q̇)  = ½ Σₖ mₖ |ċₖ|² + Iₖ φ̇ₖ² + ½ A Σ ȧ²   (rods, their inertias, the armature)
    M(q)     = ∂²T/∂q̇²                            (`torch.func.hessian`)
    R(q, q̇)  = ½ Σₖ lₖ [c_n (vₖ·nₖ)² + c_t (vₖ·tₖ)²] + ½ Σₖ c_n lₖ³/12 φ̇ₖ² + ½ c_j Σ ȧ²
    M q̈      = τ − ∂R/∂q̇ − C(q, q̇) q̇ + ∂T/∂q

RK4 at dt 0.04 over 4 substeps, q̇ clipped at 20, then th and the joint
angles wrapped (`q[2:]`), not the base position (`_dynamics.Integrator`).

The shared team reward is the forward velocity of the centre of mass minus
0.001 Σa². Episodes end by truncation at `time_limit`. `reset_noise` draws the
uniform pose noise on [-0.1, 0.1) of th and the joints; the step draws nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad, hessian, jacfwd, jvp, vmap

from mava_tpu_torch.envs._dynamics import (
    BodyState,
    Integrator,
    body_timestep,
    solve,
    uniform_noise,
)
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, TimeStep, restart

_DT = 0.04
_SUBSTEPS = 4
_TORQUE_SCALE = 1.0
_MAX_SPEED = 20.0
_CTRL_COST = 0.001
_ARMATURE = 0.05
_DRAG_NORMAL = 5.0
_DRAG_TANGENT = 0.1
_JOINT_DAMPING = 0.3


class MaSwimmer(ContinuousEnvSpecs):
    """Batched MaSwimmer on one device."""

    def __init__(self, num_agents: int = 2, joints_per_agent: int = 1, time_limit: int = 200,
                 torque_scale: float = _TORQUE_SCALE, drag_normal: float = _DRAG_NORMAL,
                 drag_tangent: float = _DRAG_TANGENT, joint_damping: float = _JOINT_DAMPING,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_agents * joints_per_agent
        self.num_links = self.num_joints + 1
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.drag_normal = float(drag_normal)
        self.drag_tangent = float(drag_tangent)
        self.joint_damping = float(joint_damping)
        self.action_dim = joints_per_agent
        # A uniform chain: length 1, mass 1, rod inertias m l² / 12.
        self.link_lengths = torch.full((self.num_links,), 1.0 / self.num_links, device=self.device)
        self.masses = torch.full((self.num_links,), 1.0 / self.num_links, device=self.device)
        self.inertias = self.masses * self.link_lengths**2 / 12.0
        # own joints (cos, sin, vel) + shared (cos th, sin th, th_dot, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 5
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=2)

    # ------------------------------------------------------------ kinematics, one env
    def _body_frame(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """((L, 2) link-centre positions, (L,) absolute link angles)."""
        base, th, alpha = q[:2], q[2], q[3:]
        phi = th + F.pad(torch.cumsum(alpha, 0), (1, 0))
        u = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
        steps = self.link_lengths[:, None] * u
        joint_pos = base[None, :] + torch.cumsum(steps, 0)
        return joint_pos - 0.5 * steps, phi

    def _com(self, q: torch.Tensor) -> torch.Tensor:
        centers, _ = self._body_frame(q)
        return torch.sum(self.masses[:, None] * centers, 0) / torch.sum(self.masses)

    # ------------------------------------------------------------ dynamics, one env
    def _velocities(self, q: torch.Tensor, qd: torch.Tensor):
        return jvp(self._body_frame, (q,), (qd,))[1]

    def _kinetic(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        vel, omega = self._velocities(q, qd)
        return (
            0.5 * torch.sum(self.masses[:, None] * vel**2)
            + 0.5 * torch.sum(self.inertias * omega**2)
            + 0.5 * _ARMATURE * torch.sum(qd[3:] ** 2)
        )

    def _rayleigh(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """Dissipation of the drag along each rod: the drag force is -∂R/∂q̇."""
        vel, omega = self._velocities(q, qd)
        _, phi = self._body_frame(q)
        tangent = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
        normal = torch.stack([-torch.sin(phi), torch.cos(phi)], dim=-1)
        v_t = torch.sum(vel * tangent, -1)
        v_n = torch.sum(vel * normal, -1)
        lengths = self.link_lengths
        trans = 0.5 * torch.sum(lengths * (self.drag_normal * v_n**2 + self.drag_tangent * v_t**2))
        rot = 0.5 * torch.sum(self.drag_normal * lengths**3 / 12.0 * omega**2)
        joints = 0.5 * self.joint_damping * torch.sum(qd[3:] ** 2)
        return trans + rot + joints

    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        """M(q) = ∂²T/∂q̇² (n, n) of one env's coordinates (n,)."""
        return hessian(self._kinetic, argnums=1)(q, torch.zeros_like(q))

    def _accel(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """q̈ of one env; `tau` is zero on the base coordinates."""
        mass = self.mass_matrix(q)
        momentum = lambda q_: grad(self._kinetic, argnums=1)(q_, qd)  # noqa: E731
        coriolis = jacfwd(momentum)(q) @ qd
        dt_dq = grad(self._kinetic, argnums=0)(q, qd)
        drag = -grad(self._rayleigh, argnums=1)(q, qd)
        rhs = tau + drag - coriolis + dt_dq
        return solve(mass, rhs)

    # ------------------------------------------------------------------ API
    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(E, 1 + J): th and the joint angles, uniform on [-0.1, 0.1)."""
        return uniform_noise(num_envs, 1 + self.num_joints, 0.1, generator, self.device)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: BodyState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        e = state.q.shape[0]
        alpha = state.q[:, 3:].reshape(e, a, jpa)
        alpha_d = state.qd[:, 3:].reshape(e, a, jpa)
        com_vel = vmap(lambda q, qd: jvp(self._com, (q,), (qd,))[1])(state.q, state.qd)
        th = state.q[:, 2:3]
        shared = torch.cat(
            [torch.cos(th), torch.sin(th), state.qd[:, 2:3] / _MAX_SPEED, com_vel / _MAX_SPEED],
            dim=-1)
        agents_view = torch.cat(
            [torch.cos(alpha), torch.sin(alpha), alpha_d / _MAX_SPEED,
             shared[:, None, :].expand(e, a, 5)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[BodyState, TimeStep]:
        e = noise.shape[0]
        q = torch.cat([noise.new_zeros(e, 2), noise], dim=1)  # the base starts at the origin
        state = BodyState(torch.zeros(e, dtype=torch.int32, device=self.device), q,
                          torch.zeros_like(q))
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: BodyState, action: torch.Tensor,
             noise: None = None) -> Tuple[BodyState, TimeStep]:
        action = torch.clamp(action, -1.0, 1.0)  # (E, A, jpa)
        e = action.shape[0]
        tau = torch.cat(
            [action.new_zeros(e, 3), action.reshape(e, self.num_joints) * self.torque_scale], dim=1)
        com_before = vmap(self._com)(state.q)
        q, qd = self.integrate(state.q, state.qd, tau)
        new_state = BodyState(state.step_count + 1, q, qd)
        forward = (vmap(self._com)(q)[:, 0] - com_before[:, 0]) / _DT
        ctrl = _CTRL_COST * (action**2).sum((1, 2))
        terminated = torch.zeros(e, dtype=torch.bool, device=self.device)
        return new_state, body_timestep(forward - ctrl, terminated, new_state.step_count,
                                        self._observe(new_state), self.num_agents, self.time_limit)
