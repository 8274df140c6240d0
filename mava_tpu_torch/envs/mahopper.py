"""MaHopper: a planar hopper (torso, thigh, leg, foot) on the ground, its
joints split across agents, batched over a leading env axis (port of
`mava_tpu/envs/mahopper.py`).

hopper-3x1 is 3 agents x 1 joint (hip, knee, ankle). The chain hangs from a
free (x, y, th) base at the torso's tip; the Lagrangian machinery is
MaSwimmer's, with gravity and the ground:

    M q̈ = τ + Q_contact − c_j q̇_joints − C(q, q̇) q̇ + ∂T/∂q − ∂V/∂q

Contact is a compliant penalty at the base and every link end: at depth
d > 0 and velocity v, F_n = max(0, kp d − kd v_y) and F_t = clip(−kt v_x,
±μ F_n), mapped to q through the `torch.func.vjp` of the contact points.
RK4 at dt 0.02 over 10 substeps, q̇ clipped at 50, the joint angles wrapped
(`q[3:]`): th is held by the pitch termination and stays as it is.

The shared team reward is the forward velocity of the centre of mass plus 1
for being healthy minus 0.001 Σa²; the episode terminates (discount 0) when the
torso drops below `min_torso_height` or pitches past `max_pitch`. `reset_noise`
draws the uniform pose noise on [-0.05, 0.05) of th and the joints; the reset
then lifts the base so that the lowest contact point stands at 5 mm.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad, hessian, jacfwd, jvp, vmap

from mava_tpu_torch.envs._dynamics import (
    BodyState,
    Integrator,
    add_to_column,
    body_timestep,
    contact_force,
    solve,
    uniform_noise,
)
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_TORQUE_SCALE = 30.0
_MAX_SPEED = 50.0
_CTRL_COST = 1e-3
_HEALTHY_BONUS = 1.0
_ARMATURE = 0.1
_JOINT_DAMPING = 0.5
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9
_LINK_LENGTHS = (0.5, 0.45, 0.5, 0.35)  # torso, thigh, leg, foot
_STAND_CLEARANCE = 0.005


class MaHopper(ContinuousEnvSpecs):
    """Batched MaHopper on one device."""

    def __init__(self, num_agents: int = 3, joints_per_agent: int = 1, time_limit: int = 250,
                 torque_scale: float = _TORQUE_SCALE, joint_damping: float = _JOINT_DAMPING,
                 gravity: float = _GRAVITY, min_torso_height: float = 0.7, max_pitch: float = 0.4,
                 device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_agents * joints_per_agent
        self.num_links = self.num_joints + 1
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_torso_height = float(min_torso_height)
        self.max_pitch = float(max_pitch)
        self.action_dim = joints_per_agent
        if self.num_links == len(_LINK_LENGTHS):
            lengths = torch.tensor(_LINK_LENGTHS, device=dev)
        else:  # other factorisations: a uniform chain of the same reach
            lengths = torch.full((self.num_links,), sum(_LINK_LENGTHS) / self.num_links, device=dev)
        self.link_lengths = lengths
        self.masses = torch.ones(self.num_links, device=dev)
        self.inertias = self.masses * self.link_lengths**2 / 12.0
        # Standing: the torso straight down from the base, hip and knee
        # straight, the ankle folded so that the foot lies flat along +x.
        self._rest_joints = F.pad(torch.full((1,), math.pi / 2, device=dev), (self.num_joints - 1, 0))
        self._base_height = float(torch.sum(self.link_lengths[:-1])) + _STAND_CLEARANCE
        self._base = torch.tensor([0.0, self._base_height], device=dev)
        # own joints (cos, sin, vel) + shared (torso_y, cos th, sin th, thd, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 6
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=3)

    # ------------------------------------------------------------ kinematics, one env
    def _link_axes(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        phi = q[2] + F.pad(torch.cumsum(q[3:], 0), (1, 0))
        return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1), phi

    def _body_frame(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """((L, 2) link-centre positions, (L,) absolute link angles)."""
        u, phi = self._link_axes(q)
        steps = self.link_lengths[:, None] * u
        ends = q[None, :2] + torch.cumsum(steps, 0)
        return ends - 0.5 * steps, phi

    def _contact_points(self, q: torch.Tensor) -> torch.Tensor:
        """(L + 1, 2): the base and every link's far end."""
        u, _ = self._link_axes(q)
        ends = q[None, :2] + torch.cumsum(self.link_lengths[:, None] * u, 0)
        return torch.cat([q[None, :2], ends], dim=0)

    def _com(self, q: torch.Tensor) -> torch.Tensor:
        centers, _ = self._body_frame(q)
        return torch.sum(self.masses[:, None] * centers, 0) / torch.sum(self.masses)

    # ------------------------------------------------------------ dynamics, one env
    def _kinetic(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        vel, omega = jvp(self._body_frame, (q,), (qd,))[1]
        return (
            0.5 * torch.sum(self.masses[:, None] * vel**2)
            + 0.5 * torch.sum(self.inertias * omega**2)
            + 0.5 * _ARMATURE * torch.sum(qd[3:] ** 2)
        )

    def _potential(self, q: torch.Tensor) -> torch.Tensor:
        centers, _ = self._body_frame(q)
        return self.gravity * torch.sum(self.masses * centers[:, 1])

    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        """M(q) = ∂²T/∂q̇² (n, n) of one env's coordinates (n,)."""
        return hessian(self._kinetic, argnums=1)(q, torch.zeros_like(q))

    def _accel(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        mass = self.mass_matrix(q)
        momentum = lambda q_: grad(self._kinetic, argnums=1)(q_, qd)  # noqa: E731
        coriolis = jacfwd(momentum)(q) @ qd
        dt_dq = grad(self._kinetic, argnums=0)(q, qd)
        dv_dq = grad(self._potential)(q)
        damping = -self.joint_damping * F.pad(qd[3:], (3, 0))
        contact = contact_force(self._contact_points, q, qd, 1, _CONTACT_KP, _CONTACT_KD,
                                _CONTACT_KT, _FRICTION_MU)
        rhs = tau + contact + damping - coriolis + dt_dq - dv_dq
        return solve(mass, rhs)

    # ------------------------------------------------------------ health, one env
    def _torso_height(self, q: torch.Tensor) -> torch.Tensor:
        return self._body_frame(q)[0][0, 1]

    def _healthy(self, q: torch.Tensor) -> torch.Tensor:
        rest = -math.pi / 2
        pitch = torch.atan2(torch.sin(q[2] - rest), torch.cos(q[2] - rest))
        return (self._torso_height(q) > self.min_torso_height) & (torch.abs(pitch) < self.max_pitch)

    # ------------------------------------------------------------------ API
    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(E, 1 + J): th and the joint angles, uniform on [-0.05, 0.05)."""
        return uniform_noise(num_envs, 1 + self.num_joints, 0.05, generator, self.device)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: BodyState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        q, qd = state.q, state.qd
        e = q.shape[0]
        alpha = q[:, 3:].reshape(e, a, jpa)
        alpha_d = qd[:, 3:].reshape(e, a, jpa)
        shared = torch.stack([vmap(self._torso_height)(q), torch.cos(q[:, 2]), torch.sin(q[:, 2]),
                              qd[:, 2] / 10.0, qd[:, 0] / 10.0, qd[:, 1] / 10.0], dim=-1)
        agents_view = torch.cat(
            [torch.cos(alpha), torch.sin(alpha), alpha_d / 10.0, shared[:, None, :].expand(e, a, 6)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[BodyState, TimeStep]:
        e = noise.shape[0]
        base = self._base.to(noise.dtype).expand(e, 2)
        q = torch.cat([base, -math.pi / 2 + noise[:, :1], self._rest_joints + noise[:, 1:]], dim=1)
        # Pose noise can tilt the foot below the ground: the lowest contact
        # point starts at the clearance.
        lowest = vmap(self._contact_points)(q)[:, :, 1].amin(1)
        q = add_to_column(q, 1, _STAND_CLEARANCE - lowest)
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
        terminated = ~vmap(self._healthy)(q)
        return new_state, body_timestep(forward + _HEALTHY_BONUS - ctrl, terminated,
                                        new_state.step_count, self._observe(new_state),
                                        self.num_agents, self.time_limit)
