"""MaAnt: a 3D quadruped, its legs split across agents, batched over a leading
env axis (port of `mava_tpu/envs/maant.py`).

    q = (x, y, z, roll, pitch, yaw, hip_0, ankle_0, ..., hip_3, ankle_3)

Every body is a static cloud of point masses: the torso its centre and six
surface points, each leg link a 3-point rod (1/4, 1/2, 1/4 of its mass), 31
points in all. The dynamics are `pointcloud3d.newton_accel` of the points'
kinematics, the base rotation R = Rz(yaw) Ry(pitch) Rx(roll) with a small
armature on the Euler rates that keeps M positive definite through the
singularity at pitch ±π/2. Ground contact is MaHopper's, at the feet, knees
and the torso's six surface points, the friction clamped per horizontal axis;
the joints meet MaCheetah's limit springs. RK4 at dt 0.02 over 10 substeps,
q̇ clipped at 50, the joints wrapped (`q[6:]`), not the Euler angles.

Legs are ordered front-left, front-right, back-left, back-right, (hip, ankle)
within a leg: ant-4x2 is a leg per agent, ant-2x4 the front and the back half,
plain reshapes of one joint vector. The shared team reward is the forward
velocity of the centre of mass plus 1 for being healthy minus 0.5 Σa²; the
episode terminates (discount 0) when the torso leaves the band of healthy
heights or rolls or pitches past `max_tilt`. `reset_noise` draws the uniform
noise on [-0.05, 0.05) of (roll, pitch, yaw) and the joints; the reset lifts
the lowest contact point to 5 mm above the ground.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from mava_tpu_torch.envs._dynamics import (
    BodyState,
    Integrator,
    add_to_column,
    body_timestep,
    contact_force,
    limit_torque,
    uniform_noise,
)
from mava_tpu_torch.envs.pointcloud3d import mass_matrix, newton_accel
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_TORQUE_SCALE = 20.0
_MAX_SPEED = 50.0
_CTRL_COST = 0.5
_HEALTHY_BONUS = 1.0
_ARMATURE = 0.1
_BASE_ROT_ARMATURE = 0.01
_JOINT_DAMPING = 0.5
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
_LIMIT_KP = 200.0
_LIMIT_KD = 5.0

_TORSO_RADIUS = 0.25
_TORSO_MASS = 3.0
_UPPER_LEN = 0.28
_LOWER_LEN = 0.55
_LEG_MASS = 0.5  # per link
_ANKLE_REST = 1.0  # rad below horizontal at rest
_HIP_RANGE = (-0.7, 0.7)
_ANKLE_RANGE = (-0.35, 0.8)
_LEG_AZIMUTHS = (math.pi / 4, -math.pi / 4, 3 * math.pi / 4, -3 * math.pi / 4)


def rpy_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) of one (roll, pitch, yaw)."""
    cr, sr = torch.cos(rpy[0]), torch.sin(rpy[0])
    cp, sp = torch.cos(rpy[1]), torch.sin(rpy[1])
    cy, sy = torch.cos(rpy[2]), torch.sin(rpy[2])
    return torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ]).reshape(3, 3)


def base_observation(q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """(E, 13): the base's height, cos and sin of (roll, pitch, yaw), linear and
    angular rates over 10."""
    rpy = q[:, 3:6]
    return torch.cat([q[:, 2:3], torch.cos(rpy), torch.sin(rpy), qd[:, :3] / 10.0,
                      qd[:, 3:6] / 10.0], dim=-1)


class MaAnt(ContinuousEnvSpecs):
    """Batched MaAnt on one device."""

    def __init__(self, num_agents: int = 4, joints_per_agent: int = 2, time_limit: int = 250,
                 torque_scale: float = _TORQUE_SCALE, joint_damping: float = _JOINT_DAMPING,
                 gravity: float = _GRAVITY, min_torso_height: float = 0.2,
                 max_torso_height: float = 1.0, max_tilt: float = 1.2,
                 device: torch.device | str = "cpu"):
        num_joints = num_agents * joints_per_agent
        if num_joints != 8:
            raise ValueError("MaAnt has exactly 8 joints; choose a factorization with "
                             f"num_agents*joints_per_agent == 8, got {num_joints}")
        self.device = dev = torch.device(device)
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_joints
        self.time_limit = time_limit
        self.torque_scale = float(torque_scale)
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_torso_height = float(min_torso_height)
        self.max_torso_height = float(max_torso_height)
        self.max_tilt = float(max_tilt)
        self.action_dim = joints_per_agent

        f32 = dict(dtype=torch.float32, device=dev)
        self._azimuths = torch.tensor(_LEG_AZIMUTHS, **f32)
        self._joint_lo = torch.tensor([_HIP_RANGE[0], _ANKLE_RANGE[0]] * 4, **f32)
        self._joint_hi = torch.tensor([_HIP_RANGE[1], _ANKLE_RANGE[1]] * 4, **f32)
        # The torso: its centre and six surface points along ±x, ±y, ±z.
        axes = np.concatenate([np.eye(3), -np.eye(3)], axis=0)
        self._torso_offsets = torch.tensor(
            np.concatenate([np.zeros((1, 3)), _TORSO_RADIUS * axes], axis=0), **f32)
        torso_masses = torch.tensor([0.4] + [0.1] * 6, **f32) * _TORSO_MASS
        rod = torch.tensor([0.25, 0.5, 0.25], **f32) * _LEG_MASS
        # In the order of `_points`: 7 torso points, then per leg 3 upper and 3 lower.
        self._point_masses = torch.cat([torso_masses] + [rod.repeat(2)] * 4)
        self.total_mass = float(torch.sum(self._point_masses))
        self._armature = torch.cat([torch.zeros(3, **f32), torch.full((3,), _BASE_ROT_ARMATURE, **f32),
                                    torch.full((num_joints,), _ARMATURE, **f32)])
        self._down = torch.tensor([0.0, 0.0, 1.0], **f32)
        # own joints (cos, sin, vel) + shared (z, rpy cos/sin, linear and angular rates)
        self.num_obs_features = 3 * joints_per_agent + 13
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=6)

    # ------------------------------------------------------------ kinematics, one env
    def _leg_local(self, alpha: torch.Tensor):
        """Torso-frame (attach, knee, foot) of the 4 legs, from the 8 joints."""
        hip, ankle = alpha[0::2], alpha[1::2]
        beta = self._azimuths + hip
        zeros = torch.zeros_like(beta)
        e = torch.stack([torch.cos(beta), torch.sin(beta), zeros], dim=-1)
        u = torch.stack([torch.cos(self._azimuths), torch.sin(self._azimuths),
                         torch.zeros_like(self._azimuths)], dim=-1)
        attach = _TORSO_RADIUS * u  # (4, 3)
        knee = attach + _UPPER_LEN * e
        psi = _ANKLE_REST + ankle
        d = torch.cos(psi)[:, None] * e - torch.sin(psi)[:, None] * self._down[None, :]
        foot = knee + _LOWER_LEN * d
        return attach, knee, foot

    def _points(self, q: torch.Tensor) -> torch.Tensor:
        """(31, 3) world positions of every mass point."""
        rot = rpy_matrix(q[3:6])
        attach, knee, foot = self._leg_local(q[6:])
        upper = torch.stack([attach, 0.5 * (attach + knee), knee], dim=1)  # (4, 3, 3)
        lower = torch.stack([knee, 0.5 * (knee + foot), foot], dim=1)
        local = torch.cat([self._torso_offsets, torch.cat([upper, lower], dim=1).reshape(-1, 3)])
        return q[None, :3] + local @ rot.T

    def _contact_points(self, q: torch.Tensor) -> torch.Tensor:
        """(14, 3): the feet, the knees and the torso's 6 surface points."""
        rot = rpy_matrix(q[3:6])
        _, knee, foot = self._leg_local(q[6:])
        local = torch.cat([foot, knee, self._torso_offsets[1:]])
        return q[None, :3] + local @ rot.T

    def _com(self, q: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._point_masses[:, None] * self._points(q), 0) / self.total_mass

    # ------------------------------------------------------------ dynamics, one env
    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        """M(q) = Jᵀ m J + diag(armature) (n, n) of one env's coordinates (n,)."""
        return mass_matrix(self._points, self._point_masses, self._armature, q)

    def _accel(self, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        damping = -self.joint_damping * F.pad(qd[6:], (6, 0))
        limits = F.pad(limit_torque(q[6:], qd[6:], self._joint_lo, self._joint_hi,
                                    _LIMIT_KP, _LIMIT_KD), (6, 0))
        contact = contact_force(self._contact_points, q, qd, 2, _CONTACT_KP, _CONTACT_KD,
                                _CONTACT_KT, _FRICTION_MU)
        applied = tau + contact + damping + limits
        return newton_accel(self._points, self._point_masses, self._armature, self.gravity,
                            q, qd, applied)

    def _healthy(self, q: torch.Tensor) -> torch.Tensor:
        z_ok = (q[2] > self.min_torso_height) & (q[2] < self.max_torso_height)
        tilt_ok = (torch.abs(q[3]) < self.max_tilt) & (torch.abs(q[4]) < self.max_tilt)
        return z_ok & tilt_ok

    # ------------------------------------------------------------------ API
    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(E, 3 + 8): (roll, pitch, yaw) and the joints, uniform on [-0.05, 0.05)."""
        return uniform_noise(num_envs, 3 + self.num_joints, 0.05, generator, self.device)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: BodyState) -> Observation:
        a, jpa = self.num_agents, self.joints_per_agent
        q, qd = state.q, state.qd
        e = q.shape[0]
        alpha = q[:, 6:].reshape(e, a, jpa)
        alpha_d = qd[:, 6:].reshape(e, a, jpa)
        shared = base_observation(q, qd)
        agents_view = torch.cat(
            [torch.cos(alpha), torch.sin(alpha), alpha_d / 10.0,
             shared[:, None, :].expand(e, a, 13)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[BodyState, TimeStep]:
        e = noise.shape[0]
        q = F.pad(noise, (3, 0))
        lowest = vmap(self._contact_points)(q)[:, :, 2].amin(1)
        q = add_to_column(q, 2, _STAND_CLEARANCE - lowest)
        state = BodyState(torch.zeros(e, dtype=torch.int32, device=self.device), q,
                          torch.zeros_like(q))
        return state, restart(self._observe(state), {}, self.num_agents)

    def step(self, state: BodyState, action: torch.Tensor,
             noise: None = None) -> Tuple[BodyState, TimeStep]:
        action = torch.clamp(action, -1.0, 1.0)  # (E, A, jpa)
        e = action.shape[0]
        tau = torch.cat(
            [action.new_zeros(e, 6), action.reshape(e, self.num_joints) * self.torque_scale], dim=1)
        com_before = vmap(self._com)(state.q)
        q, qd = self.integrate(state.q, state.qd, tau)
        new_state = BodyState(state.step_count + 1, q, qd)
        forward = (vmap(self._com)(q)[:, 0] - com_before[:, 0]) / _DT
        ctrl = _CTRL_COST * (action**2).sum((1, 2))
        terminated = ~vmap(self._healthy)(q)
        return new_state, body_timestep(forward + _HEALTHY_BONUS - ctrl, terminated,
                                        new_state.step_count, self._observe(new_state),
                                        self.num_agents, self.time_limit)
