"""MaHumanoid: a two-agent 3D humanoid, batched over a leading env axis (port
of `mava_tpu/envs/mahumanoid.py`).

humanoid-9-8 splits the 17 actuated joints into an upper-body agent (abdomen
x3, two shoulders x2, two elbows: 9 joints) and a lower-body agent (two 3-DOF
hips, two knees: 8). Views and actions are rectangles, so the lower agent is
padded to 9: `action_mask[:, 1, 8]` is False, its view reads zeros there, its
action there moves nothing and costs nothing.

The body is MaAnt's engine over an 11-body tree (pelvis -> torso -> head and
arms, pelvis -> legs) whose ball joints are Rz Ry Rx chains: q in R²³ = 6 free
base + 17 joints, 35 mass points, 13 contact points. RK4 at dt 0.02 over 10
substeps, q̇ clipped at 50, the joints wrapped (`q[6:]`).

The shared team reward is 1.25 x the forward velocity of the centre of mass
plus 5 for being healthy minus 0.1 Σa² over the 17 real joints; the episode
terminates (discount 0) when the pelvis leaves the band of healthy heights or
the base tilts past `max_tilt`. `reset_noise` draws the uniform noise on
[-0.03, 0.03) of (roll, pitch, yaw) and the joints; the reset lifts the lowest
contact point to 5 mm above the ground.
"""

from __future__ import annotations

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
from mava_tpu_torch.envs.maant import base_observation, rpy_matrix
from mava_tpu_torch.envs.pointcloud3d import mass_matrix, newton_accel
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_MAX_SPEED = 50.0
_CTRL_COST = 0.1
_HEALTHY_BONUS = 5.0
_FORWARD_WEIGHT = 1.25
_ARMATURE = 0.1
_BASE_ROT_ARMATURE = 0.02
_JOINT_DAMPING = 1.0
_CONTACT_KP = 12000.0
_CONTACT_KD = 250.0
_CONTACT_KT = 400.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
_LIMIT_KP = 300.0
_LIMIT_KD = 8.0

# geometry (m)
_PELVIS_HALF = 0.12
_TORSO_LEN = 0.50
_HEAD_OFF = 0.15
_SHOULDER_HALF = 0.17
_UARM_LEN = 0.28
_FARM_LEN = 0.25
_HIP_HALF = 0.10
_THIGH_LEN = 0.40
_SHIN_LEN = 0.40
_TOE_LEN = 0.18

# Joints, the upper agent's then the lower's: 0-2 abdomen z, y, x; 3-5 right
# shoulder 1, 2, elbow; 6-8 left; 9-12 right hip x, z, y, knee; 13-16 left.
_NUM_JOINTS = 17
_UPPER = 9
_JOINT_LO = (-0.7, -1.3, -0.6, -1.5, -1.5, -1.5, -1.5, -1.5, -1.5,
             -0.4, -0.6, -1.9, -2.6, -0.4, -0.6, -1.9, -2.6)
_JOINT_HI = (0.7, 0.5, 0.6, 1.5, 1.5, 0.9, 1.5, 1.5, 0.9,
             0.4, 0.6, 0.35, 0.0, 0.4, 0.6, 0.35, 0.0)
_TORQUE = (40.0, 40.0, 40.0, 15.0, 15.0, 10.0, 15.0, 15.0, 10.0,
           40.0, 40.0, 40.0, 40.0, 40.0, 40.0, 40.0, 40.0)

# masses (kg)
_M_PELVIS = 2.5
_M_TORSO = 4.0
_M_HEAD = 1.0
_M_THIGH = 1.5
_M_SHIN = 1.0
_M_TOE = 0.2
_M_UARM = 0.5
_M_FARM = 0.3
_ROD_FRACS = np.array([0.25, 0.5, 0.25])


def _rotation(a: torch.Tensor, entries) -> torch.Tensor:
    """A 3x3 matrix of one angle's cos and sin, its entries row by row."""
    c, s = torch.cos(a), torch.sin(a)
    parts = {"c": c, "s": s, "-s": -s, "1": torch.ones_like(a), "0": torch.zeros_like(a)}
    return torch.stack([parts[x] for x in entries]).reshape(3, 3)


def _rx(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, ("1", "0", "0", "0", "c", "-s", "0", "s", "c"))


def _ry(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, ("c", "0", "s", "0", "1", "0", "-s", "0", "c"))


def _rz(a: torch.Tensor) -> torch.Tensor:
    return _rotation(a, ("c", "-s", "0", "s", "c", "0", "0", "0", "1"))


def _rod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(3, 3): a link's ends and midpoint, its 3-point cloud."""
    return torch.stack([a, 0.5 * (a + b), b])


class MaHumanoid(ContinuousEnvSpecs):
    """Batched MaHumanoid on one device (upper body 9 joints | lower body 8,
    padded to 9)."""

    def __init__(self, time_limit: int = 250, joint_damping: float = _JOINT_DAMPING,
                 gravity: float = _GRAVITY, min_pelvis_height: float = 0.55,
                 max_pelvis_height: float = 1.2, max_tilt: float = 1.0,
                 device: torch.device | str = "cpu"):
        self.device = dev = torch.device(device)
        self.num_agents = 2
        self.num_joints = _NUM_JOINTS
        self.action_dim = _UPPER
        self.time_limit = time_limit
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.min_pelvis_height = float(min_pelvis_height)
        self.max_pelvis_height = float(max_pelvis_height)
        self.max_tilt = float(max_tilt)

        f32 = dict(dtype=torch.float32, device=dev)
        self._joint_lo = torch.tensor(_JOINT_LO, **f32)
        self._joint_hi = torch.tensor(_JOINT_HI, **f32)
        self._torque = torch.tensor(_TORQUE, **f32)
        # The pelvis: its centre and 4 points at ±x, ±y.
        axes = np.concatenate([np.eye(3)[:2], -np.eye(3)[:2]], axis=0)
        self._pelvis_offsets = torch.tensor(
            np.concatenate([np.zeros((1, 3)), _PELVIS_HALF * axes], axis=0), **f32)
        pelvis_m = np.array([0.4] + [0.15] * 4) * _M_PELVIS
        rod = _ROD_FRACS
        # In the order of `_points`.
        self._point_masses = torch.tensor(np.concatenate([
            pelvis_m, rod * _M_TORSO, [_M_HEAD],
            rod * _M_UARM, rod * _M_FARM, rod * _M_UARM, rod * _M_FARM,
            rod * _M_THIGH, rod * _M_SHIN, [_M_TOE], rod * _M_THIGH, rod * _M_SHIN, [_M_TOE],
        ]), **f32)
        self.total_mass = float(torch.sum(self._point_masses))
        self._armature = torch.cat([torch.zeros(3, **f32), torch.full((3,), _BASE_ROT_ARMATURE, **f32),
                                    torch.full((_NUM_JOINTS,), _ARMATURE, **f32)])
        # The bodies' offsets in their parents' frames, on the device: a vector
        # made from a Python list at each call would be a host-to-device copy.
        self._offsets = {name: torch.tensor(v, **f32) for name, v in {
            "pelvis_top": (0.0, 0.0, _PELVIS_HALF), "torso": (0.0, 0.0, _TORSO_LEN),
            "head": (0.0, 0.0, _HEAD_OFF), "down": (0.0, 0.0, -1.0), "toe": (_TOE_LEN, 0.0, 0.0),
            "r_shoulder": (0.0, -_SHOULDER_HALF, -0.05), "l_shoulder": (0.0, _SHOULDER_HALF, -0.05),
            "r_hip": (0.0, -_HIP_HALF, -0.05), "l_hip": (0.0, _HIP_HALF, -0.05),
        }.items()}
        self._mask = torch.tensor([[True] * _UPPER, [True] * (_NUM_JOINTS - _UPPER) + [False]],
                                  device=dev)
        # own joints (cos, sin, vel) padded to 9 + the base's 13
        self.num_obs_features = 3 * _UPPER + 13
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=6)

    # ------------------------------------------------------------ kinematics, one env
    def _bodies(self, q: torch.Tensor):
        """World-frame anchors of every body of the tree."""
        p, a = q[:3], q[6:]
        r0 = rpy_matrix(q[3:6])
        vec = {k: v.to(q.dtype) for k, v in self._offsets.items()}
        r_t = r0 @ _rz(a[0]) @ _ry(a[1]) @ _rx(a[2])
        torso_base = p + r0 @ vec["pelvis_top"]
        torso_top = torso_base + r_t @ vec["torso"]
        head = torso_top + r_t @ vec["head"]
        down = vec["down"]

        def arm(sh1, sh2, elb, side):
            sh_at = torso_top + r_t @ vec[f"{side}_shoulder"]
            r_u = r_t @ _rx(sh1) @ _ry(sh2)
            elbow = sh_at + r_u @ (down * _UARM_LEN)
            r_f = r_u @ _ry(elb)
            return sh_at, elbow, elbow + r_f @ (down * _FARM_LEN)

        def leg(hx, hz, hy, kn, side):
            hip_at = p + r0 @ vec[f"{side}_hip"]
            r_th = r0 @ _rx(hx) @ _rz(hz) @ _ry(hy)
            knee = hip_at + r_th @ (down * _THIGH_LEN)
            r_sh = r_th @ _ry(kn)
            heel = knee + r_sh @ (down * _SHIN_LEN)
            return hip_at, knee, heel, heel + r_sh @ vec["toe"]

        r_sh, r_elb, r_hand = arm(a[3], a[4], a[5], "r")
        l_sh, l_elb, l_hand = arm(a[6], a[7], a[8], "l")
        r_hip, r_knee, r_heel, r_toe = leg(a[9], a[10], a[11], a[12], "r")
        l_hip, l_knee, l_heel, l_toe = leg(a[13], a[14], a[15], a[16], "l")
        return {
            "p": p, "R0": r0, "torso_base": torso_base, "torso_top": torso_top, "head": head,
            "r_sh": r_sh, "r_elb": r_elb, "r_hand": r_hand,
            "l_sh": l_sh, "l_elb": l_elb, "l_hand": l_hand,
            "r_hip": r_hip, "r_knee": r_knee, "r_heel": r_heel, "r_toe": r_toe,
            "l_hip": l_hip, "l_knee": l_knee, "l_heel": l_heel, "l_toe": l_toe,
        }

    def _points(self, q: torch.Tensor) -> torch.Tensor:
        """(35, 3) world positions of every mass point."""
        b = self._bodies(q)
        pelvis = b["p"][None, :] + self._pelvis_offsets @ b["R0"].T
        return torch.cat([
            pelvis,
            _rod(b["torso_base"], b["torso_top"]),
            b["head"][None, :],
            _rod(b["r_sh"], b["r_elb"]), _rod(b["r_elb"], b["r_hand"]),
            _rod(b["l_sh"], b["l_elb"]), _rod(b["l_elb"], b["l_hand"]),
            _rod(b["r_hip"], b["r_knee"]), _rod(b["r_knee"], b["r_heel"]), b["r_toe"][None, :],
            _rod(b["l_hip"], b["l_knee"]), _rod(b["l_knee"], b["l_heel"]), b["l_toe"][None, :],
        ])

    def _contact_points(self, q: torch.Tensor) -> torch.Tensor:
        """(13, 3): heels and toes, knees, hands, elbows, head, pelvis, torso top."""
        b = self._bodies(q)
        return torch.stack([
            b["r_heel"], b["r_toe"], b["l_heel"], b["l_toe"], b["r_knee"], b["l_knee"],
            b["r_hand"], b["l_hand"], b["r_elb"], b["l_elb"], b["head"], b["p"], b["torso_top"],
        ])

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
        z_ok = (q[2] > self.min_pelvis_height) & (q[2] < self.max_pelvis_height)
        tilt_ok = (torch.abs(q[3]) < self.max_tilt) & (torch.abs(q[4]) < self.max_tilt)
        return z_ok & tilt_ok

    @staticmethod
    def _pad_split(alpha: torch.Tensor) -> torch.Tensor:
        """(E, 17) joint vector -> (E, 2, 9) per-agent rectangle, zero padded."""
        return F.pad(alpha, (0, 1)).reshape(alpha.shape[0], 2, _UPPER)

    # ------------------------------------------------------------------ API
    def reset_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(E, 3 + 17): (roll, pitch, yaw) and the joints, uniform on [-0.03, 0.03)."""
        return uniform_noise(num_envs, 3 + _NUM_JOINTS, 0.03, generator, self.device)

    def step_noise(self, num_envs: int, generator: Optional[torch.Generator]) -> None:
        return None

    def _observe(self, state: BodyState) -> Observation:
        q, qd = state.q, state.qd
        e = q.shape[0]
        alpha = self._pad_split(q[:, 6:])
        alpha_d = self._pad_split(qd[:, 6:])
        real = self._mask.to(q.dtype)  # the padded slot reads (0, 0, 0), not cos 0 = 1
        agents_view = torch.cat(
            [torch.cos(alpha) * real, torch.sin(alpha), alpha_d / 10.0,
             base_observation(q, qd)[:, None, :].expand(e, 2, 13)],
            dim=-1,
        )
        mask = self._mask.expand(e, 2, _UPPER)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, 2).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[BodyState, TimeStep]:
        e = noise.shape[0]
        q = F.pad(noise, (3, 0))
        lowest = vmap(self._contact_points)(q)[:, :, 2].amin(1)
        q = add_to_column(q, 2, _STAND_CLEARANCE - lowest)
        state = BodyState(torch.zeros(e, dtype=torch.int32, device=self.device), q,
                          torch.zeros_like(q))
        return state, restart(self._observe(state), {}, 2)

    def step(self, state: BodyState, action: torch.Tensor,
             noise: None = None) -> Tuple[BodyState, TimeStep]:
        action = torch.clamp(action, -1.0, 1.0)  # (E, 2, 9); [:, 1, 8] is padding
        e = action.shape[0]
        joint_act = action.reshape(e, 2 * _UPPER)[:, :_NUM_JOINTS]
        tau = torch.cat([action.new_zeros(e, 6), joint_act * self._torque], dim=1)
        com_before = vmap(self._com)(state.q)
        q, qd = self.integrate(state.q, state.qd, tau)
        new_state = BodyState(state.step_count + 1, q, qd)
        forward = (vmap(self._com)(q)[:, 0] - com_before[:, 0]) / _DT
        ctrl = _CTRL_COST * (joint_act**2).sum(1)  # the padding costs nothing
        terminated = ~vmap(self._healthy)(q)
        return new_state, body_timestep(_FORWARD_WEIGHT * forward + _HEALTHY_BONUS - ctrl,
                                        terminated, new_state.step_count,
                                        self._observe(new_state), 2, self.time_limit)
