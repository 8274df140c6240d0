"""MaCheetah: a planar half-cheetah on a kinematic tree, its joints split across
agents, batched over a leading env axis (port of `mava_tpu/envs/macheetah.py`).

halfcheetah-6x1 is 6 agents x 1 joint: a torso along +x with a back and a front
leg of three links each. The tree is static, so its paths are two constant
matrices built at construction:

    phi    = th + C (alpha + rest)     C[k, j] = 1 where joint j lies on the root-to-link-k path
    starts = base + S (L u)            S[k, m] = the fraction of link m passed to reach link k

and the rest is MaHopper's machinery: the mass matrix as the hessian of T,
gravity from a potential, compliant ground contact through the vjp of the
contact points. Joints past their range meet a spring, kp 200, with a damper,
kd 5, that acts only while the limit is engaged (`excess != 0`). RK4 at dt
0.02 over 10 substeps, q̇ clipped at 50, the joint angles wrapped (`q[3:]`).

The shared team reward is the forward velocity of the centre of mass minus
0.1 Σa²; the half-cheetah never terminates (MaWalker, its subclass, does).
The body, its limits, torques and reward weights are class attributes for
the subclass to set. `reset_noise` draws the uniform pose noise on
[-0.05, 0.05) of th and the joints; the reset lifts the lowest contact point to
5 mm above the ground.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, hessian, jacfwd, jvp, vmap

from mava_tpu_torch.envs._dynamics import (
    BodyState,
    Integrator,
    add_to_column,
    body_timestep,
    contact_force,
    limit_torque,
    solve,
    uniform_noise,
)
from mava_tpu_torch.specs import ContinuousEnvSpecs
from mava_tpu_torch.types import Observation, TimeStep, restart

_DT = 0.02
_SUBSTEPS = 10
_GRAVITY = 9.8
_MAX_SPEED = 50.0
_ARMATURE = 0.1
_JOINT_DAMPING = 0.5
_CONTACT_KP = 8000.0
_CONTACT_KD = 150.0
_CONTACT_KT = 300.0
_FRICTION_MU = 0.9
_STAND_CLEARANCE = 0.005
_LIMIT_KP = 200.0
_LIMIT_KD = 5.0

# link: (name, parent, anchor fraction on the parent, length, rest angle offset);
# joint order (= agent order): bthigh bshin bfoot fthigh fshin ffoot.
_TOPOLOGY = (
    ("torso", -1, 0.0, 1.00, 0.0),
    ("bthigh", 0, 0.0, 0.30, -1.90),
    ("bshin", 1, 1.0, 0.30, 0.70),
    ("bfoot", 2, 1.0, 0.20, 0.50),
    ("fthigh", 0, 1.0, 0.30, -1.20),
    ("fshin", 4, 1.0, 0.30, -0.60),
    ("ffoot", 5, 1.0, 0.20, 0.60),
)


class MaCheetah(ContinuousEnvSpecs):
    """Batched MaCheetah on one device."""

    TOPOLOGY = _TOPOLOGY
    JOINT_LO = (-0.5, -0.8, -0.5, -1.0, -1.0, -0.5)
    JOINT_HI = (1.0, 0.8, 0.8, 0.7, 0.9, 0.5)
    DEFAULT_TORQUE = 15.0
    CTRL_COST = 0.1
    HEALTHY_BONUS = 0.0  # no alive bonus, and no termination
    TORSO_REST = 0.0  # the torso lies along +x

    def __init__(self, num_agents: int = 6, joints_per_agent: int = 1, time_limit: int = 250,
                 torque_scale: float | None = None, joint_damping: float = _JOINT_DAMPING,
                 gravity: float = _GRAVITY, device: torch.device | str = "cpu"):
        topology = self.TOPOLOGY
        num_joints = num_agents * joints_per_agent
        if num_joints != len(topology) - 1:
            raise ValueError(
                f"{type(self).__name__} has exactly {len(topology) - 1} joints; choose a "
                f"factorization with num_agents*joints_per_agent == {len(topology) - 1}, "
                f"got {num_joints}")
        self.device = dev = torch.device(device)
        self.num_agents = num_agents
        self.joints_per_agent = joints_per_agent
        self.num_joints = num_joints
        self.num_links = links = len(topology)
        self.time_limit = time_limit
        self.torque_scale = float(self.DEFAULT_TORQUE if torque_scale is None else torque_scale)
        self.joint_damping = float(joint_damping)
        self.gravity = float(gravity)
        self.action_dim = joints_per_agent
        self.link_lengths = torch.tensor([t[3] for t in topology], dtype=torch.float32, device=dev)
        self._rest_offsets = torch.tensor([t[4] for t in topology][1:], dtype=torch.float32,
                                          device=dev)
        self.masses = self.link_lengths  # density 1
        self.inertias = self.masses * self.link_lengths**2 / 12.0
        # The path matrices: numpy at construction, constants on the device.
        paths = np.zeros((links, links - 1))
        fractions = np.zeros((links, links))
        for k in range(1, links):
            parent = topology[k][1]
            paths[k] = paths[parent]
            paths[k, k - 1] = 1.0
            fractions[k] = fractions[parent]
            fractions[k, parent] += topology[k][2]
        self._C = torch.tensor(paths, dtype=torch.float32, device=dev)
        self._S = torch.tensor(fractions, dtype=torch.float32, device=dev)
        self._joint_lo = torch.tensor(self.JOINT_LO, dtype=torch.float32, device=dev)
        self._joint_hi = torch.tensor(self.JOINT_HI, dtype=torch.float32, device=dev)
        # own joints (cos, sin, vel) + shared (torso_y, cos th, sin th, thd, vx, vy)
        self.num_obs_features = 3 * joints_per_agent + 6
        self.integrate = Integrator(self._accel, _DT, _SUBSTEPS, _MAX_SPEED, wrap_from=3)

    # ------------------------------------------------------------ kinematics, one env
    def _frames(self, q: torch.Tensor):
        """((L, 2) link starts, (L, 2) link vectors, (L,) absolute angles)."""
        phi = q[2] + self._C @ (q[3:] + self._rest_offsets)
        u = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
        steps = self.link_lengths[:, None] * u
        return q[None, :2] + self._S @ steps, steps, phi

    def _body_frame(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        starts, steps, phi = self._frames(q)
        return starts + 0.5 * steps, phi

    def _contact_points(self, q: torch.Tensor) -> torch.Tensor:
        """(L + 1, 2): the base and every link's far end."""
        starts, steps, _ = self._frames(q)
        return torch.cat([q[None, :2], starts + steps], dim=0)

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
        limits = F.pad(limit_torque(q[3:], qd[3:], self._joint_lo, self._joint_hi,
                                    _LIMIT_KP, _LIMIT_KD), (3, 0))
        contact = contact_force(self._contact_points, q, qd, 1, _CONTACT_KP, _CONTACT_KD,
                                _CONTACT_KT, _FRICTION_MU)
        rhs = tau + contact + damping + limits - coriolis + dt_dq - dv_dq
        return solve(mass, rhs)

    def _terminated(self, q: torch.Tensor) -> torch.Tensor:
        """Failure of one env: never for the half-cheetah."""
        return torch.zeros((), dtype=torch.bool, device=q.device)

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
        torso_y = vmap(self._body_frame)(q)[0][:, 0, 1]
        shared = torch.stack([torso_y, torch.cos(q[:, 2]), torch.sin(q[:, 2]),
                              qd[:, 2] / 10.0, qd[:, 0] / 10.0, qd[:, 1] / 10.0], dim=-1)
        agents_view = torch.cat(
            [torch.cos(alpha), torch.sin(alpha), alpha_d / 10.0, shared[:, None, :].expand(e, a, 6)],
            dim=-1,
        )
        mask = torch.ones((e, a, self.action_dim), dtype=torch.bool, device=self.device)
        return Observation(agents_view, mask, state.step_count[:, None].expand(e, a).contiguous())

    def reset(self, noise: torch.Tensor) -> Tuple[BodyState, TimeStep]:
        e = noise.shape[0]
        rest = F.pad(noise.new_full((1,), self.TORSO_REST), (2, self.num_joints))
        q = rest + F.pad(noise, (2, 0))
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
        ctrl = self.CTRL_COST * (action**2).sum((1, 2))
        terminated = vmap(self._terminated)(q)
        return new_state, body_timestep(forward + self.HEALTHY_BONUS - ctrl, terminated,
                                        new_state.step_count, self._observe(new_state),
                                        self.num_agents, self.time_limit)
