"""Newton-d'Alembert dynamics of 3D point-cloud bodies (MaAnt, MaHumanoid);
port of `mava_tpu/envs/pointcloud3d.py`.

For a body of point masses at x_p = points(q) plus constant rotor armatures,
the Euler-Lagrange equations collapse to

    M(q) q̈ = Jᵀ m (g − J̇ q̇) + Q_applied,    M(q) = Jᵀ diag(m) J + diag(armature)

with J = ∂points/∂q: M from one `torch.func.jacfwd` of the kinematics, gravity
and every Coriolis and centrifugal term in the bias acceleration J̇ q̇ (two
nested `torch.func.jvp`), the force back to q by one `torch.func.vjp`. It is
the hessian-of-T Lagrangian of the planar envs with a smaller graph, and M is
positive definite by construction.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, jvp, vjp

from mava_tpu_torch.envs._dynamics import solve


def mass_matrix(points_fn: Callable[[torch.Tensor], torch.Tensor], point_masses: torch.Tensor,
                armature_diag: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M(q) = Jᵀ diag(m) J + diag(armature) (n, n) of one env's q (n,)."""
    jac = jacfwd(points_fn)(q)  # (P, 3, n)
    m_jac = point_masses[:, None, None] * jac
    return torch.einsum("pin,pim->nm", m_jac, jac) + torch.diag(armature_diag)


def newton_accel(points_fn: Callable[[torch.Tensor], torch.Tensor], point_masses: torch.Tensor,
                 armature_diag: torch.Tensor, gravity: float, q: torch.Tensor, qd: torch.Tensor,
                 applied: torch.Tensor) -> torch.Tensor:
    """q̈ of one env; `applied` holds every generalised force but gravity and
    the inertial ones (motors, contact, damping, joint limits)."""
    mass = mass_matrix(points_fn, point_masses, armature_diag, q)
    vel_fn = lambda q_: jvp(points_fn, (q_,), (qd,))[1]  # noqa: E731
    acc_bias = jvp(vel_fn, (q,), (qd,))[1]  # (P, 3)

    g_vec = torch.nn.functional.pad(q.new_full((1,), -gravity), (2, 0))  # made on q's device
    f_pts = point_masses[:, None] * (g_vec[None, :] - acc_bias)
    _, pullback = vjp(points_fn, q)
    rhs = applied + pullback(f_pts)[0]
    return solve(mass, rhs)
