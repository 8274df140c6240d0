"""The port's 3D point-cloud dynamics (`pointcloud3d.newton_accel`) and MaAnt
against `mava_tpu`'s.

`newton_accel` of the ant's kinematics from the same (q, q̇, applied force)
against the reference's (1e-5 of q̈'s largest entry); MaAnt at ant-4x2 as the
planar envs are held in `test_torch_planar_envs.py`: the mass matrix (1e-6),
q̈ with contact on, in flight and past the joint limits (1e-5 of the largest
entry), one step (1e-5), a 12-step rollout through the wrappers with
auto-resets (1e-4). Then the port's own invariants: `newton_accel` equals the
hessian-of-T Lagrangian (`tests/test_envs_maant.py:100`), and M stays positive
definite tilted through the pitch singularity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from mava_tpu.envs.pointcloud3d import newton_accel as jnewton_accel
from mava_tpu_torch.envs._dynamics import contact_force, limit_torque, solve
from mava_tpu_torch.envs.pointcloud3d import newton_accel
from test_torch_planar_envs import (
    MASS_TOL,
    ROLLOUT_STEPS,
    Pair,
    _t,
    assert_accel_matches,
    assert_graphs_read_nothing_back,
    assert_step_matches,
    run_rollout,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ant():
    return Pair("maant", ["env.kwargs.time_limit=10"])


def test_newton_accel_matches_jax(ant):
    q, qd, tau, _ = ant.states(1)
    ju, tu = ant.ju, ant.tu
    want = np.asarray(jax.jit(jax.vmap(lambda q, qd, f: jnewton_accel(
        ju._points, ju._point_masses, ju._armature_diag(), ju.gravity, q, qd, f)))(
        *map(jnp.asarray, (q, qd, tau))))
    got = vmap(lambda q, qd, f: newton_accel(
        tu._points, tu._point_masses, tu._armature, tu.gravity, q, qd, f))(
        *map(_t, (q, qd, tau))).numpy()
    bound = 1e-5 * np.abs(want).max(axis=1, keepdims=True) + 1e-5
    assert (np.abs(got - want) <= bound).all(), (np.abs(got - want) / bound).max()


def test_mass_matrix_matches_jax(ant):
    q, _, _, _ = ant.states(2)
    want = np.asarray(jax.jit(jax.vmap(ant.ju.mass_matrix))(jnp.asarray(q)))
    got = torch.stack([ant.tu.mass_matrix(_t(row)) for row in q]).numpy()
    np.testing.assert_allclose(got, want, **MASS_TOL)


def test_accel_matches_with_contact_flight_and_limits(ant):
    q, qd, tau, _ = ant.states(3)
    assert_accel_matches(ant, q, qd, tau)


def test_accel_graph_reads_nothing_back(ant):
    q, qd, tau, _ = ant.states(3)
    ant.tu.integrate.accel(_t(q), _t(qd), _t(tau))
    assert_graphs_read_nothing_back(ant.tu.integrate)


def test_one_step_matches_from_the_same_state(ant):
    q, qd, _, actions = ant.states(4)
    tnew, _ = assert_step_matches(ant, q, qd, actions)
    assert not np.allclose(q, tnew.env_state.q.numpy())


def test_rollout_matches_through_auto_resets(ant):
    terminations, resets = run_rollout(ant, ROLLOUT_STEPS, seed=5)
    assert resets >= 3 and terminations == 0  # the ant stands, truncated at 10


def _lagrangian_accel(env, q, qd, tau):
    """q̈ of one env from T and V by autodiff: the hessian mass matrix, the
    Coriolis term by jacfwd of the momentum, and every applied force."""
    def kinetic(q_, qd_):
        vel = jvp(env._points, (q_,), (qd_,))[1]
        return (0.5 * torch.sum(env._point_masses[:, None] * vel**2)
                + 0.5 * torch.sum(env._armature * qd_**2))

    def potential(q_):
        return env.gravity * torch.sum(env._point_masses * env._points(q_)[:, 2])

    mass = hessian(kinetic, argnums=1)(q, torch.zeros_like(q))
    coriolis = jacfwd(lambda q_: grad(kinetic, argnums=1)(q_, qd))(q) @ qd
    dt_dq = grad(kinetic, argnums=0)(q, qd)
    damping = -env.joint_damping * torch.nn.functional.pad(qd[6:], (6, 0))
    limits = torch.nn.functional.pad(
        limit_torque(q[6:], qd[6:], env._joint_lo, env._joint_hi, 200.0, 5.0), (6, 0))
    contact = contact_force(env._contact_points, q, qd, 2, 8000.0, 150.0, 300.0, 0.9)
    rhs = tau + contact + damping + limits - coriolis + dt_dq - grad(potential)(q)
    return solve(mass, rhs)


@pytest.mark.parametrize("case", ["newton_equals_lagrangian", "mass_matrix_pd_tilted"])
def test_point_cloud_invariants(ant, case):
    q, qd, tau, _ = map(_t, ant.states(7))
    if case == "newton_equals_lagrangian":
        got = ant.tu.integrate.accel(q, qd, tau)
        want = vmap(lambda *x: _lagrangian_accel(ant.tu, *x))(q, qd, tau)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        for pitch in (0.0, 1.0, np.pi / 2, 2.5):
            tilted = q[0].clone()
            tilted[4] = pitch
            assert torch.linalg.eigvalsh(ant.tu.mass_matrix(tilted)).min() > 1e-3, pitch
