"""Invariants of the port's articulated dynamics that need no JAX: MaReacher's
traced q̈ holds no host read (the shared unchecked solve); a whole RK4 substep
traced as one graph equals the substep run over the traced q̈ (what a step
runs); and MaSwimmer's physics: isotropic drag cannot swim (the scallop
theorem), a travelling wave swims with the anisotropic drag, and energy and
momentum hold without dissipation.
"""

import pytest
import torch

from mava_tpu_torch.envs._dynamics import rk4_substep
from mava_tpu_torch.envs.mareacher import MaReacher
from test_torch_planar_envs import _t, assert_graphs_read_nothing_back, shipped

torch.set_num_threads(1)


def test_mareacher_accel_graph_reads_nothing_back():
    """MaReacher's q̈ shares the solve without an error check (`torch.linalg.solve`
    traced an `aten._linalg_check_errors`)."""
    env = MaReacher(2, 1)
    state, _ = env.reset(env.reset_noise(2, torch.Generator().manual_seed(0)))
    env.integrate.accel(state.q, state.qd, torch.zeros_like(state.q))
    assert_graphs_read_nothing_back(env.integrate)


def test_traced_substep_equals_the_substep_over_traced_accel():
    q, qd, tau, _ = map(_t, shipped("maswimmer").states(6))
    integ = shipped("maswimmer").tu.integrate
    got = integ.traced_substep(q, qd, tau)
    want = rk4_substep(integ.accel, q, qd, tau, integ.h, integ.max_speed)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _gait_displacement(env, steps=60):
    """Centre-of-mass x travel of an open-loop travelling wave (the reference's
    `test_envs_maswimmer.py` gait, amplitude 1, ω 6, phase lag -1.5)."""
    state, _ = env.reset(torch.zeros(1, 1 + env.num_joints))
    com = torch.func.vmap(env._com)
    start = com(state.q)[0, 0]
    lags = torch.arange(env.num_joints)
    for t in range(steps):
        torque = torch.sin(6.0 * t * 0.04 - (-1.5) * lags)
        state, _ = env.step(state, torque.clamp(-1, 1).reshape(1, env.num_agents, -1))
    return float(com(state.q)[0, 0] - start)


@pytest.mark.parametrize("case", ["isotropic_drag_cannot_swim", "anisotropic_drag_swims",
                                  "energy_and_momentum_conserved"])
def test_swimmer_invariants(case):
    from mava_tpu_torch.envs.maswimmer import MaSwimmer

    if case == "isotropic_drag_cannot_swim":
        assert abs(_gait_displacement(MaSwimmer(2, 1, drag_normal=2.0, drag_tangent=2.0))) < 1e-3
    elif case == "anisotropic_drag_swims":
        assert _gait_displacement(MaSwimmer(2, 1)) > 0.05
    else:
        env = MaSwimmer(2, 1, drag_normal=0.0, drag_tangent=0.0, joint_damping=0.0)
        state, _ = env.reset(torch.zeros(1, 3))
        qd0 = torch.tensor([[0.3, -0.2, 0.5, 1.0, -0.7]])
        energy = lambda q, qd: torch.func.vmap(env._kinetic)(q, qd)  # noqa: E731
        com_v = lambda q, qd: torch.func.vmap(  # noqa: E731
            lambda a, b: torch.func.jvp(env._com, (a,), (b,))[1])(q, qd)
        q, qd = state.q, qd0
        for _ in range(40):
            q, qd = env.integrate(q, qd, torch.zeros_like(q))
        e0 = float(energy(state.q, qd0)[0])
        assert abs(float(energy(q, qd)[0]) - e0) / e0 < 1e-4
        torch.testing.assert_close(com_v(q, qd), com_v(state.q, qd0), rtol=0, atol=1e-5)
