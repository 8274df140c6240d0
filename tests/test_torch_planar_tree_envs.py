"""The port's planar kinematic trees, MaCheetah (halfcheetah-6x1) and MaWalker
(walker2d-2x3), against `mava_tpu`'s, as `test_torch_planar_envs.py` holds the
serial chains: the mass matrix (1e-6), q̈ pressed into the ground, in flight
and past the joint limits (1e-5 of its largest entry) with no host read in its
graph, one step (1e-5), and a 12-step rollout through AutoReset ->
RecordEpisodeMetrics with the JAX reset's draws injected (1e-4), in which the
walker, pushed over at the start, terminates with discount 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planar_envs import (
    BODIES,
    MASS_TOL,
    NUM_ENVS,
    ROLLOUT_STEPS,
    _t,
    assert_accel_matches,
    assert_graphs_read_nothing_back,
    assert_step_matches,
    run_rollout,
    shipped,
)
from test_torch_planar_envs import jax_accel_once  # noqa: F401 (autouse: q̈ traced once)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["macheetah", "mawalker"])
def pair(request):
    return shipped(request.param)


def test_mass_matrix_matches_jax_hessian(pair):
    q, _, _, _ = pair.states(1)
    want = np.asarray(jax.jit(jax.vmap(pair.ju.mass_matrix))(jnp.asarray(q)))
    got = torch.stack([pair.tu.mass_matrix(_t(row)) for row in q]).numpy()
    np.testing.assert_allclose(got, want, **MASS_TOL)


def test_accel_matches_with_contact_flight_and_limits(pair):
    q, qd, tau, _ = pair.states(2)
    assert_accel_matches(pair, q, qd, tau)


def test_accel_graph_reads_nothing_back(pair):
    q, qd, tau, _ = pair.states(2)
    pair.tu.integrate.accel(_t(q), _t(qd), _t(tau))
    assert_graphs_read_nothing_back(pair.tu.integrate)


def test_one_step_matches_from_the_same_state(pair):
    q, qd, _, actions = pair.states(3)
    tnew, _ = assert_step_matches(pair, q, qd, actions)
    assert not np.allclose(q, tnew.env_state.q.numpy()), "the body did not move"


def test_rollout_matches_through_auto_resets(pair):
    terminations, resets = run_rollout(pair, ROLLOUT_STEPS, seed=4)
    assert resets >= NUM_ENVS
    if BODIES[pair.name][4]:
        assert terminations > 0, "the pushed body never fell"
    else:
        assert terminations == 0
