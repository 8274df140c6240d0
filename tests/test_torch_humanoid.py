"""The port's MaHumanoid (humanoid-9-8) against `mava_tpu`'s, as the planar
envs are held in `test_torch_planar_envs.py`: the mass matrix (1e-6) and q̈
with contact on, in flight and past the joint limits (1e-5 of the largest
entry); one step from those states (1e-5); a 12-step rollout through
AutoReset -> RecordEpisodeMetrics with the JAX reset's draws injected (1e-4),
in which the humanoid, pushed over at the start, terminates with discount 0
and is reset. Then the padding contract of the 9 | 8 split: the mask, the
padded slot's zeros in the view, the padded action moving nothing and costing
nothing; and M positive definite tilted. One pair of envs for the file: the
JAX step is traced and compiled once (about 25 s on a CPU), and the port's
q̈ traced once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planar_envs import (
    MASS_TOL,
    NUM_ENVS,
    ROLLOUT_STEPS,
    Pair,
    _t,
    assert_accel_matches,
    assert_graphs_read_nothing_back,
    assert_step_matches,
    run_rollout,
)
from test_torch_planar_envs import jax_accel_once  # noqa: F401 (autouse: q̈ traced once)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def humanoid():
    return Pair("mahumanoid", ["env.kwargs.time_limit=10"])


def test_mass_matrix_matches_jax(humanoid):
    import jax

    q, _, _, _ = humanoid.states(1)
    want = np.asarray(jax.jit(jax.vmap(humanoid.ju.mass_matrix))(jnp.asarray(q)))
    got = torch.stack([humanoid.tu.mass_matrix(_t(row)) for row in q]).numpy()
    np.testing.assert_allclose(got, want, **MASS_TOL)


def test_accel_matches_with_contact_flight_and_limits(humanoid):
    q, qd, tau, _ = humanoid.states(2)
    assert_accel_matches(humanoid, q, qd, tau)


def test_accel_graph_reads_nothing_back(humanoid):
    q, qd, tau, _ = humanoid.states(2)
    humanoid.tu.integrate.accel(_t(q), _t(qd), _t(tau))
    assert_graphs_read_nothing_back(humanoid.tu.integrate)


def test_one_step_matches_from_the_same_state(humanoid):
    q, qd, _, actions = humanoid.states(3)
    assert_step_matches(humanoid, q, qd, actions)


def test_rollout_matches_through_auto_resets(humanoid):
    terminations, resets = run_rollout(humanoid, ROLLOUT_STEPS, seed=4)
    assert terminations > 0 and resets >= NUM_ENVS


@pytest.mark.parametrize("case", ["mask_and_view", "padded_action_is_a_no_op",
                                  "mass_matrix_pd_tilted"])
def test_padding_contract_and_invariants(humanoid, case):
    env = humanoid.tu
    state, ts = env.reset(env.reset_noise(NUM_ENVS, torch.Generator().manual_seed(0)))
    if case == "mask_and_view":
        obs = ts.observation
        assert obs.agents_view.shape == (NUM_ENVS, 2, env.num_obs_features) == (NUM_ENVS, 2, 40)
        assert obs.action_mask[:, 0].all() and obs.action_mask[:, 1, :8].all()
        assert not obs.action_mask[:, 1, 8].any()
        for slot in (8, 17, 26):  # the padded joint's cos, sin and rate
            assert (obs.agents_view[:, 1, slot] == 0).all()
    elif case == "padded_action_is_a_no_op":
        base = torch.full((NUM_ENVS, 2, 9), 0.3)
        flipped = base.clone()
        flipped[:, 1, 8] = -1.0
        real = base.clone()
        real[:, 1, 7] = -1.0
        (s_a, ts_a), (s_b, ts_b), (s_c, _) = (env.step(state, a) for a in (base, flipped, real))
        assert torch.equal(s_a.q, s_b.q) and torch.equal(ts_a.reward, ts_b.reward)
        assert not torch.equal(s_a.q, s_c.q)
    else:
        for pitch in (0.0, np.pi / 2, 2.0):
            tilted = state.q[0].clone()
            tilted[4] = pitch
            assert torch.linalg.eigvalsh(env.mass_matrix(tilted)).min() > 1e-3, pitch
