"""The port's batched MaReacher against `mava_tpu`'s.

The port's dynamics are `torch.func` autodiff of the same Lagrangian as the
reference's `jax` autodiff: the mass matrix against `jax.hessian` (1e-6), one
step from the same states and torques (states, observations and rewards to
rtol = atol = 1e-5: RK4 over 4 substeps of 4 solves each), and a 20-step
rollout through AutoReset -> RecordEpisodeMetrics with auto-resets from the
JAX reset's draws (rtol = atol = 1e-4: the float32 rounding of the two
autodiff graphs differs and RK4 carries it from step to step). The rollout
reads observations, rewards, step types, discounts, episode metrics, the
terminal observations and the (q, q̇, target) states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.envs.mareacher import MaReacher as JMaReacher
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.mareacher import MaReacher, MaReacherResetNoise, MaReacherState
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 3
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x, dtype=None):
    x = torch.tensor(np.asarray(x))
    return x if dtype is None else x.to(dtype)


def reset_draws(key, unwrapped):
    """The draws of `MaReacher.reset(key)` (mareacher.py:186-195)."""
    _, q_key, t_key = jax.random.split(key, 3)
    q = jax.random.uniform(q_key, (unwrapped.num_joints,), minval=-jnp.pi, maxval=jnp.pi)
    r_key, a_key = jax.random.split(t_key)
    radius = jax.random.uniform(r_key, (), minval=0.2, maxval=0.9)
    angle = jax.random.uniform(a_key, (), minval=-jnp.pi, maxval=jnp.pi)
    return q, radius, angle


def to_noise(draws) -> MaReacherResetNoise:
    return MaReacherResetNoise(*(_t(x) for x in draws))


@pytest.mark.parametrize("agents,joints", [(2, 1), (3, 2)])
def test_mass_matrix_matches_jax_hessian(agents, joints):
    tenv, jenv = MaReacher(agents, joints), JMaReacher(agents, joints)
    q = np.random.default_rng(agents).uniform(-np.pi, np.pi, (5, agents * joints)).astype(np.float32)
    for row in q:
        np.testing.assert_allclose(tenv.mass_matrix(torch.tensor(row)).numpy(),
                                   np.asarray(jenv.mass_matrix(jnp.asarray(row))),
                                   rtol=1e-6, atol=1e-6)


def _random_state(agents, joints, seed):
    rng = np.random.default_rng(seed)
    n = agents * joints
    q = rng.uniform(-np.pi, np.pi, (NUM_ENVS, n)).astype(np.float32)
    qd = rng.uniform(-3.0, 3.0, (NUM_ENVS, n)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (NUM_ENVS, 2)).astype(np.float32)
    actions = rng.uniform(-1.2, 1.2, (NUM_ENVS, agents, joints)).astype(np.float32)
    return q, qd, target, actions


def _jax_step(jenv, q, qd, target, actions):
    steps = np.full((NUM_ENVS,), 4, np.int32)
    jstate = jax.vmap(lambda k, *s: jenv.reset(k)[0].replace(step_count=s[0], q=s[1], qd=s[2],
                                                            target=s[3]))(
        jax.random.split(jax.random.PRNGKey(0), NUM_ENVS), *map(jnp.asarray, (steps, q, qd, target)))
    return jax.vmap(jenv.step)(jstate, jnp.asarray(actions))


@pytest.mark.parametrize("agents,joints,gravity", [(2, 1, 0.0), (2, 2, 9.81)])
def test_one_step_matches_from_the_same_state(agents, joints, gravity):
    tenv = MaReacher(agents, joints, gravity=gravity)
    jenv = JMaReacher(agents, joints, gravity=gravity)
    q, qd, target, actions = _random_state(agents, joints, seed=agents + joints)
    jnew, jts = _jax_step(jenv, q, qd, target, actions)
    steps = torch.full((NUM_ENVS,), 4, dtype=torch.int32)
    tnew, tts = tenv.step(MaReacherState(steps, _t(q), _t(qd), _t(target)), torch.tensor(actions))
    for name in ("q", "qd", "target", "step_count"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                   err_msg=name, **STEP_TOL)
    np.testing.assert_allclose(tts.observation.agents_view.numpy(),
                               np.asarray(jts.observation.agents_view), **STEP_TOL)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **STEP_TOL)
    assert not np.allclose(q, tnew.q.numpy()), "the arm did not move"


def test_six_links_are_as_close_to_float64_as_the_reference():
    """reacher-3x2 (six light links) at |q̇| up to 3: the mass matrix is ill
    conditioned (cond ~100-450) and q̈ reaches ~10^3, so float32 rounding moves
    a step by ~1e-4 in either engine. Both are held to the port's own float64
    step: the port's float32 error is at most 1.5x the reference's (and under
    1e-3)."""
    tenv, jenv = MaReacher(3, 2), JMaReacher(3, 2)
    q, qd, target, actions = _random_state(3, 2, seed=5)
    jnew, _ = _jax_step(jenv, q, qd, target, actions)
    state = MaReacherState(torch.full((NUM_ENVS,), 4, dtype=torch.int32), _t(q), _t(qd), _t(target))
    tnew, _ = tenv.step(state, torch.tensor(actions))
    env64 = MaReacher(3, 2)
    env64.link_lengths, env64.masses = env64.link_lengths.double(), env64.masses.double()
    state64 = state._replace(q=state.q.double(), qd=state.qd.double(), target=state.target.double())
    exact, _ = env64.step(state64, torch.tensor(actions).double())
    for name in ("q", "qd"):
        want = getattr(exact, name).numpy()
        port_err = np.abs(getattr(tnew, name).numpy() - want).max()
        ref_err = np.abs(np.asarray(getattr(jnew, name)) - want).max()
        assert port_err <= max(1.5 * ref_err, 1e-5) and port_err < 1e-3, (name, port_err, ref_err)


def test_rollout_matches_through_auto_resets():
    overrides = ["env=mareacher", "env.kwargs.time_limit=8"]
    jenv, _ = jenvs.make(jax_load_config("default_ff_isac", overrides))
    tenv, _ = tenvs.make(load_config("default_ff_isac", overrides), "cpu")
    unwrapped = jenv.unwrapped
    assert (tenv.num_agents, tenv.action_dim, tenv.num_obs_features) == (
        unwrapped.num_agents, unwrapped.action_dim, unwrapped.num_obs_features)

    keys = jax.random.split(jax.random.PRNGKey(5), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    tstate, tts = tenv.reset(to_noise(jax.vmap(lambda k: reset_draws(k, unwrapped))(inner)))
    np.testing.assert_allclose(tts.observation.agents_view.numpy(),
                               np.asarray(jts.observation.agents_view), **STEP_TOL)

    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: reset_draws(jax.random.split(k)[0], unwrapped)))
    rng = np.random.default_rng(1)
    resets = 0
    for _ in range(20):
        actions = rng.uniform(-1.0, 1.0, (NUM_ENVS, unwrapped.num_agents, 1)).astype(np.float32)
        draws = draws_fn(jstate.env_state.key)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        tstate, tts = tenv.step(tstate, torch.tensor(actions), (None, to_noise(draws)))
        for obs in ("observation", "real_next_obs"):
            tobs = tts.observation if obs == "observation" else tts.extras[obs]
            jobs = jts.observation if obs == "observation" else jts.extras[obs]
            np.testing.assert_allclose(tobs.agents_view.numpy(), np.asarray(jobs.agents_view),
                                       err_msg=obs, **ROLLOUT_TOL)
            np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **ROLLOUT_TOL)
        np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
        np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
        for k, v in jts.extras["episode_metrics"].items():
            np.testing.assert_allclose(tts.extras["episode_metrics"][k].numpy(), np.asarray(v),
                                       err_msg=k, **ROLLOUT_TOL)
        r = jax.device_get(jstate.env_state)
        for name in ("q", "qd", "target"):
            np.testing.assert_allclose(getattr(tstate.env_state, name).numpy(),
                                       np.asarray(getattr(r, name)), err_msg=name, **ROLLOUT_TOL)
        resets += int(np.asarray(jts.last()).sum())
    assert resets == 2 * NUM_ENVS
    assert isinstance(tstate, RecordEpisodeMetricsState)
