"""The port's batched MaSwarm and its wrapper chain against `mava_tpu`'s.

Both engines start from the same reset (the port handed the JAX reset's
uniform positions) and step with the same random actions through GlobalState
-> AutoReset -> RecordEpisodeMetrics for 20 steps at a time limit of 6, so
every env auto-resets three times; the port takes the positions each JAX
auto-reset draws from its env's key (maswarm.py:98-107, wrappers.py:163).
Observations, the global state, rewards, discounts, step types, the episode
metrics, the terminal observations and the states agree: ints and bools
exactly, floats to rtol = atol = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.maswarm import MaSwarm, MaSwarmResetNoise, MaSwarmState
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 4
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x, dtype=None):
    x = torch.tensor(np.asarray(x))
    return x if dtype is None else x.to(dtype)


def to_torch_state(jstate) -> RecordEpisodeMetricsState:
    s = jax.device_get(jstate)
    r = s.env_state
    swarm = MaSwarmState(_t(r.step_count, torch.int32), _t(r.pos), _t(r.vel), _t(r.landmarks))
    return RecordEpisodeMetricsState(
        swarm, _t(s.running_count_episode_return), _t(s.running_count_episode_length, torch.int32),
        _t(s.episode_return), _t(s.episode_length, torch.int32))


def reset_draws(key, unwrapped):
    """The uniform positions of `MaSwarm.reset(key)` (maswarm.py:98-105)."""
    _, pos_key, land_key = jax.random.split(key, 3)
    pos = jax.random.uniform(pos_key, (unwrapped.num_agents, 2), minval=-1.0, maxval=1.0)
    land = jax.random.uniform(land_key, (unwrapped.num_landmarks, 2), minval=-1.0, maxval=1.0)
    return pos, land


def auto_reset_draws(key, unwrapped):
    """What an auto-reset after a step of the env whose key is `key` draws."""
    return reset_draws(jax.random.split(key)[0], unwrapped)


def to_noise(draws) -> MaSwarmResetNoise:
    return MaSwarmResetNoise(*(_t(x) for x in draws))


def assert_obs_equal(tobs, jobs):
    np.testing.assert_allclose(tobs.agents_view.numpy(), np.asarray(jobs.agents_view), **FLOAT_TOL)
    np.testing.assert_array_equal(tobs.action_mask.numpy(), np.asarray(jobs.action_mask))
    np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
    if hasattr(jobs, "global_state"):
        np.testing.assert_allclose(tobs.global_state.numpy(), np.asarray(jobs.global_state),
                                   **FLOAT_TOL)


def assert_timesteps_equal(tts, jts):
    assert_obs_equal(tts.observation, jts.observation)
    if "real_next_obs" in jts.extras:
        assert_obs_equal(tts.extras["real_next_obs"], jts.extras["real_next_obs"])
    np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
    for k, v in jts.extras["episode_metrics"].items():
        np.testing.assert_allclose(tts.extras["episode_metrics"][k].numpy(), np.asarray(v),
                                   err_msg=k, **FLOAT_TOL)


def make_envs(system, overrides):
    centralised = system == "default_ff_masac"
    jenv, _ = jenvs.make(jax_load_config(system, overrides), add_global_state=centralised)
    tenv, _ = tenvs.make(load_config(system, overrides), "cpu", add_global_state=centralised)
    return jenv, tenv


@pytest.mark.parametrize("scenario,system", [
    ("spread-3ag", "default_ff_masac"),
    ("spread-5ag", "default_ff_isac"),
])
def test_reset_and_steps_match_through_auto_resets(scenario, system):
    jenv, tenv = make_envs(system, [f"env/scenario={scenario}", "env.kwargs.time_limit=6"])
    unwrapped = jenv.unwrapped
    assert (tenv.num_agents, tenv.action_dim, tenv.num_obs_features, tenv.time_limit) == (
        unwrapped.num_agents, unwrapped.action_dim, unwrapped.num_obs_features, 6)
    if system == "default_ff_masac":
        assert tenv.num_global_state_features == unwrapped.num_agents * unwrapped.num_obs_features

    keys = jax.random.split(jax.random.PRNGKey(3), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    # RecordEpisodeMetrics.reset splits its key before the inner reset.
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    tstate, tts = tenv.reset(to_noise(jax.vmap(lambda k: reset_draws(k, unwrapped))(inner)))
    assert_timesteps_equal(tts, jts)

    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: auto_reset_draws(k, unwrapped)))
    rng = np.random.default_rng(len(scenario))
    resets = 0
    for _ in range(20):
        # Actions beyond [-1, 1] too: the env clips them.
        actions = rng.uniform(-1.3, 1.3, (NUM_ENVS, unwrapped.num_agents, 2)).astype(np.float32)
        draws = draws_fn(jstate.env_state.key)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        tstate, tts = tenv.step(tstate, torch.tensor(actions), (None, to_noise(draws)))
        assert_timesteps_equal(tts, jts)
        want = to_torch_state(jstate)
        for name in MaSwarmState._fields:
            torch.testing.assert_close(getattr(tstate.env_state, name),
                                       getattr(want.env_state, name), msg=name, **FLOAT_TOL)
        resets += int(np.asarray(jts.last()).sum())
    assert resets == 3 * NUM_ENVS


def test_collisions_are_counted_once_a_pair():
    """Two agents on one spot and one far away: -1 for the pair, halved from the
    two ordered pairs (maswarm.py:84-90)."""
    env = MaSwarm(num_agents=3, time_limit=10)
    pos = torch.tensor([[[0.0, 0.0], [0.05, 0.0], [2.0, 2.0]]])
    landmarks = torch.tensor([[[0.0, 0.0], [0.05, 0.0], [2.0, 2.0]]])
    state, _ = env.reset(MaSwarmResetNoise(pos, landmarks))
    _, ts = env.step(state, torch.zeros(1, 3, 2))
    np.testing.assert_allclose(ts.reward.numpy(), -1.0, atol=1e-6)
    assert ts.discount.eq(1).all() and not ts.last().any()
