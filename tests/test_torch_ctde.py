"""Centralised training of the port against `mava_tpu`'s: the global state that
`GlobalStateWrapper` and `make(..., add_global_state=True)` attach (exact), and
one rec-MAPPO update against the JAX learner (rtol = atol = 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.rware import RobotWarehouse
from mava_tpu_torch.envs.wrappers import GlobalStateWrapper
from mava_tpu_torch.types import ObservationGlobalState
from mava_tpu_torch.utils.config import load_config
from test_torch_rec_ippo import check_one_recurrent_update
from test_torch_rware import (
    NUM_ENVS,
    _assert_timesteps_equal,
    _reset_draws,
    _reset_noise,
    _step_draws,
    _to_torch_state,
)

torch.set_num_threads(1)


def _assert_global_state(tts, jts, num_agents):
    tobs, jobs = tts.observation, jts.observation
    assert isinstance(tobs, ObservationGlobalState)
    np.testing.assert_array_equal(tobs.global_state.numpy(), np.asarray(jobs.global_state))
    # Built under the AgentID wrapper: every agent's view without its one-hot id.
    views = tobs.agents_view[:, :, num_agents:]
    assert tobs.global_state.shape == (views.shape[0], num_agents, num_agents * views.shape[2])
    for agent in range(num_agents):
        torch.testing.assert_close(tobs.global_state[:, agent], views.flatten(1), rtol=0, atol=0)
    ids = tobs.agents_view[:, :, :num_agents]
    torch.testing.assert_close(ids, torch.eye(num_agents).expand_as(ids), rtol=0, atol=0)
    real_next = tts.extras["real_next_obs"]
    np.testing.assert_array_equal(real_next.global_state.numpy(),
                                  np.asarray(jts.extras["real_next_obs"].global_state))


def test_global_state_matches_over_reset_steps_and_auto_reset():
    overrides = ["env.kwargs.time_limit=5"]
    jenv, _ = jenvs.make(jax_load_config("default_rec_mappo", overrides), add_global_state=True)
    tenv, teval = tenvs.make(load_config("default_rec_mappo", overrides), "cpu",
                             add_global_state=True)
    unwrapped = jenv.unwrapped
    num_agents = unwrapped.num_agents
    assert tenv.num_global_state_features == num_agents * unwrapped.num_obs_features
    assert tenv.num_obs_features == unwrapped.num_obs_features + num_agents
    assert teval.num_global_state_features == tenv.num_global_state_features

    keys = jax.random.split(jax.random.PRNGKey(0), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    draws = jax.vmap(lambda k: _reset_draws(k, unwrapped))(inner)
    tstate, tts = tenv.reset(_reset_noise(draws))
    _assert_timesteps_equal(tts, jts)
    _assert_global_state(tts, jts, num_agents)

    tstate = _to_torch_state(jstate)
    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: _step_draws(k, unwrapped)))
    rng = np.random.default_rng(0)
    resets = 0
    for _ in range(12):
        actions = rng.integers(0, 5, (NUM_ENVS, num_agents)).astype(np.int32)
        gumbels, reset_draws = draws_fn(jstate.env_state.key)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        noise = (torch.tensor(np.asarray(gumbels)), _reset_noise(reset_draws))
        tstate, tts = tenv.step(tstate, torch.tensor(actions), noise)
        _assert_timesteps_equal(tts, jts)
        _assert_global_state(tts, jts, num_agents)
        resets += int(np.sum(np.asarray(jts.last())))
    assert resets >= 2 * NUM_ENVS, "no auto-reset happened"


def test_global_state_wrapper_honours_the_envs_own():
    """An env with `get_global_state(obs, state)` supplies the global state and
    its width; RWARE has none and gets the tiled views."""
    class WithOwn(RobotWarehouse):
        num_global_state_features = 3

        def get_global_state(self, obs, state):
            own = state.agent_pos.float().mean(1)  # (E, 2)
            own = torch.cat([own, state.step_count[:, None].float()], dim=-1)
            return own[:, None, :].expand(-1, self.num_agents, -1)

    gen = torch.Generator().manual_seed(0)
    env = GlobalStateWrapper(WithOwn(time_limit=5))
    state, ts = env.reset(env.reset_noise(3, gen))
    assert env.num_global_state_features == 3
    assert ts.observation.global_state.shape == (3, 2, 3)
    state, ts = env.step(state, torch.ones(3, 2, dtype=torch.int64), env.step_noise(3, gen))
    assert torch.all(ts.observation.global_state[:, :, 2] == 1)

    plain = GlobalStateWrapper(RobotWarehouse(time_limit=5))
    _, ts = plain.reset(plain.reset_noise(3, gen))
    assert plain.num_global_state_features == 2 * plain.num_obs_features
    assert ts.observation.global_state.shape == (3, 2, plain.num_global_state_features)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_one_rec_mappo_update_matches_jax_learner(impl):
    """Through the plain GRU and through `gru_impl=pallas`, which on CPU tensors
    is the plain version of the GRU op."""
    check_one_recurrent_update("contiguous", impl, system="rec_mappo", centralised=True)
