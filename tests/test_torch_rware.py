"""The port's batched RWARE and wrapper chain against `mava_tpu`'s.

A JAX `RwareState` batch is converted to the port's state; both engines then
step with the same actions, and the port is handed the reference's random
draws (the per-agent request Gumbels and the auto-reset uniforms, recomputed
from each env's JAX key). Observations, rewards, discounts, step types,
episode metrics and the terminal observations must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.rware import RwareResetNoise, RwareState
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState, get_final_step_metrics
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 4


def _envs(time_limit):
    overrides = [f"env.kwargs.time_limit={time_limit}"]
    jenv, _ = jenvs.make(jax_load_config("default_rec_ippo", overrides))
    tenv, _ = tenvs.make(load_config("default_rec_ippo", overrides), "cpu")
    return jenv, tenv


def _to_torch_state(jstate) -> RecordEpisodeMetricsState:
    s = jax.device_get(jstate)
    r = s.env_state
    t = lambda x, dt: torch.tensor(np.asarray(x)).to(dt)  # noqa: E731
    rware = RwareState(
        step_count=t(r.step_count, torch.int32),
        agent_pos=t(r.agent_pos, torch.int64),
        agent_dir=t(r.agent_dir, torch.int64),
        agent_carrying=t(r.agent_carrying, torch.int64),
        shelf_pos=t(r.shelf_pos, torch.int64),
        shelf_requested=t(r.shelf_requested, torch.bool),
    )
    return RecordEpisodeMetricsState(
        rware,
        t(s.running_count_episode_return, torch.float32),
        t(s.running_count_episode_length, torch.int32),
        t(s.episode_return, torch.float32),
        t(s.episode_length, torch.int32),
    )


def _reset_draws(key, unwrapped):
    """The draws of `RobotWarehouse.reset(key)` (reference rware.py:229-247)."""
    _, pos_key, dir_key, req_key = jax.random.split(key, 4)
    return (
        jax.random.uniform(pos_key, (unwrapped.height * unwrapped.width,)),
        jax.random.randint(dir_key, (unwrapped.num_agents,), 0, 4),
        jax.random.uniform(req_key, (unwrapped.num_shelves,)),
    )


def _step_draws(key, unwrapped):
    """Per-agent request Gumbels of `step` (`categorical` = argmax(logits +
    gumbel(sub))), then the reset draws of the auto-reset (wrappers.py:163)."""
    gumbels = []
    for _ in range(unwrapped.num_agents):
        key, sub = jax.random.split(key)
        gumbels.append(jax.random.gumbel(sub, (unwrapped.num_shelves,)))
    reset_key, _ = jax.random.split(key)
    return jnp.stack(gumbels), _reset_draws(reset_key, unwrapped)


def _reset_noise(draws) -> RwareResetNoise:
    cells, dirs, req = (np.asarray(x) for x in draws)
    return RwareResetNoise(torch.tensor(cells), torch.tensor(dirs).long(), torch.tensor(req))


def _assert_timesteps_equal(tts, jts):
    tobs, jobs = tts.observation, jts.observation
    np.testing.assert_array_equal(tobs.agents_view.numpy(), np.asarray(jobs.agents_view))
    np.testing.assert_array_equal(tobs.action_mask.numpy(), np.asarray(jobs.action_mask))
    np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
    np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
    np.testing.assert_array_equal(tts.reward.numpy(), np.asarray(jts.reward))
    np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
    for k, v in jts.extras["episode_metrics"].items():
        np.testing.assert_array_equal(tts.extras["episode_metrics"][k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(
        tts.extras["real_next_obs"].agents_view.numpy(),
        np.asarray(jts.extras["real_next_obs"].agents_view),
    )


def _craft_delivery(jstate, unwrapped):
    """Env 0: agent 0 stands above goal (10, 4), facing down, carrying a
    requested shelf; its first FORWARD delivers it."""
    r = jstate.env_state
    shelf = 5
    pos = r.agent_pos.at[0, 0].set(jnp.array([9, 4])).at[0, 1].set(jnp.array([5, 0]))
    requested = r.shelf_requested.at[0].set(
        jnp.zeros(unwrapped.num_shelves, bool).at[shelf].set(True).at[20].set(True)
    )
    r = r.replace(
        agent_pos=pos.astype(r.agent_pos.dtype),
        agent_dir=r.agent_dir.at[0, 0].set(2),
        agent_carrying=r.agent_carrying.at[0, 0].set(shelf).at[0, 1].set(-1),
        shelf_pos=r.shelf_pos.at[0, shelf].set(jnp.array([9, 4], r.shelf_pos.dtype)),
        shelf_requested=requested,
    )
    return jstate.replace(env_state=r)


def test_reset_matches_with_injected_draws():
    jenv, tenv = _envs(time_limit=20)
    keys = jax.random.split(jax.random.PRNGKey(0), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    # RecordEpisodeMetrics.reset splits its key before the inner reset.
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    draws = jax.vmap(lambda k: _reset_draws(k, jenv.unwrapped))(inner)
    tstate, tts = tenv.reset(_reset_noise(draws))
    _assert_timesteps_equal(tts, jts)
    conv = _to_torch_state(jstate)
    for name in RwareState._fields:
        torch.testing.assert_close(getattr(tstate.env_state, name), getattr(conv.env_state, name))


def test_steps_match_through_delivery_and_auto_resets():
    jenv, tenv = _envs(time_limit=6)
    unwrapped = jenv.unwrapped
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), NUM_ENVS))
    jstate = _craft_delivery(jstate, unwrapped)
    tstate = _to_torch_state(jstate)
    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: _step_draws(k, unwrapped)))
    rng = np.random.default_rng(0)
    rewards, resets = 0.0, 0
    for t in range(16):
        actions = rng.integers(0, 5, (NUM_ENVS, unwrapped.num_agents)).astype(np.int32)
        if t == 0:
            actions[0] = [1, 0]  # agent 0 of env 0 delivers
        gumbels, reset_draws = draws_fn(jstate.env_state.key)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        noise = (torch.tensor(np.asarray(gumbels)), _reset_noise(reset_draws))
        tstate, tts = tenv.step(tstate, torch.tensor(actions), noise)
        _assert_timesteps_equal(tts, jts)
        conv = _to_torch_state(jstate)
        for name in RwareState._fields:
            torch.testing.assert_close(getattr(tstate.env_state, name), getattr(conv.env_state, name))
        rewards += float(np.sum(np.asarray(jts.reward)))
        resets += int(np.sum(np.asarray(jts.last())))
    assert rewards > 0, "no delivery happened"
    assert resets >= NUM_ENVS, "no auto-reset happened"


@pytest.mark.parametrize("any_done", [True, False])
def test_final_step_metrics_match(any_done):
    from mava_tpu.envs.wrappers import get_final_step_metrics as jax_final

    rng = np.random.default_rng(5)
    metrics = {
        "episode_return": rng.standard_normal((3, 4)).astype(np.float32),
        "episode_length": rng.integers(1, 9, (3, 4)).astype(np.int32),
        "is_terminal_step": (rng.random((3, 4)) < 0.4) & any_done,
    }
    got, got_done = get_final_step_metrics({k: torch.tensor(v) for k, v in metrics.items()})
    want, want_done = jax_final({k: jnp.asarray(v) for k, v in metrics.items()})
    assert got_done == want_done == any_done
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_unported_env_raises():
    cfg = load_config("default_rec_ippo", ["env=maswimmer"])
    with pytest.raises(ValueError, match="not yet ported"):
        tenvs.make(cfg, "cpu")


@pytest.mark.parametrize("name", ["restart", "transition", "termination", "truncation"])
def test_timestep_constructors_match(name):
    from mava_tpu import types as jtypes
    from mava_tpu_torch import types as ttypes

    rng = np.random.default_rng(4)
    view = rng.standard_normal((3, 2, 5)).astype(np.float32)
    reward = rng.standard_normal((3, 2)).astype(np.float32)
    tobs = ttypes.Observation(torch.tensor(view), torch.ones(3, 2, 5, dtype=torch.bool),
                              torch.zeros(3, 2, dtype=torch.int32))
    args = () if name == "restart" else (torch.tensor(reward),)
    ts = getattr(ttypes, name)(*args, tobs, {}, 2)
    for e in range(3):
        jargs = () if name == "restart" else (jnp.asarray(reward[e]),)
        jts = getattr(jtypes, name)(*jargs, None, {}, 2)
        assert int(ts.step_type[e]) == int(jts.step_type)
        np.testing.assert_array_equal(ts.reward[e].numpy(), np.asarray(jts.reward))
        np.testing.assert_array_equal(ts.discount[e].numpy(), np.asarray(jts.discount))
        assert bool(ts.last()[e]) == bool(jts.last()) and bool(ts.first()[e]) == bool(jts.first())
