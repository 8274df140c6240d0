"""The port's Level-Based Foraging, with its wrapper chain, and ff-MAPPO on it,
against `mava_tpu`'s.

Both engines start from the same state and step with the same actions through
GlobalState -> AgentID -> AutoReset -> RecordEpisodeMetrics (the harness of
`test_torch_grid_envs.py`). The port is handed each reset's draws recomputed
from the env's JAX key: the cells' uniforms (whose top n_agents + n_food,
in `jax.lax.top_k`'s order, place everything), the agent levels and, where
`force_coop` is off, the food levels under each env's own bound. Everything
the timestep carries and the env state must agree: ints and bools exactly,
floats to rtol = atol = 1e-6. One ff-MAPPO update on LBF from the same
parameters, state and draws equals the JAX learner's to rtol = atol = 1e-5.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu.envs.lbf import LevelBasedForaging as JLbf
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.connector import top_cells
from mava_tpu_torch.envs.lbf import LbfResetNoise, LbfState, LevelBasedForaging
from mava_tpu_torch.systems.ppo import ff_ippo, ff_mappo
from mava_tpu_torch.utils.config import load_config
from test_torch_ff_ippo import TINY
from test_torch_ff_ippo import _jax_update as jax_ff_update
from test_torch_grid_envs import (
    FLOAT_TOL,
    NUM_ENVS,
    Twin,
    _keep_key_step,
    _set_env0,
    _t,
    run_twins,
    to_port_state,
    to_torch_state,
)
from test_torch_rec_ippo import (
    _assert_no_episode_ended,
    _assert_update_matches,
    _prepare,
    _start_from_jax,
)

torch.set_num_threads(1)


def _lbf_reset(key, env):
    """The draws of `LevelBasedForaging.reset(key)` (reference lbf.py:151-178)."""
    _, pos_key, alevel_key, flevel_key = jax.random.split(key, 4)
    cells = jax.random.uniform(pos_key, (env.grid_size**2,))
    agent_level = jax.random.randint(alevel_key, (env.num_agents,), 1, env.max_agent_level + 1)
    top3 = jnp.sort(agent_level)[-3:] if env.num_agents >= 3 else agent_level
    bound = jnp.maximum(jnp.sum(top3), 1)
    food_level = jax.random.randint(flevel_key, (env.num_food,), 1, bound + 1)
    return cells, agent_level, food_level


LBF = Twin(LbfState, _lbf_reset, lambda d: LbfResetNoise(*map(_t, d)),
           _keep_key_step(_lbf_reset), lambda d: None)


def _coop_load_ready(jstate, env):
    """Env 0: two level-1 agents on either side of a level-2 food, the other
    foods far away; both load at once and eat it."""
    foods = [[3, 4]] + [[7, 7 - i] for i in range(env.num_food - 1)]
    agents = [[3, 3], [3, 5]] + [[0, i] for i in range(env.num_agents - 2)]
    levels = np.ones(env.num_food, np.int32) * 2
    return (_set_env0(jstate, agent_pos=agents, food_pos=foods,
                      agent_level=np.ones(env.num_agents, np.int32), food_level=levels,
                      total_food_level=float(levels.sum())),
            np.array([5, 5] + [0] * (env.num_agents - 2)))


@pytest.mark.parametrize("scenario,time_limit", [
    ("2s-8x8-2p-2f-coop", 10),  # fov 2: entries out of view
    ("8x8-2p-2f-coop", 10),  # the BASELINE.json configuration's env
    ("15x15-4p-3f", 12),  # force_coop off: food levels under each env's bound
])
def test_lbf_rollout_matches_through_auto_resets(scenario, time_limit):
    overrides = ["env=lbf", f"env/scenario={scenario}", f"env.kwargs.time_limit={time_limit}"]
    out = run_twins(overrides, LBF, steps=40, seed=len(scenario), craft=_coop_load_ready)
    assert out["resets"] >= 2 * NUM_ENVS, out
    assert out["reward"] > 0.0, out


def test_out_of_view_entries_are_minus_one():
    """fov 2 on 8x8: at reset some entity is out of some agent's view, and
    the port's observation says -1 for it as the reference's does."""
    env = LevelBasedForaging(grid_size=8, fov=2, num_agents=2, num_food=2, force_coop=True)
    jenv = JLbf(grid_size=8, fov=2, num_agents=2, num_food=2, force_coop=True)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    state, ts = env.reset(LbfResetNoise(*map(_t, jax.vmap(lambda k: _lbf_reset(k, jenv))(keys))))
    np.testing.assert_array_equal(ts.observation.agents_view.numpy(),
                                  np.asarray(jts.observation.agents_view))
    assert (ts.observation.agents_view == -1).any()


def test_top_cells_follow_top_k_on_ties():
    """Descending, the lower index first among equal values, as jax.lax.top_k."""
    u = np.array([[0.5, 0.9, 0.5, 0.1, 0.9, 0.5]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(u[0]), 5)
    assert top_cells(torch.tensor(u), 5)[0].tolist() == np.asarray(want).tolist()


def test_food_levels_follow_each_envs_bound():
    """Without force_coop the port draws every food level in 1..(sum of its
    env's three highest agent levels)."""
    env = LevelBasedForaging(grid_size=15, num_agents=4, num_food=3, max_agent_level=3)
    noise = env.reset_noise(512, torch.Generator().manual_seed(0))
    bound = noise.agent_level.sort(-1).values[:, -3:].sum(-1, keepdim=True)
    assert (noise.food_level >= 1).all() and (noise.food_level <= bound).all()
    assert (noise.food_level == bound).any() and (noise.food_level == 1).any()


def _single(jenv, env, jstate, actions):
    batched = jax.tree.map(lambda x: jnp.asarray(x)[None], jstate)
    js2, jts = jenv.step(jstate, jnp.asarray(actions, jnp.int32))
    ts2, tts = env.step(to_port_state(batched, LbfState), torch.tensor([actions]))
    np.testing.assert_allclose(tts.observation.agents_view[0].numpy(),
                               np.asarray(jts.observation.agents_view), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.observation.action_mask[0].numpy(),
                                  np.asarray(jts.observation.action_mask))
    np.testing.assert_allclose(tts.reward[0].numpy(), np.asarray(jts.reward), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.step_type[0].numpy(), np.asarray(jts.step_type))
    want = to_port_state(jax.tree.map(lambda x: jnp.asarray(x)[None], js2), LbfState)
    for name in LbfState._fields:
        torch.testing.assert_close(getattr(ts2, name), getattr(want, name), msg=name)
    return ts2, tts


def test_lbf_coop_load_eats_and_rewards_twin():
    kw = dict(grid_size=8, fov=8, num_agents=2, num_food=2, force_coop=True, time_limit=20)
    jenv, env = JLbf(**kw), LevelBasedForaging(**kw)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(
        agent_pos=jnp.array([[3, 3], [3, 5]], dtype=jnp.int32),
        food_pos=jnp.array([[3, 4], [7, 7]], dtype=jnp.int32),
        food_eaten=jnp.array([False, True]),
        agent_level=jnp.array([1, 1], dtype=jnp.int32),
        food_level=jnp.array([2, 2], dtype=jnp.int32),
        total_food_level=jnp.float32(4.0),
    )
    state, ts = _single(jenv, env, jstate, [5, 5])
    assert state.food_eaten[0, 0] and ts.last()[0]
    np.testing.assert_allclose(ts.reward[0].numpy(), [0.5, 0.5])
    # One level-1 agent cannot eat a level-2 food.
    state, ts = _single(jenv, env, jstate, [5, 0])
    assert not state.food_eaten[0, 0] and ts.reward.abs().sum() == 0


def test_lbf_individual_rewards_twin():
    """`use_individual_rewards`: each loader gets its own share."""
    kw = dict(grid_size=8, num_agents=2, num_food=1, use_individual_rewards=True)
    jenv, env = JLbf(**kw), LevelBasedForaging(**kw)
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    jstate = jstate.replace(
        agent_pos=jnp.array([[3, 3], [3, 5]], dtype=jnp.int32),
        food_pos=jnp.array([[3, 4]], dtype=jnp.int32),
        agent_level=jnp.array([1, 2], dtype=jnp.int32),
        food_level=jnp.array([3], dtype=jnp.int32),
        total_food_level=jnp.float32(3.0),
    )
    _, ts = _single(jenv, env, jstate, [5, 5])
    np.testing.assert_allclose(ts.reward[0].numpy(), [1 / 3, 2 / 3], rtol=1e-6)


def test_lbf_move_conflict_both_stay_twin():
    kw = dict(grid_size=8, num_agents=2, num_food=1, time_limit=20)
    jenv, env = JLbf(**kw), LevelBasedForaging(**kw)
    jstate, _ = jenv.reset(jax.random.PRNGKey(1))
    jstate = jstate.replace(agent_pos=jnp.array([[2, 2], [2, 4]], dtype=jnp.int32),
                            food_pos=jnp.array([[7, 7]], dtype=jnp.int32))
    state, _ = _single(jenv, env, jstate, [4, 3])
    assert state.agent_pos[0].tolist() == [[2, 2], [2, 4]]


def test_registry_reads_use_individual_rewards():
    cfg = load_config("default_ff_mappo", ["env=lbf", "env.use_individual_rewards=True"])
    env, _ = tenvs.make(cfg, "cpu")
    assert env.use_individual_rewards


def test_one_ff_mappo_update_on_lbf_matches_jax_learner():
    jstate, noise, perms, jout = jax_ff_update("ff_mappo", True, ["env=lbf"])
    _assert_no_episode_ended(jout)
    cfg = _prepare(load_config("default_ff_mappo", TINY + ["env=lbf"]))
    env, _ = tenvs.make(cfg, "cpu", add_global_state=True)
    learn, _, state = ff_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), True,
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
    )
    out = learn(_start_from_jax(state, jstate, lambda js: to_torch_state(js, LbfState)))
    _assert_update_matches(out, jout)


def test_cli_end_to_end(fast_config_overrides, monkeypatch, capsys):
    argv = ["ff_mappo", *fast_config_overrides, "env=lbf", "env.kwargs.time_limit=16",
            "+arch.device=cpu", "logger.use_console=True"]
    monkeypatch.setattr(sys, "argv", argv)
    performance = ff_mappo.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    assert "ff-MAPPO experiment completed." in captured.out
    assert "Episode return mean" in captured.out + captured.err
