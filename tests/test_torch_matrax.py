"""The port's batched Matrax against `mava_tpu`'s, exactly: reset and a full
episode through the wrapper chain (with an auto-reset), the catalog's payoffs,
and the factory's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.envs import matrax_catalog as jcatalog
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs import matrax_catalog as tcatalog
from mava_tpu_torch.envs.matrax import Matrax
from mava_tpu_torch.types import StepType
from mava_tpu_torch.utils.config import load_config
from test_torch_rware import _assert_timesteps_equal

torch.set_num_threads(1)
NUM_ENVS, TIME_LIMIT = 3, 4
GAMES = {
    "climbing": ["env.scenario.task_name=Climbing-stateless-v0"],
    "penalty-25": ["env.scenario.task_name=Penalty-25-stateless-v0"],
    "conflict-41": ["env.scenario.task_name=Conflict-41-stateless-v0"],
    "noconflict-19-stateful": ["env.scenario.task_name=NoConflict-19-stateful-v0"],
    "climbing-stateful": ["env.scenario.task_name=Climbing-stateful-v0"],
    "matrax-pd": ["env/scenario=matrax-pd"],
}


@pytest.mark.parametrize("game", sorted(GAMES))
def test_reset_and_episode_match(game):
    overrides = ["env=matrax", f"env.kwargs.time_limit={TIME_LIMIT}"] + GAMES[game]
    jenv, _ = jenvs.make(jax_load_config("default_ff_ippo", overrides))
    tenv, _ = tenvs.make(load_config("default_ff_ippo", overrides), "cpu")
    assert tenv.num_agents == jenv.num_agents == 2
    assert tenv.action_dim == jenv.action_dim and tenv.time_limit == jenv.time_limit
    assert tenv.num_obs_features == jenv.observation_spec().agents_view.shape[-1]

    jstate, jts = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), NUM_ENVS))
    tstate, tts = tenv.reset(tenv.reset_noise(NUM_ENVS, None))
    _assert_timesteps_equal(tts, jts)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    for _ in range(2 * TIME_LIMIT + 1):  # over two auto-resets
        actions = rng.integers(0, jenv.action_dim, (NUM_ENVS, 2)).astype(np.int32)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        tstate, tts = tenv.step(tstate, torch.tensor(actions), tenv.step_noise(NUM_ENVS, None))
        _assert_timesteps_equal(tts, jts)
        np.testing.assert_array_equal(tstate.env_state.step_count.numpy(),
                                      np.asarray(jstate.env_state.step_count))
        np.testing.assert_array_equal(tstate.env_state.last_actions.numpy(),
                                      np.asarray(jstate.env_state.last_actions))


@pytest.mark.parametrize("stateful", [False, True])
def test_raw_game_rules(stateful):
    """reward = payoff[agent, a0, a1]; the view is a zero column (stateless) or
    the tiled last joint action; the mask is all ones; running out of time is a
    truncation (LAST, discount 1)."""
    env = Matrax(f"Climbing-{'stateful' if stateful else 'stateless'}-v0", time_limit=2)
    state, ts = env.reset(env.reset_noise(2, None))
    assert ts.observation.agents_view.shape == (2, 2, 2 if stateful else 1)
    assert not ts.observation.agents_view.any() and ts.observation.action_mask.all()
    assert ts.observation.action_mask.shape == (2, 2, 3)
    actions = torch.tensor([[0, 1], [2, 2]])
    state, ts = env.step(state, actions, env.step_noise(2, None))
    assert ts.reward.tolist() == [[-30.0, -30.0], [5.0, 5.0]]
    assert ts.step_type.tolist() == [int(StepType.MID)] * 2
    if stateful:
        assert ts.observation.agents_view.tolist() == [[[0.0, 1.0]] * 2, [[2.0, 2.0]] * 2]
    else:
        assert not ts.observation.agents_view.any()
    state, ts = env.step(state, actions, None)
    assert ts.step_type.tolist() == [int(StepType.LAST)] * 2
    assert ts.discount.tolist() == [[1.0, 1.0]] * 2
    assert ts.observation.step_count.tolist() == [[2, 2]] * 2


def test_asymmetric_payoff_indexes_agent_then_both_actions():
    payoff = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    env = Matrax("Custom-stateless-v0", time_limit=3, payoff=payoff.tolist())
    state, _ = env.reset(4)
    actions = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]])
    _, ts = env.step(state, actions)
    want = [[payoff[0, a, b], payoff[1, a, b]] for a, b in actions.tolist()]
    assert ts.reward.tolist() == want


@pytest.mark.parametrize("family,count", [("NoConflict", 21), ("Conflict", 57)])
def test_catalog_payoffs_match(family, count):
    for game_id in range(count):
        got = tcatalog.catalog_payoff(family, game_id)
        np.testing.assert_array_equal(got, jcatalog.catalog_payoff(family, game_id))
        assert tcatalog.canonical_id(got[0], got[1]) == (family, game_id)
    with pytest.raises(ValueError, match="id must be in"):
        tcatalog.catalog_payoff(family, count)


def test_catalog_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="family"):
        tcatalog.catalog_payoff("Mixed", 0)
    with pytest.raises(ValueError, match="ordinal"):
        tcatalog.canonical_id([[1, 2], [3, 3]], [[1, 2], [3, 4]])


def test_pinned_task_name_must_not_contradict_the_scenario():
    overrides = ["env=matrax", "env/scenario=matrax-pd",
                 "env.scenario.task_name=Climbing-stateless-v0"]
    with pytest.raises(ValueError, match="Scenario pins task_config.task_name"):
        tenvs.make(load_config("default_ff_ippo", overrides), "cpu")
    with pytest.raises(ValueError, match="Scenario pins task_config.task_name"):
        jenvs.make(jax_load_config("default_ff_ippo", overrides))


@pytest.mark.parametrize("kwargs,match", [
    (dict(task_name="Custom-stateless-v0"), "needs a `payoff` kwarg"),
    (dict(task_name="Custom-stateless-v0", payoff=[[1.0, 2.0], [3.0, 4.0]]), r"must be \(2, n_actions"),
    (dict(task_name="Custom-stateful-v0", payoff=np.zeros((3, 2, 2)).tolist()), r"must be \(2, n_actions"),
    (dict(task_name="Chicken-v0"), "Unknown Matrax task"),
])
def test_bad_tasks_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        Matrax(**kwargs)


def test_unported_env_error_lists_matrax():
    ported = (r"ported: \['Cleaner', 'Gigastep', 'LevelBasedForaging', 'MaConnector', "
              r"'MaReacher', 'MaSwarm', 'Matrax', 'RobotWarehouse', 'Smax'\]")
    with pytest.raises(ValueError, match=ported):
        tenvs.make(load_config("default_ff_ippo", ["env=maswimmer"]), "cpu")
