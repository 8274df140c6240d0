"""The port's Cleaner, MaConnector and Gigastep, with their wrapper chain,
against `mava_tpu`'s.

Both engines start from the same state (the JAX reset, converted) and step
with the same actions through GlobalState -> AgentID (Gigastep; the grid
envs see their own position) -> AutoReset -> RecordEpisodeMetrics. The port
is handed the reference's random draws, recomputed from each env's JAX key:
MaConnector's reset uniforms, Gigastep's start and waypoint uniforms and the
adversaries' actions of every step; Cleaner draws nothing. Observations,
masks, rewards, discounts, step types, `won_episode`, global states, episode
metrics, terminal observations and env states must agree: exactly for ints
and bools, to rtol = atol = 1e-6 for floats.

The mechanics tests of `tests/test_envs_grid.py` have twins here: the same
crafted state stepped by both engines, the port held to the reference's
expected values and to the JAX step.
"""

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.cleaner import Cleaner, CleanerState
from mava_tpu_torch.envs.connector import ConnectorState, MaConnector
from mava_tpu_torch.envs.gigastep import (
    Gigastep,
    GigastepResetNoise,
    GigastepState,
    GigastepStepNoise,
)
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 3
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


class Twin(NamedTuple):
    """How one env's draws and state cross from the JAX engine to the port.

    `reset_draws(key, env)` and `step_draws(key, env)` recompute, for one env,
    what the JAX `reset(key)` and `step` draw (the latter from the state's key
    before the step, returning (the step's draws, the draws of the auto-reset
    that may follow)); `reset_noise` / `step_noise` turn the batched draws into
    the port's noise."""

    state: type
    reset_draws: Callable
    reset_noise: Callable
    step_draws: Callable
    step_noise: Callable


def to_port_state(jenv_state, kind) -> Any:
    """A batch of JAX env states as the port's `kind`: ints as int64 (the
    step count int32), bools, floats float32."""
    fields = {}
    for name in kind._fields:
        x = torch.tensor(np.asarray(getattr(jenv_state, name)))
        if name == "step_count":
            x = x.to(torch.int32)
        elif not x.is_floating_point() and x.dtype != torch.bool:
            x = x.long()
        fields[name] = x
    return kind(**fields)


def to_torch_state(jstate, kind) -> RecordEpisodeMetricsState:
    s = jax.device_get(jstate)
    t = lambda x, dt: torch.tensor(np.asarray(x)).to(dt)  # noqa: E731
    return RecordEpisodeMetricsState(
        to_port_state(s.env_state, kind),
        t(s.running_count_episode_return, torch.float32),
        t(s.running_count_episode_length, torch.int32),
        t(s.episode_return, torch.float32),
        t(s.episode_length, torch.int32),
    )


def _auto_reset_key(key):
    """The key an auto-reset takes from the state's key (reference wrappers.py:163)."""
    return jax.random.split(key)[0]


def _keep_key_step(reset_draws):
    """`step_draws` of an env whose step draws nothing and keeps its key."""
    return lambda key, env: (None, reset_draws(_auto_reset_key(key), env))


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------------ the twins
def _connector_reset(key, env):
    _, cells_key = jax.random.split(key)
    return jax.random.uniform(cells_key, (env.grid_size**2,))


def _gigastep_reset(key, env):
    _, team_key, adv_key, wp_key = jax.random.split(key, 4)
    return (jax.random.uniform(team_key, (env.num_agents, 2)),
            jax.random.uniform(adv_key, (env.num_adversaries, 2)),
            jax.random.uniform(wp_key, (2,)))


def _gigastep_step(key, env):
    """gigastep.py:149-153 and :193: the adversaries' actions and the uniforms
    of a new waypoint, then the auto-reset from the state's new key."""
    new_key, adv_key, wp_key = jax.random.split(key, 3)
    draws = (jax.random.randint(adv_key, (env.num_adversaries,), 0, 9),
             jax.random.uniform(wp_key, (2,)))
    return draws, _gigastep_reset(_auto_reset_key(new_key), env)


TWINS = {
    "Cleaner": Twin(CleanerState, lambda key, env: jnp.zeros(()),
                    lambda draws: draws.shape[0],
                    _keep_key_step(lambda key, env: jnp.zeros(())), lambda draws: None),
    "MaConnector": Twin(ConnectorState, _connector_reset, _t,
                        _keep_key_step(_connector_reset), lambda draws: None),
    "Gigastep": Twin(GigastepState, _gigastep_reset,
                     lambda d: GigastepResetNoise(*map(_t, d)), _gigastep_step,
                     lambda d: GigastepStepNoise(*map(_t, d))),
}


# ------------------------------------------------------------------ harness
def make_envs(overrides, system="ff_mappo"):
    jenv, _ = jenvs.make(jax_load_config(f"default_{system}", overrides), add_global_state=True)
    tenv, _ = tenvs.make(load_config(f"default_{system}", overrides), "cpu",
                         add_global_state=True)
    return jenv, tenv


def _assert_obs_equal(tobs, jobs):
    np.testing.assert_allclose(tobs.agents_view.numpy(), np.asarray(jobs.agents_view), **FLOAT_TOL)
    np.testing.assert_array_equal(tobs.action_mask.numpy(), np.asarray(jobs.action_mask))
    np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
    np.testing.assert_allclose(tobs.global_state.numpy(), np.asarray(jobs.global_state),
                               **FLOAT_TOL)


def assert_timesteps_equal(tts, jts):
    _assert_obs_equal(tts.observation, jts.observation)
    _assert_obs_equal(tts.extras["real_next_obs"], jts.extras["real_next_obs"])
    np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
    assert ("won_episode" in tts.extras) == ("won_episode" in jts.extras)
    if "won_episode" in jts.extras:
        np.testing.assert_array_equal(tts.extras["won_episode"].numpy(),
                                      np.asarray(jts.extras["won_episode"]))
    for k, v in jts.extras["episode_metrics"].items():
        np.testing.assert_allclose(tts.extras["episode_metrics"][k].numpy(), np.asarray(v),
                                   err_msg=k, **FLOAT_TOL)


def assert_states_equal(tstate, jstate, kind):
    want = to_torch_state(jstate, kind)
    for name in kind._fields:
        torch.testing.assert_close(getattr(tstate.env_state, name),
                                   getattr(want.env_state, name), msg=name, **FLOAT_TOL)
    for got, w in zip(tstate[1:], want[1:]):
        torch.testing.assert_close(got, w, **FLOAT_TOL)


def random_legal_actions(rng, mask):
    e, a, _ = mask.shape
    return np.array([[rng.choice(np.flatnonzero(mask[i, j])) for j in range(a)]
                     for i in range(e)], np.int32)


def run_twins(overrides, twin: Twin, steps, seed, craft: Optional[Callable] = None,
              system="ff_mappo"):
    """Reset both engines from the same keys, optionally craft env 0 (`craft`
    returns the new JAX state and env 0's first actions), then step both
    `steps` times with the same random legal actions. Returns what happened:
    auto-resets, wins and the sum of the rewards."""
    jenv, tenv = make_envs(overrides, system)
    unwrapped = jenv.unwrapped
    keys = jax.random.split(jax.random.PRNGKey(seed), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    # RecordEpisodeMetrics.reset splits its key before the inner reset.
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    draws = jax.vmap(lambda k: twin.reset_draws(k, unwrapped))(inner)
    tstate, tts = tenv.reset(twin.reset_noise(draws))
    _assert_obs_equal(tts.observation, jts.observation)
    assert_states_equal(tstate, jstate, twin.state)

    first = None
    if craft is not None:
        jstate, first = craft(jstate, unwrapped)
        tstate = to_torch_state(jstate, twin.state)
    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: twin.step_draws(k, unwrapped)))
    rng = np.random.default_rng(seed)
    mask = np.asarray(jax.vmap(unwrapped._observe)(jstate.env_state).action_mask)
    out = {"resets": 0, "wins": 0, "reward": 0.0}
    for t in range(steps):
        actions = random_legal_actions(rng, mask)
        if t == 0 and first is not None:
            actions[0] = first
        step_draws, reset_draws = draws_fn(jstate.env_state.key)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        step_noise = None if step_draws is None else twin.step_noise(step_draws)
        tstate, tts = tenv.step(tstate, torch.tensor(actions),
                                (step_noise, twin.reset_noise(reset_draws)))
        assert_timesteps_equal(tts, jts)
        assert_states_equal(tstate, jstate, twin.state)
        mask = np.asarray(jts.observation.action_mask)
        out["resets"] += int(np.asarray(jts.last()).sum())
        out["wins"] += int(np.asarray(jts.extras.get("won_episode", False)).sum())
        out["reward"] += float(np.asarray(jts.reward).sum())
    return out


def _set_env0(jstate, **fields):
    """JAX state with env 0's fields replaced."""
    r = jstate.env_state
    new = {k: getattr(r, k).at[0].set(jnp.asarray(v, getattr(r, k).dtype))
           for k, v in fields.items()}
    return jstate.replace(env_state=r.replace(**new))


# ------------------------------------------------------------------ rollouts
def _cleaner_nearly_clean(jstate, env):
    """Env 0: every tile clean but (0, 1), next to the agents' start: one step
    right wins."""
    dirty = np.zeros((env.num_rows, env.num_cols), bool)
    dirty[0, 1] = True
    return _set_env0(jstate, dirty=dirty), np.full(env.num_agents, 1)


def _connector_one_step_from_winning(jstate, env):
    """Env 0 of con-5x5x3a: each head next to its target; the first actions
    connect all three."""
    return _set_env0(jstate, head_pos=[[0, 0], [4, 4], [2, 2]],
                     target_pos=[[0, 1], [4, 3], [2, 3]]), np.array([2, 4, 2])


def _gigastep_contact(jstate, env):
    """Env 0: an adversary next to agent 0 (a tag) and the waypoint at agent 1
    (a waypoint point)."""
    r = jstate.env_state
    team = np.asarray(r.team_pos[0])
    adv = np.asarray(r.adv_pos[0]).copy()
    adv[0] = team[0] + np.array([0.2, 0.0], np.float32)
    return _set_env0(jstate, adv_pos=adv, waypoint=team[1]), np.zeros(env.num_agents)


@pytest.mark.parametrize("scenario,env_name,time_limit,craft", [
    ("clean-5x5x5a", "Cleaner", 10, _cleaner_nearly_clean),
    ("con-5x5x3a", "MaConnector", 8, _connector_one_step_from_winning),
], ids=["cleaner", "connector"])
def test_grid_env_rollout_matches_through_auto_resets(scenario, env_name, time_limit, craft):
    env = "cleaner" if env_name == "Cleaner" else "connector"
    overrides = [f"env={env}", f"env/scenario={scenario}", f"+env.kwargs.time_limit={time_limit}"]
    out = run_twins(overrides, TWINS[env_name], steps=30, seed=len(scenario), craft=craft)
    assert out["resets"] >= 2 * NUM_ENVS, out
    assert out["wins"] >= 1, out


@pytest.mark.parametrize("scenario", ["hide_and_seek_5_vs_5_fobs", "hide_and_seek_5_vs_5_pobs",
                                      "waypoint_5_vs_5_fobs", "waypoint_5_vs_5_pobs"])
def test_gigastep_rollout_matches_through_auto_resets(scenario):
    overrides = ["env=gigastep", f"env/scenario={scenario}", "+env.kwargs.time_limit=12"]
    out = run_twins(overrides, TWINS["Gigastep"], steps=30, seed=3, craft=_gigastep_contact)
    assert out["resets"] >= 2 * NUM_ENVS, out
    assert out["reward"] >= 1.0, out


def test_grid_envs_give_grid_shapes():
    _, tenv = make_envs(["env=connector", "env/scenario=con-10x10x10a"])
    assert tenv.obs_shape == (10, 10, 5) and tenv.global_state_shape == (10, 10, 3)
    _, tenv = make_envs(["env=cleaner", "env/scenario=clean-10x10x10a"])
    assert tenv.obs_shape == (10, 10, 4) and tenv.global_state_shape == (10, 10, 3)
    jenv, tenv = make_envs(["env=gigastep"])
    # No global state of its own: every agent's view, tiled. It is built
    # before the agent ids are added, as in the reference.
    assert tenv.global_state_shape == (5 * jenv.unwrapped.num_obs_features,)
    assert tenv.num_obs_features == jenv.unwrapped.num_obs_features + 5


def test_agent_ids_are_refused_on_grid_views():
    """As the reference's concatenation would fail on them, the port's
    AgentIDWrapper refuses a grid view."""
    with pytest.raises(ValueError, match="implicit_agent_id"):
        make_envs(["env=cleaner", "env.implicit_agent_id=False"])


# ------------------------------------------------------------------ mechanics twins
def _single(port_env, jenv, jstate, actions, step_noise=None, jkey_step=None):
    """One step of the unwrapped engines from one crafted JAX state."""
    kind = {Cleaner: CleanerState, MaConnector: ConnectorState, Gigastep: GigastepState}[
        type(port_env)]
    batched = jax.tree.map(lambda x: jnp.asarray(x)[None], jstate)
    tstate = to_port_state(batched, kind)
    js2, jts = jenv.step(jstate, jnp.asarray(actions, jnp.int32))
    ts2, tts = port_env.step(tstate, torch.tensor([actions]), step_noise)
    np.testing.assert_allclose(tts.observation.agents_view[0].numpy(),
                               np.asarray(jts.observation.agents_view), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.observation.action_mask[0].numpy(),
                                  np.asarray(jts.observation.action_mask))
    np.testing.assert_allclose(tts.reward[0].numpy(), np.asarray(jts.reward), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.step_type[0].numpy(), np.asarray(jts.step_type))
    np.testing.assert_array_equal(tts.extras["won_episode"][0].numpy(),
                                  np.asarray(jts.extras["won_episode"]))
    want = to_port_state(jax.tree.map(lambda x: jnp.asarray(x)[None], js2), kind)
    for name in kind._fields:
        torch.testing.assert_close(getattr(ts2, name), getattr(want, name), msg=name, **FLOAT_TOL)
    return ts2, tts


def test_cleaner_cleans_and_wins_twin():
    from mava_tpu.envs.cleaner import Cleaner as JCleaner

    jenv, env = JCleaner(3, 3, 2, 50), Cleaner(3, 3, 2, 50)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    state, _ = env.reset(1)
    assert int(state.dirty.sum()) == 7
    state, ts = _single(env, jenv, jstate, [1, 1])
    np.testing.assert_allclose(ts.reward[0].numpy(), [1.0, 1.0])
    assert int(state.dirty.sum()) == 6
    # Every tile clean but one next to agent 0: entering it wins and terminates.
    dirty = np.zeros((3, 3), bool)
    dirty[0, 2] = True
    jstate = jstate.replace(dirty=jnp.asarray(dirty),
                            agent_pos=jnp.array([[0, 1], [1, 0]], jnp.int32))
    state, ts = _single(env, jenv, jstate, [1, 0])
    assert bool(ts.extras["won_episode"][0]) and bool(ts.last()[0])
    assert ts.discount[0].tolist() == [0.0, 0.0]


def test_cleaner_wall_masked_twin():
    from mava_tpu.envs.cleaner import Cleaner as JCleaner

    jenv, env = JCleaner(3, 3, 1, 50), Cleaner(3, 3, 1, 50)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(agent_pos=jnp.array([[0, 1]], dtype=jnp.int32))
    state, _ = env.reset(1)
    mask = env._observe(state._replace(agent_pos=torch.tensor([[[0, 1]]])))[1][0, 0]
    assert not mask[2] and not mask[0] and mask[1] and mask[3]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jenv._observe(jstate).action_mask[0]))
    # Walking into the pillar anyway leaves the agent where it is.
    state, _ = _single(env, jenv, jstate, [2])
    assert state.agent_pos[0, 0].tolist() == [0, 1]


def test_connector_connect_and_win_twin():
    from mava_tpu.envs.connector import MaConnector as JConnector

    jenv, env = JConnector(5, 2, 25), MaConnector(5, 2, 25)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(
        head_pos=jnp.array([[0, 0], [4, 4]], dtype=jnp.int32),
        target_pos=jnp.array([[0, 1], [4, 3]], dtype=jnp.int32),
    )
    state, ts = _single(env, jenv, jstate, [2, 4])
    assert state.connected[0].all() and ts.extras["won_episode"][0] and ts.last()[0]
    np.testing.assert_allclose(ts.reward[0].numpy(), [2.0, 2.0])
    assert state.paths[0, 0, 0] and state.paths[0, 4, 4]
    # A connected agent may only noop.
    assert ts.observation.action_mask[0].tolist() == [[True] + [False] * 4] * 2


def test_connector_blocked_by_path_and_clash_twin():
    from mava_tpu.envs.connector import MaConnector as JConnector

    jenv, env = JConnector(5, 2, 25), MaConnector(5, 2, 25)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(
        head_pos=jnp.array([[2, 2], [0, 0]], dtype=jnp.int32),
        target_pos=jnp.array([[4, 4], [0, 4]], dtype=jnp.int32),
        paths=jnp.zeros((5, 5), dtype=jnp.bool_).at[2, 3].set(True),
    )
    state, _ = _single(env, jenv, jstate, [2, 0])
    assert state.head_pos[0, 0].tolist() == [2, 2]  # right into the path: stays
    # Both heads into (1, 1): both stay.
    jstate = jstate.replace(head_pos=jnp.array([[1, 2], [1, 0]], dtype=jnp.int32))
    state, _ = _single(env, jenv, jstate, [4, 2])
    assert state.head_pos[0].tolist() == [[1, 2], [1, 0]]


def test_gigastep_tagging_twin():
    from mava_tpu.envs.gigastep import Gigastep as JGigastep

    jenv = JGigastep("hide_and_seek", 2, 2, time_limit=50)
    env = Gigastep("hide_and_seek", 2, 2, time_limit=50)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(team_pos=jnp.array([[5.0, 5.0], [1.0, 1.0]]),
                            adv_pos=jnp.array([[5.2, 5.0], [9.0, 9.0]]))
    draws, _ = _gigastep_step(jstate.key, jenv)
    noise = GigastepStepNoise(*(_t(x)[None] for x in draws))
    state, ts = _single(env, jenv, jstate, [0, 0], noise)
    assert not state.adv_active[0, 0] and ts.reward[0, 0].item() == 1.0
    assert ts.extras["won_episode"][0]


def test_gigastep_waypoint_scoring_twin():
    from mava_tpu.envs.gigastep import Gigastep as JGigastep

    jenv = JGigastep("waypoint", 1, 1, time_limit=50)
    env = Gigastep("waypoint", 1, 1, time_limit=50)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate = jstate.replace(team_pos=jnp.array([[5.0, 5.0]]), adv_pos=jnp.array([[0.0, 0.0]]),
                            waypoint=jnp.array([5.1, 5.0]))
    draws, _ = _gigastep_step(jstate.key, jenv)
    noise = GigastepStepNoise(*(_t(x)[None] for x in draws))
    state, ts = _single(env, jenv, jstate, [0], noise)
    assert ts.reward[0, 0].item() == 1.0 and state.team_score[0].item() == 1.0
    assert not np.allclose(state.waypoint[0].numpy(), [5.1, 5.0])  # a new waypoint


def test_noise_draws_have_the_engines_shapes():
    gen = torch.Generator().manual_seed(0)
    giga = Gigastep(num_agents=3, num_adversaries=4)
    noise = giga.step_noise(2, gen)
    assert noise.adv_action.shape == (2, 4) and int(noise.adv_action.max()) < 9
    state, ts = giga.reset(giga.reset_noise(2, gen))
    assert (state.team_pos < 5).all() and (state.adv_pos >= 5).all()
    con = MaConnector(5, 3)
    state, _ = con.reset(con.reset_noise(4, gen))
    cells = torch.cat([state.head_pos, state.target_pos], 1)
    flat = cells[..., 0] * 5 + cells[..., 1]
    assert all(len(set(row.tolist())) == 6 for row in flat)
    cleaner = Cleaner(5, 5, 2)
    assert cleaner.step_noise(2, gen) is None and cleaner.reset_noise(2, gen) == 2
