"""The port's batched SMAX and its wrapper chain against `mava_tpu`'s.

Both engines start from the same state (the JAX reset, converted) and step with
the same actions through GlobalState -> AgentID -> AutoReset ->
RecordEpisodeMetrics; the port is handed the reference's random draws, recomputed
from each env's JAX key: the enemy's uniforms of `attack_mode=random` and the
start positions (and smacv2 unit types) of every auto-reset. Observations,
masks, rewards, discounts, step types, `won_episode`, the global state, the
episode metrics and the terminal observations must agree: exactly for ints and
bools, to rtol = atol = 1e-6 for floats. (Inside the jitted reference step the
normals of an auto-reset are fused with what follows them, and a start
position can land one ulp away from the standalone draw: 2e-6 at x = 16.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.envs.smax import _SMACV2_POOL
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.smax import SCENARIOS, Smax, SmaxResetNoise, SmaxState
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 3
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _overrides(scenario, time_limit, attack_mode="closest"):
    return ["env=smax", f"env/scenario={scenario}", f"+env.kwargs.time_limit={time_limit}",
            f"env.kwargs.attack_mode={attack_mode}"]


def make_envs(overrides):
    jenv, _ = jenvs.make(jax_load_config("default_rec_mappo", overrides), add_global_state=True)
    tenv, _ = tenvs.make(load_config("default_rec_mappo", overrides), "cpu",
                         add_global_state=True)
    return jenv, tenv


def to_torch_state(jstate) -> RecordEpisodeMetricsState:
    """A JAX `RecordEpisodeMetricsState` over a `SmaxState` batch as the port's."""
    s = jax.device_get(jstate)
    r = s.env_state
    t = lambda x, dt: torch.tensor(np.asarray(x)).to(dt)  # noqa: E731
    smax = SmaxState(
        step_count=t(r.step_count, torch.int32),
        unit_pos=t(r.unit_pos, torch.float32),
        unit_hp=t(r.unit_hp, torch.float32),
        unit_types=t(r.unit_types, torch.int64),
        max_reward=t(r.max_reward, torch.float32),
    )
    return RecordEpisodeMetricsState(
        smax,
        t(s.running_count_episode_return, torch.float32),
        t(s.running_count_episode_length, torch.int32),
        t(s.episode_return, torch.float32),
        t(s.episode_length, torch.int32),
    )


def _reset_draws(key, unwrapped):
    """The draws of `Smax.reset(key)` (reference smax.py:158-179): position
    normals and, for smacv2, the pool indices of `jax.random.choice`."""
    _, pos_key, type_key = jax.random.split(key, 3)
    position = jax.random.normal(pos_key, (unwrapped.num_units, 2))
    pool = jnp.asarray(_SMACV2_POOL)
    types = jax.random.choice(type_key, pool, shape=(unwrapped.num_units,))
    return position, jnp.searchsorted(pool, types)


def _step_draws(key, unwrapped):
    """The enemy's uniforms of `step` (smax.py:324, :299), then the draws of the
    auto-reset that follows it (wrappers.py:163)."""
    new_key, enemy_key = jax.random.split(key)
    uniforms = jax.random.uniform(enemy_key, (unwrapped.num_enemies, unwrapped.num_agents))
    reset_key, _ = jax.random.split(new_key)
    return uniforms, _reset_draws(reset_key, unwrapped)


def reset_noise(draws, smacv2: bool) -> SmaxResetNoise:
    position, pool_index = (torch.tensor(np.asarray(x)) for x in draws)
    return SmaxResetNoise(position, pool_index.long() if smacv2 else None)


def _assert_obs_equal(tobs, jobs):
    np.testing.assert_allclose(tobs.agents_view.numpy(), np.asarray(jobs.agents_view), **FLOAT_TOL)
    np.testing.assert_array_equal(tobs.action_mask.numpy(), np.asarray(jobs.action_mask))
    np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
    np.testing.assert_allclose(tobs.global_state.numpy(), np.asarray(jobs.global_state), **FLOAT_TOL)


def assert_timesteps_equal(tts, jts):
    _assert_obs_equal(tts.observation, jts.observation)
    _assert_obs_equal(tts.extras["real_next_obs"], jts.extras["real_next_obs"])
    np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **FLOAT_TOL)
    np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
    np.testing.assert_array_equal(tts.extras["won_episode"].numpy(),
                                  np.asarray(jts.extras["won_episode"]))
    for k, v in jts.extras["episode_metrics"].items():
        np.testing.assert_allclose(tts.extras["episode_metrics"][k].numpy(), np.asarray(v),
                                   err_msg=k, **FLOAT_TOL)


def _assert_states_equal(tstate, jstate):
    conv = to_torch_state(jstate)
    for name in SmaxState._fields:
        torch.testing.assert_close(getattr(tstate.env_state, name), getattr(conv.env_state, name),
                                   msg=name, **FLOAT_TOL)


def _aggressive_actions(rng, mask):
    """Each agent attacks a legal enemy where it can (so units die), else takes
    a random legal action."""
    e, a, n = mask.shape
    actions = np.zeros((e, a), np.int32)
    for i in range(e):
        for j in range(a):
            legal = np.flatnonzero(mask[i, j])
            attacks = legal[legal >= 5]
            actions[i, j] = rng.choice(attacks if len(attacks) and rng.random() < 0.8 else legal)
    return actions


def _weaken_enemies(jstate, unwrapped):
    """Env 0: every enemy has 5 hp, so the allies' first volleys in range win."""
    r = jstate.env_state
    hp = r.unit_hp.at[0, unwrapped.num_agents:].set(5.0)
    return jstate.replace(env_state=r.replace(unit_hp=hp))


@pytest.mark.parametrize("scenario,attack_mode,time_limit", [
    ("2s3z", "closest", 12),
    ("3s5z", "random", 12),
    ("3s_vs_5z", "closest", 14),
    ("smacv2_5_units", "random", 12),
])
def test_reset_and_steps_match_through_auto_resets(scenario, attack_mode, time_limit):
    jenv, tenv = make_envs(_overrides(scenario, time_limit, attack_mode))
    unwrapped = jenv.unwrapped
    smacv2 = unwrapped.is_smacv2
    assert tenv.num_obs_features == unwrapped.num_obs_features + unwrapped.num_agents
    assert tenv.num_global_state_features == unwrapped.global_state_features
    assert tenv.action_dim == unwrapped.action_dim and tenv.time_limit == unwrapped.time_limit

    keys = jax.random.split(jax.random.PRNGKey(7), NUM_ENVS)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    # RecordEpisodeMetrics.reset splits its key before the inner reset.
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    draws = jax.vmap(lambda k: _reset_draws(k, unwrapped))(inner)
    tstate, tts = tenv.reset(reset_noise(draws, smacv2))
    _assert_obs_equal(tts.observation, jts.observation)
    np.testing.assert_array_equal(tts.extras["won_episode"].numpy(),
                                  np.asarray(jts.extras["won_episode"]))
    _assert_states_equal(tstate, jstate)

    if scenario == "3s_vs_5z":
        jstate = _weaken_enemies(jstate, unwrapped)
    tstate = to_torch_state(jstate)
    jstep = jax.jit(jax.vmap(jenv.step))
    draws_fn = jax.jit(jax.vmap(lambda k: _step_draws(k, unwrapped)))
    rng = np.random.default_rng(len(scenario) + time_limit)
    mask = np.asarray(jts.observation.action_mask)
    resets = wins = kills = 0
    for _ in range(40):
        actions = _aggressive_actions(rng, mask)
        uniforms, reset_draws = draws_fn(jstate.env_state.key)
        hp_before = np.asarray(jstate.env_state.unit_hp)
        jstate, jts = jstep(jstate, jnp.asarray(actions))
        step_noise = torch.tensor(np.asarray(uniforms)) if attack_mode == "random" else None
        tstate, tts = tenv.step(tstate, torch.tensor(actions),
                                (step_noise, reset_noise(reset_draws, smacv2)))
        assert_timesteps_equal(tts, jts)
        _assert_states_equal(tstate, jstate)
        mask = np.asarray(jts.observation.action_mask)
        last = np.asarray(jts.last())
        resets += int(last.sum())
        wins += int(np.asarray(jts.extras["won_episode"]).sum())
        kills += int(((hp_before > 0) & (np.asarray(jstate.env_state.unit_hp) <= 0) & ~last[:, None]).sum())
    assert resets >= 2 * NUM_ENVS, f"only {resets} auto-resets"
    if scenario == "3s_vs_5z":
        assert wins >= 1, "no episode was won"
    assert kills + wins >= 1, "no unit died"


def test_every_scenario_builds_with_the_references_sizes():
    from mava_tpu.envs.smax import Smax as JSmax

    assert set(SCENARIOS) == {
        "2s3z", "3s5z", "5m_vs_6m", "10m_vs_11m", "27m_vs_30m", "3s5z_vs_3s6z", "3s_vs_5z",
        "6h_vs_8z", "smacv2_5_units", "smacv2_10_units", "smacv2_20_units"}
    gen = torch.Generator().manual_seed(0)
    for scenario in SCENARIOS:
        env, ref = Smax(scenario), JSmax(scenario)
        assert (env.num_agents, env.num_enemies, env.action_dim, env.time_limit,
                env.num_obs_features, env.num_global_state_features) == (
            ref.num_agents, ref.num_enemies, ref.action_dim, ref.time_limit,
            ref.num_obs_features, ref.global_state_features)
        state, ts = env.reset(env.reset_noise(2, gen))
        assert ts.observation.agents_view.shape == (2, env.num_agents, env.num_obs_features)
        assert ts.observation.action_mask.shape == (2, env.num_agents, env.action_dim)
        assert env.get_global_state(ts.observation, state).shape == (
            2, env.num_agents, env.num_global_state_features)
    with pytest.raises(ValueError, match="Unknown SMAX scenario"):
        Smax("4s4z")


def test_factory_takes_the_scenario_and_env_kwargs():
    cfg = load_config("default_rec_ippo", ["env=smax", "env/scenario=3s5z",
                                           "env.kwargs.attack_mode=random"])
    train_env, eval_env = tenvs.make(cfg, "cpu")
    for env in (train_env, eval_env):
        assert env.scenario == "3s5z"
        assert (env.num_agents, env.action_dim, env.attack_mode) == (8, 13, "random")
    assert train_env.num_obs_features == 175 + 8
