"""rec-IPPO of the port on SMAX 3s5z against `mava_tpu`'s over several
updates in which episodes end: `learner_fn` runs three updates of a rollout
longer than the episode, so envs auto-reset inside each rollout and the carried
state (policy and critic hidden states, `dones`, env state, timestep) passes
from one update to the next.

Every draw is the reference's, re-derived from its keys: the rollout's Gumbel
noise and the epoch permutations from the learner key (rec_ippo.py :138-148,
:341-349, one split per minibatch after them), and the start positions of every
auto-reset from each env's SMAX key (smax.py :158-179, :323; wrappers.py :163).
Losses, parameters, hidden states, `dones`, env state and the episode metrics
of every step must agree: ints and bools exactly, floats to rtol = atol = 1e-5.

The evaluator test runs whole recurrent evaluations of SMAX 2s3z, episodes to
their end, with the JAX evaluator's reset positions and Gumbel draws handed to
the port's, from the same converted actor parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.envs.wrappers import get_final_step_metrics as jax_final_step_metrics
from mava_tpu.evaluator import get_eval_fn as jax_get_eval_fn
from mava_tpu.evaluator import make_rec_eval_act_fn as jax_rec_eval_act_fn
from mava_tpu.networks import ScannedRNN as JaxScannedRNN
from mava_tpu.parallel import make_mesh
from mava_tpu.systems.ppo import rec_ippo as jrec_ippo
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import distributions
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import get_eval_fn, make_rec_eval_act_fn
from mava_tpu_torch.networks import ScannedRNN
from mava_tpu_torch.systems.ppo import rec_ippo
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_rec_ippo import _assert_update_matches, _start_from_jax
from test_torch_smax import _reset_draws, reset_noise, to_torch_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
UPDATES = 3
SMALL = [
    "env=smax",
    "env/scenario=3s5z",
    "+env.kwargs.time_limit=7",  # episodes of at most 7 steps in a rollout of 16
    "arch.num_envs=3",
    "system.rollout_length=16",
    "system.recurrent_chunk_size=8",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    f"system.num_updates={UPDATES}",
    "network.hidden_state_dim=16",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.actor_network.post_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.post_torso.layer_sizes=[16]",
    "logger.use_console=False",
]


def _config(load, overrides=SMALL):
    cfg = load("default_rec_ippo", list(overrides))
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = UPDATES
    return cfg


def learner_draws(key, cfg, num_agents, action_dim, updates):
    """The Gumbel noise and epoch permutations of `updates` JAX updates from
    the learner key: per update a sample split, a shuffle split, then one
    entropy split per minibatch."""
    sys_cfg = cfg.system
    num_sequences = cfg.arch.num_envs * sys_cfg.rollout_length // sys_cfg.recurrent_chunk_size
    noises, perms = [], []
    for _ in range(updates):
        key, sample_key = jax.random.split(key)
        noises.append(jax.random.gumbel(
            sample_key, (sys_cfg.rollout_length, cfg.arch.num_envs, num_agents, action_dim)))
        key, shuffle_key = jax.random.split(key)
        perms.append(jnp.argsort(jax.random.bits(
            shuffle_key, (sys_cfg.ppo_epochs, num_sequences), dtype=jnp.uint32), axis=1))
        for _ in range(sys_cfg.ppo_epochs * sys_cfg.num_minibatches):
            key, _ = jax.random.split(key)
    return torch.tensor(np.stack(noises)), torch.tensor(np.stack(perms))


def auto_reset_draws(smax_keys, terminal, unwrapped):
    """What the port's `AutoResetWrapper.step_noise` draws at each step of each
    update, from the JAX env keys: every step splits each env's SMAX key
    (smax.py :323); where the episode ends the auto-reset resets from the first
    half of the new key (wrappers.py :163), whose reset keeps the first of its
    three splits (smax.py :159). `terminal` is (updates, T, E)."""
    draws_fn = jax.jit(jax.vmap(lambda k: _reset_draws(jax.random.split(k)[0], unwrapped)))
    split = jax.jit(jax.vmap(lambda k: jax.random.split(k)[0]))
    after_reset = jax.jit(jax.vmap(lambda k: jax.random.split(jax.random.split(k)[0], 3)[0]))
    key, out = smax_keys, []
    for done_u in np.asarray(terminal):
        steps = []
        for done in done_u:
            new_key = split(key)
            steps.append((None, reset_noise(draws_fn(new_key), unwrapped.is_smacv2)))
            key = jnp.where(jnp.asarray(done)[:, None], after_reset(new_key), new_key)
        out.append(steps)
    return out


def _assert_episode_metrics_equal(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    logged, ended = get_final_step_metrics(dict(got))
    jlogged, jended = jax_final_step_metrics(dict(want))
    assert ended and jended
    for k, v in jlogged.items():
        np.testing.assert_allclose(logged[k], np.asarray(v), err_msg=k, **TOL)


def test_three_updates_with_episode_ends_match_jax_learner():
    jcfg = _config(jax_load_config)
    jenv, _ = jenvs.make(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    jlearn, _, jstate = jrec_ippo.learner_setup(
        jenv, tuple(keys), jcfg, make_mesh(jax.devices()[:1]))
    jstate = jax.device_get(jstate)
    jout = jax.device_get(jlearn(jstate))
    terminal = np.asarray(jout.episode_metrics["is_terminal_step"])
    assert terminal.shape == (UPDATES, 16, 3)
    assert terminal.any(axis=(1, 2)).all(), "an update without an episode end"

    noise, perms = learner_draws(jstate.key[0], jcfg, jenv.num_agents, jenv.action_dim, UPDATES)
    env_noise = auto_reset_draws(jstate.env_state.env_state.key, terminal, jenv.unwrapped)

    cfg = _config(load_config)
    env, _ = tenvs.make(cfg, "cpu")
    learn, _, state = rec_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
        noise=noise, permutations=perms, env_noise=env_noise,
    )
    out = learn(_start_from_jax(state, jstate, to_torch_state))

    _assert_update_matches(out, jout)  # losses of every update, final parameters
    _assert_episode_metrics_equal(out.episode_metrics, jout.episode_metrics)
    got, want = out.learner_state, jout.learner_state
    for g, w in zip(got.hstates, want.hstates):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got.dones.numpy(), np.asarray(want.dones))
    conv = to_torch_state(want.env_state)
    for name, value in conv.env_state._asdict().items():
        torch.testing.assert_close(getattr(got.env_state.env_state, name), value, msg=name,
                                   rtol=1e-5, atol=1e-5)
    for name in ("running_count_episode_return", "running_count_episode_length",
                 "episode_return", "episode_length"):
        torch.testing.assert_close(getattr(got.env_state, name), getattr(conv, name), msg=name,
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.timestep.observation.agents_view.numpy(),
                               np.asarray(want.timestep.observation.agents_view), **TOL)
    np.testing.assert_array_equal(got.timestep.observation.action_mask.numpy(),
                                  np.asarray(want.timestep.observation.action_mask))


EVAL = [
    "env=smax",
    "env/scenario=2s3z",
    "+env.kwargs.time_limit=30",
    "arch.num_envs=4",
    "arch.num_eval_episodes=8",
    "network.hidden_state_dim=16",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.actor_network.post_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.post_torso.layer_sizes=[16]",
    "logger.use_console=False",
]


def _jax_eval_draws(key, env, n_envs, loops, time_limit):
    """The reset positions and the Gumbel noise of the JAX evaluator's episodes
    (evaluator.py :79-103 on one shard; RecordEpisodeMetrics.reset splits its
    key before the inner reset). An episode hands the next one its key from
    before its steps' splits."""
    unwrapped = env.unwrapped
    key = jax.random.split(key, 1)[0]
    resets, gumbels = [], []
    for _ in range(loops):
        key, reset_key = jax.random.split(key)
        inner = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(reset_key, n_envs))
        resets.append(reset_noise(jax.vmap(lambda k: _reset_draws(k, unwrapped))(inner), False))
        step_key = key
        for _ in range(time_limit):
            step_key, act_key = jax.random.split(step_key)
            gumbels.append(torch.tensor(np.asarray(jax.random.gumbel(
                act_key, (1, n_envs, env.num_agents, env.action_dim)))))
    return resets, gumbels


def test_recurrent_evaluation_with_episode_ends_matches_jax_evaluator(monkeypatch):
    jcfg = _config(jax_load_config, EVAL)
    _, jeval_env = jenvs.make(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    mesh = make_mesh(jax.devices()[:1])
    _, jactor, jstate = jrec_ippo.learner_setup(jeval_env, tuple(keys), jcfg, mesh)
    params = jax.device_get(jstate.params.actor_params)
    n_envs, hidden = 4, jcfg.network.hidden_state_dim
    jeval = jax_get_eval_fn(jeval_env, jax_rec_eval_act_fn(jactor.apply, jcfg), jcfg, mesh,
                            absolute_metric=False)
    eval_key = jax.random.PRNGKey(9)
    want = jeval(params, eval_key,
                 {"hidden_state": JaxScannedRNN.initialize_carry((n_envs, 5), hidden)})
    assert (np.asarray(want["episode_length"]) < 30).any(), "no episode ended before the limit"

    cfg = _config(load_config, EVAL)
    _, eval_env = tenvs.make(cfg, "cpu")
    actor, _ = rec_ippo.make_networks(eval_env, cfg, torch.device("cpu"), 0)
    actor.load_state_dict(from_flax_params(params), strict=True)
    resets, gumbels = _jax_eval_draws(eval_key, jeval_env, n_envs, 2, eval_env.time_limit)
    resets, gumbels = iter(resets), iter(gumbels)
    eval_env.reset_noise = lambda n, generator: next(resets)
    monkeypatch.setattr(distributions, "gumbel", lambda shape, generator, device: next(gumbels))
    got = get_eval_fn(eval_env, make_rec_eval_act_fn(cfg), cfg, absolute_metric=False)(
        actor, torch.Generator(),
        {"hidden_state": ScannedRNN.initialize_carry((n_envs, 5), hidden, "cpu")})
    assert next(gumbels, None) is None
    np.testing.assert_array_equal(got["episode_length"], np.asarray(want["episode_length"]))
    np.testing.assert_array_equal(got["won_episode"], np.asarray(want["won_episode"]))
    np.testing.assert_allclose(got["episode_return"], np.asarray(want["episode_return"]), **TOL)


# ---------------------------------------------------------------- the port's own draws
SAMPLES = 100_000
SIGMA = 5.0


def _assert_moments_match(x: np.ndarray, y: np.ndarray, what: str):
    """Means and variances of two samples (per column) agree within 5 sigma
    of their difference's standard error (normal approximation; the variance's
    standard error from each sample's fourth central moment)."""
    x, y = x.reshape(len(x), -1).astype(np.float64), y.reshape(len(y), -1).astype(np.float64)
    for stat in ("mean", "var"):
        if stat == "mean":
            d = x.mean(0) - y.mean(0)
            se = np.sqrt(x.var(0) / len(x) + y.var(0) / len(y))
        else:
            m4 = lambda z: ((z - z.mean(0)) ** 4).mean(0)  # noqa: E731
            d = x.var(0) - y.var(0)
            se = np.sqrt((m4(x) - x.var(0) ** 2) / len(x) + (m4(y) - y.var(0) ** 2) / len(y))
        assert np.all(np.abs(d) <= SIGMA * se), f"{what} {stat}: {d} vs 5 sigma {SIGMA * se}"


def test_gumbel_noise_matches_jax_and_the_gumbel_law():
    got = distributions.gumbel((SAMPLES,), torch.Generator().manual_seed(1), "cpu").numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (SAMPLES,)))
    _assert_moments_match(got, want, "gumbel vs jax")
    # Standard Gumbel: mean Euler's gamma, variance pi^2 / 6, excess kurtosis 12 / 5.
    var = np.pi**2 / 6
    assert abs(got.mean() - np.euler_gamma) <= SIGMA * np.sqrt(var / SAMPLES)
    assert abs(got.var() - var) <= SIGMA * var * np.sqrt((3 + 12 / 5 - 1) / SAMPLES)
    assert np.isfinite(got).all()


def test_smax_start_positions_match_jax():
    """The start positions of `reset`, every unit and coordinate, against the
    JAX env's resets (clipping to the map included)."""
    env, _ = tenvs.make(_config(load_config), "cpu")
    jenv, _ = jenvs.make(_config(jax_load_config))
    n = SAMPLES // 10  # envs of 16 units each
    state, _ = env.reset(env.reset_noise(n, torch.Generator().manual_seed(3)))
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(3), n))
    _assert_moments_match(state.env_state.unit_pos.numpy(),
                          np.asarray(jstate.env_state.unit_pos), "start positions")


def test_epoch_permutations_are_uniform_and_distinct():
    from mava_tpu_torch.utils.training import epoch_permutations

    gen, n, epochs, draws = torch.Generator().manual_seed(4), 16, 4, 5_000
    perms = torch.stack([epoch_permutations(epochs, n, gen, "cpu") for _ in range(draws)])
    assert all(sorted(p.tolist()) == list(range(n)) for p in perms.reshape(-1, n)[:100])
    # Distinct across the epochs of an update (all equal has odds (1/16!)^3).
    assert all(len({tuple(p.tolist()) for p in update}) == epochs for update in perms)
    # Uniform over positions: each element lands in each position 1/n of the time.
    counts = np.zeros((n, n))
    flat = perms.reshape(-1, n).numpy()
    for pos in range(n):
        counts[pos] = np.bincount(flat[:, pos], minlength=n)
    total, p = len(flat), 1.0 / n
    assert np.all(np.abs(counts - total * p) <= SIGMA * np.sqrt(total * p * (1 - p)))


def test_auto_reset_draws_are_fresh_and_independent_of_the_step_draws():
    """`AutoResetWrapper.step_noise` on SMAX with the random enemy: the reset
    normals differ across envs and steps, and do not correlate with the
    step's own uniforms."""
    overrides = [*SMALL, "env.kwargs.attack_mode=random"]
    env, _ = tenvs.make(_config(load_config, overrides), "cpu")
    gen, n_envs, steps = torch.Generator().manual_seed(5), 8, 2_000
    draws = [env.step_noise(n_envs, gen) for _ in range(steps)]
    uniforms = torch.stack([u for u, _ in draws])  # (steps, E, enemies, agents)
    normals = torch.stack([r.position for _, r in draws])  # (steps, E, units, 2)
    flat = normals.reshape(steps * n_envs, -1)
    assert len({tuple(row.tolist()) for row in flat}) == steps * n_envs
    assert not torch.equal(normals[1:], normals[:-1])
    x = uniforms.reshape(steps * n_envs, -1)[:, 0].double()
    y = flat[:, 0].double()
    corr = torch.corrcoef(torch.stack([x, y]))[0, 1]
    assert abs(float(corr)) <= SIGMA / np.sqrt(len(x)), float(corr)
    _assert_moments_match(normals.reshape(-1, 1).numpy(),
                          np.asarray(jax.random.normal(jax.random.PRNGKey(6), (len(y) * 32, 1))),
                          "auto-reset normals")
