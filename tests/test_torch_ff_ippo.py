"""ff-IPPO and ff-MAPPO of the port against `mava_tpu`'s, and the CLIs of the
on-policy systems this slice adds.

The one-update test runs the JAX learner on a 1-device CPU mesh and the port's
learner from the same parameters, env state, Gumbel noise and epoch
permutations; losses and new parameters must agree to rtol = atol = 1e-5.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.parallel import make_mesh
from mava_tpu.systems.ppo import ff_ippo as jff_ippo
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.ppo import ff_ippo, ff_mappo, rec_mappo
from mava_tpu_torch.utils.config import load_config
from test_torch_rec_ippo import (
    _assert_no_episode_ended,
    _assert_update_matches,
    _prepare,
    _start_from_jax,
)

torch.set_num_threads(1)
TINY = [
    "arch.num_envs=2",
    "system.rollout_length=8",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    "system.num_updates=1",
    "network.actor_network.pre_torso.layer_sizes=[16,16]",
    "network.critic_network.pre_torso.layer_sizes=[16,16]",
    "env.kwargs.time_limit=50",
    "logger.use_console=False",
]
SYSTEMS = {
    "ff_ippo": (ff_ippo, "ff-IPPO experiment completed."),
    "ff_mappo": (ff_mappo, "ff-MAPPO experiment completed."),
    "rec_mappo": (rec_mappo, "Recurrent MAPPO experiment completed."),
}


def _jax_update(system, centralised, overrides, tiny=TINY):
    cfg = _prepare(jax_load_config(f"default_{system}", tiny + overrides))
    env, _ = jenvs.make(cfg, add_global_state=centralised)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    learn, _, state = jff_ippo.learner_setup(
        env, tuple(keys), cfg, make_mesh(jax.devices()[:1]), centralised)
    # The learner's own draws (ff_ippo.py:116-126 and :262-270).
    key, sample_key = jax.random.split(state.key[0])
    noise = jax.random.gumbel(
        sample_key, (cfg.system.rollout_length, cfg.arch.num_envs, env.num_agents, env.action_dim)
    )
    _, shuffle_key = jax.random.split(key)
    batch_size = cfg.system.rollout_length * cfg.arch.num_envs
    perms = jax.numpy.argsort(
        jax.random.bits(shuffle_key, (cfg.system.ppo_epochs, batch_size), dtype=jax.numpy.uint32),
        axis=1,
    )
    out = jax.device_get(learn(state))
    return jax.device_get(state), np.asarray(noise), np.asarray(perms), out


@pytest.mark.parametrize("system,centralised,overrides", [
    ("ff_ippo", False, []),
    ("ff_mappo", True, []),
    ("ff_ippo", False, ["network.actor_network.pre_torso.use_layer_norm=True",
                        "network.critic_network.pre_torso.use_layer_norm=True",
                        "system.ent_coef_final=0.001", "system.decay_learning_rates=True"]),
], ids=["ff_ippo", "ff_mappo", "ff_ippo-layer_norm-schedules"])
def test_one_update_matches_jax_learner(system, centralised, overrides):
    jstate, noise, perms, jout = _jax_update(system, centralised, overrides)
    _assert_no_episode_ended(jout)

    cfg = _prepare(load_config(f"default_{system}", TINY + overrides))
    env, _ = tenvs.make(cfg, "cpu", add_global_state=centralised)
    learn, _, state = ff_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), centralised,
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
    )
    out = learn(_start_from_jax(state, jstate))
    _assert_update_matches(out, jout)


def test_learner_draws_its_own_noise_and_permutations():
    """Without injected draws the learner takes them from the state's generator:
    the same seed gives the same update, another seed another."""
    def update(seed):
        cfg = _prepare(load_config("default_ff_ippo", TINY))
        env, _ = tenvs.make(cfg, "cpu")
        learn, _, state = ff_ippo.learner_setup(
            env, torch.Generator().manual_seed(seed), cfg, torch.device("cpu"))
        out = learn(state)
        return torch.cat([p.detach().flatten() for p in out.learner_state.params[0].parameters()])

    a, b, c = update(1), update(1), update(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_cli_end_to_end(system, fast_config_overrides, monkeypatch, capsys):
    module, last_line = SYSTEMS[system]
    argv = [system, *fast_config_overrides, "env.kwargs.time_limit=16", "+arch.device=cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    performance = module.main()
    assert np.isfinite(performance)
    assert last_line in capsys.readouterr().out


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_cuda_device_without_cuda_raises(system, fast_config_overrides):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        SYSTEMS[system][0].run_experiment(load_config(f"default_{system}", fast_config_overrides))


@pytest.mark.parametrize("system,error,match", [
    ("ff_ippo", None, None),
    ("ff_mappo", None, None),
    ("rec_mappo", ValueError, "not supported by rec-IPPO/rec-MAPPO"),
])
def test_stagger_resets_raises(system, error, match, fast_config_overrides):
    """Since `envs/stagger.py` is ported only the recurrent systems refuse
    `arch.stagger_resets`; the feed-forward PPO systems stagger their resets
    (`tests/test_torch_specs_stagger.py` holds the burn-in against JAX's)."""
    cfg = load_config(f"default_{system}", fast_config_overrides + [
        "+arch.device=cpu", "arch.stagger_resets=True", "env.kwargs.time_limit=16"])
    if error is None:
        performance, _ = SYSTEMS[system][0].run_experiment(cfg)
        assert np.isfinite(performance)
        return
    with pytest.raises(error, match=match):
        SYSTEMS[system][0].run_experiment(cfg)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_checkpointing_is_not_yet_ported(system, fast_config_overrides, tmp_path, monkeypatch):
    """Checkpointing is ported (`utils/checkpointing.py`): `save_model` writes
    the params of each round under checkpoints/<system>/<uid>/<step>/."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config(f"default_{system}", fast_config_overrides + [
        "+arch.device=cpu", "logger.checkpointing.save_model=True",
        "logger.checkpointing.save_args.checkpoint_uid=u", "env.kwargs.time_limit=16"])
    SYSTEMS[system][0].run_experiment(cfg)
    assert list(tmp_path.glob(f"checkpoints/{system}/u/*/model.pt"))


def test_absolute_metric_and_accepted_tpu_keys(fast_config_overrides):
    """`system.gae_impl` and `system.rollout_unroll` are accepted and ignored;
    the absolute metric evaluates the best actor once more."""
    cfg = load_config("default_ff_ippo", fast_config_overrides + [
        "env.kwargs.time_limit=16", "+arch.device=cpu", "arch.absolute_metric=True",
        "+system.gae_impl=sequential", "system.rollout_unroll=4"])
    performance, output = ff_ippo.run_experiment(cfg)
    assert np.isfinite(performance)
    assert all(torch.isfinite(v).all() for v in output.train_metrics.values())
    assert output.train_metrics["total_loss"].shape == (2, 1, 2)


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("RUN_LEARNING_GATE") != "1",
                    reason="learning gate is opt-in: set RUN_LEARNING_GATE=1")
def test_ff_ippo_learns_matrax_penalty():
    """The port's twin of `test_learning_gate.py::test_ff_ippo_learns_matrax_penalty`:
    the same config and threshold (random scores about -31, the safe
    equilibrium pays 20 an episode)."""
    cfg = load_config("default_ff_ippo", [
        "env=matrax",
        "env.scenario.task_name=Penalty-25-stateless-v0",
        "env.kwargs.time_limit=10",
        "arch.num_envs=16",
        "system.rollout_length=128",
        "system.total_timesteps=300000",
        "arch.num_evaluation=3",
        "arch.num_eval_episodes=32",
        "arch.absolute_metric=False",
        "logger.use_console=False",
        "+arch.device=cpu",
    ])
    perf, _ = ff_ippo.run_experiment(cfg)
    assert perf > 10.0, f"ff-IPPO failed the Penalty learning gate: {perf}"
