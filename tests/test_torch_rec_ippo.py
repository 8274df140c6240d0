"""rec-IPPO of the port against `mava_tpu`'s, and the port's CLI and config.

The one-update test runs the JAX learner on a 1-device CPU mesh and the port's
learner from the same parameters, env state, Gumbel noise and epoch
permutations; losses and new parameters must agree to rtol = atol = 1e-5.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.parallel import make_mesh
from mava_tpu.systems.ppo import rec_ippo as jrec_ippo
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.ppo import rec_ippo
from mava_tpu_torch.types import Observation, ObservationGlobalState, TimeStep
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_rware import _to_torch_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = [
    "arch.num_envs=2",
    "system.rollout_length=8",
    "system.recurrent_chunk_size=4",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    "system.num_updates=1",
    "network.hidden_state_dim=16",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.actor_network.post_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.post_torso.layer_sizes=[16]",
    "+env.kwargs.time_limit=50",  # "+": SMAX's kwargs have no time_limit key
    "logger.use_console=False",
]


def _prepare(cfg):
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = 1
    return cfg


def _jax_update(layout, system="rec_ippo", centralised=False, env_overrides=(), tiny=TINY):
    cfg = _prepare(jax_load_config(
        f"default_{system}", tiny + [f"system.chunk_layout={layout}", *env_overrides]))
    env, _ = jenvs.make(cfg, add_global_state=centralised)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    learn, _, state = jrec_ippo.learner_setup(
        env, tuple(keys), cfg, make_mesh(jax.devices()[:1]), centralised)
    # The learner's own draws (rec_ippo.py:138-148 and :341-349).
    key, sample_key = jax.random.split(state.key[0])
    noise = jax.random.gumbel(
        sample_key, (cfg.system.rollout_length, cfg.arch.num_envs, env.num_agents, env.action_dim)
    )
    _, shuffle_key = jax.random.split(key)
    num_sequences = cfg.arch.num_envs * cfg.system.rollout_length // cfg.system.recurrent_chunk_size
    perms = jax.numpy.argsort(
        jax.random.bits(shuffle_key, (cfg.system.ppo_epochs, num_sequences), dtype=jax.numpy.uint32),
        axis=1,
    )
    out = jax.device_get(learn(state))
    return jax.device_get(state), np.asarray(noise), np.asarray(perms), out


def _torch_timestep(jts) -> TimeStep:
    """The observation of a JAX timestep (with its global state, where it has
    one) as the port's; the learners read nothing else of the first timestep."""
    o = jts.observation
    kind = ObservationGlobalState if hasattr(o, "global_state") else Observation
    obs = kind(*(torch.tensor(np.asarray(x)) for x in o))
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return TimeStep(t(jts.step_type), t(jts.reward), t(jts.discount), obs, {})


def _assert_no_episode_ended(jout):
    assert not np.any(jout.episode_metrics["is_terminal_step"]), (
        "an episode ended in the rollout: its reset draws would differ"
    )
    assert not np.any(jout.episode_metrics["episode_return"])


def _start_from_jax(state, jstate, to_torch_state=_to_torch_state):
    """The port's learner state with the JAX learner's parameters, env state
    (converted by `to_torch_state`) and first timestep."""
    actor, critic = state.params
    actor.load_state_dict(from_flax_params(jstate.params.actor_params), strict=True)
    critic.load_state_dict(from_flax_params(jstate.params.critic_params), strict=True)
    return state._replace(
        env_state=to_torch_state(jstate.env_state), timestep=_torch_timestep(jstate.timestep)
    )


def _assert_update_matches(out, jout):
    """Losses and new parameters of one update, to rtol = atol = 1e-5."""
    for name, values in jout.train_metrics.items():
        np.testing.assert_allclose(out.train_metrics[name].detach().numpy(), np.asarray(values),
                                   err_msg=name, **TOL)
    for net, jparams in zip(out.learner_state.params, jout.learner_state.params):
        want = from_flax_params(jparams)
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **TOL)


def check_one_recurrent_update(layout, impl, system="rec_ippo", centralised=False,
                               env_overrides=(), to_torch_state=_to_torch_state, tiny=TINY):
    jstate, noise, perms, jout = _jax_update(layout, system, centralised, env_overrides, tiny)
    _assert_no_episode_ended(jout)

    cfg = _prepare(load_config(f"default_{system}", tiny + [
        f"system.chunk_layout={layout}", f"network.gru_impl={impl}", *env_overrides]))
    env, _ = tenvs.make(cfg, "cpu", add_global_state=centralised)
    learn, _, state = rec_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), centralised,
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
    )
    out = learn(_start_from_jax(state, jstate, to_torch_state))
    _assert_update_matches(out, jout)
    for got, want in zip(out.learner_state.hstates, jout.learner_state.hstates):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout,impl", [("contiguous", "auto"), ("strided", "pallas")])
def test_one_update_matches_jax_learner(layout, impl):
    check_one_recurrent_update(layout, impl)


def test_cli_end_to_end(fast_config_overrides, monkeypatch, capsys):
    argv = ["rec_ippo", *fast_config_overrides, "env.kwargs.time_limit=16", "+arch.device=cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    performance = rec_ippo.main()
    assert np.isfinite(performance)
    assert "Recurrent IPPO experiment completed." in capsys.readouterr().out


def test_json_logger_writes_marl_eval_layout(fast_config_overrides, tmp_path):
    cfg = load_config("default_rec_ippo", fast_config_overrides + [
        "env.kwargs.time_limit=16", "+arch.device=cpu", "logger.use_json=True",
        f"logger.base_exp_path={tmp_path}", "arch.absolute_metric=True",
    ])
    _, output = rec_ippo.run_experiment(cfg)
    assert all(torch.isfinite(v).all() for v in output.train_metrics.values())
    (path,) = tmp_path.glob("json/rec_ippo/*/metrics.json")
    run = json.loads(path.read_text())["RobotWarehouse"]["tiny-2ag"]["rec_ippo"]["run_42"]
    assert set(run) == {"step_0", "absolute_metrics"}
    assert {"step_count", "mean_episode_return", "steps_per_second"} <= set(run["step_0"])


def test_cuda_device_without_cuda_raises(fast_config_overrides):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        rec_ippo.run_experiment(load_config("default_rec_ippo", fast_config_overrides))


@pytest.mark.parametrize("key", ["save_model", "load_model"])
def test_checkpointing_is_not_yet_ported(fast_config_overrides, key, tmp_path, monkeypatch):
    """Checkpointing is ported (`utils/checkpointing.py`): `save_model` writes
    the params and hidden states of each round, and `load_model` reads them,
    failing loudly where there is no checkpoint to read."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("default_rec_ippo", fast_config_overrides + [
        "+arch.device=cpu", f"logger.checkpointing.{key}=True", "env.kwargs.time_limit=16",
        "logger.checkpointing.save_args.checkpoint_uid=u",
        "logger.checkpointing.load_args.checkpoint_uid=u"])
    if key == "load_model":
        with pytest.raises(FileNotFoundError, match="No checkpoint"):
            rec_ippo.run_experiment(cfg)
        return
    rec_ippo.run_experiment(cfg)
    (saved,) = tmp_path.glob("checkpoints/rec_ippo/u/*/model.pt")
    assert set(torch.load(saved, weights_only=True)) == {"params", "hstates"}


@pytest.mark.parametrize("overrides", [
    [],
    ["env/scenario=tiny-4ag", "system.seed=7", "arch.num_envs=64"],
    ["network=mlp", "system=ppo/ff_ippo", "+system.my_flag=1", "arch.donate_buffers=True"],
    ["env.scenario=small-4ag", "logger.kwargs.json_path=x", "system.actor_lr=1e-3"],
])
def test_config_composition_matches_jax_loader(overrides):
    assert load_config("default_rec_ippo", overrides).to_dict() == \
        jax_load_config("default_rec_ippo", overrides).to_dict()


@pytest.mark.parametrize("bad", ["system.no_such_key=1", "nope.a=1", "env/nope=x", "justakey"])
def test_config_overrides_are_strict(bad):
    with pytest.raises((KeyError, ValueError)):
        load_config("default_rec_ippo", [bad])
