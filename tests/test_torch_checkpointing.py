"""The port's checkpointing: the twins of `tests/test_checkpointing.py`
(params and hidden-state roundtrips, a corrupted step, the params item of a
full-state checkpoint, the best step by return, save-then-load, and the
exact-state resumes), the checkpoint manager's options, and the seven CLIs.

An exact-state resume builds a fresh learner, restores the full state saved
after one learner call into it and calls it again: parameters, optimizer
moments, generators, env states, hidden states, buffers and counters must be
bitwise equal to the run that never stopped, for ff-IPPO, rec-IPPO, rec-IQL
and ff-ISAC.
"""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch
from torch import nn

from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.ppo import ff_ippo, ff_mappo, rec_ippo, rec_mappo
from mava_tpu_torch.systems.ppo.types import (
    HiddenStates,
    LearnerState,
    OptStates,
    Params,
    RNNLearnerState,
)
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.sac import ff_isac, ff_masac
from mava_tpu_torch.utils.checkpointing import (
    CHECKPOINTER_VERSION, Checkpointer, differences, to_host)
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _linear(seed, n_in=4, n_out=2):
    torch.manual_seed(seed)
    return nn.Linear(n_in, n_out)


def _state(params, hstates=None):
    """A learner state whose params (and hidden states) are what a
    params-level checkpoint keeps."""
    if hstates is None:
        return LearnerState(params, OptStates(None, None), None, None, None)
    return RNNLearnerState(params, OptStates(None, None), None, None, None, None, hstates)


def test_params_roundtrip(workdir):
    params = Params(_linear(0), _linear(1))
    ckpt = Checkpointer(model_name="m", checkpoint_uid="u1", save_interval_steps=1)
    assert ckpt.save(timestep=100, unreplicated_learner_state=_state(params), episode_return=1.5)

    template = Params(_linear(2), _linear(3))
    restored, hstates = Checkpointer(model_name="m", checkpoint_uid="u1").restore_params(
        input_params=template)
    assert restored.actor_params is template.actor_params  # loaded in place
    torch.testing.assert_close(restored.actor_params.weight, params.actor_params.weight, rtol=0, atol=0)
    assert hstates is None


def test_hidden_state_roundtrip(workdir):
    params = Params(_linear(0), _linear(1))
    hstates = HiddenStates(torch.full((2, 4), 7.0), torch.full((2, 4), 9.0))
    ckpt = Checkpointer(model_name="m", checkpoint_uid="u2")
    assert ckpt.save(5, _state(params, hstates), episode_return=0.0)

    loader = Checkpointer(model_name="m", checkpoint_uid="u2")
    _, restored_h = loader.restore_params(
        input_params=Params(_linear(2), _linear(3)), restore_hstates=True,
        input_hstates=HiddenStates(torch.zeros(2, 4), torch.zeros(2, 4)))
    torch.testing.assert_close(restored_h.policy_hidden_state, torch.full((2, 4), 7.0))
    torch.testing.assert_close(restored_h.critic_hidden_state, torch.full((2, 4), 9.0))


def test_corrupted_checkpoint_surfaces_as_itself(workdir):
    """A step directory without its params file raises a FileNotFoundError
    naming the directory, not a confusing error from deeper down."""
    ckpt = Checkpointer(model_name="m", checkpoint_uid="uc")
    assert ckpt.save(7, _state(Params(_linear(0), _linear(1))))
    os.remove(os.path.join(ckpt.directory, "7", "model.pt"))
    loader = Checkpointer(model_name="m", checkpoint_uid="uc")
    with pytest.raises(FileNotFoundError, match="missing or corrupted"):
        loader.restore_state({"params": Params(_linear(0), _linear(1))})


def test_full_state_checkpoint_restores_params_item(workdir):
    params = Params(_linear(0), _linear(1))
    state = LearnerState(params, OptStates(None, None), torch.Generator().manual_seed(3),
                         torch.zeros(3), torch.ones(3))
    ckpt = Checkpointer(model_name="m", checkpoint_uid="uf")
    assert ckpt.save(3, state, full_state=True)
    loader = Checkpointer(model_name="m", checkpoint_uid="uf")
    restored, _ = loader.restore_params(input_params=Params(_linear(2), _linear(3)))
    torch.testing.assert_close(restored.critic_params.bias, params.critic_params.bias, rtol=0, atol=0)
    full = loader.restore_full_state(LearnerState(
        Params(_linear(4), _linear(5)), OptStates(None, None), torch.Generator(),
        torch.empty(3), torch.empty(3)))
    assert torch.equal(torch.rand(3, generator=full.key),
                       torch.rand(3, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(full.timestep, torch.ones(3))


def test_best_checkpoint_tracked_by_return(workdir):
    ckpt = Checkpointer(model_name="m", checkpoint_uid="u3", max_to_keep=2)
    ckpt.save(1, _state(Params(_linear(0), _linear(0))), episode_return=5.0)
    ckpt.save(2, _state(Params(_linear(1), _linear(1))), episode_return=1.0)
    assert ckpt.best_step() == 1  # the higher episode return wins


def test_manager_options_follow_orbax(workdir):
    """`save_interval_steps` skips the steps it does not divide and never saves
    backwards; `max_to_keep` keeps the best by return; `keep_period` keeps the
    steps it divides; the config is sanitised JSON beside the version."""
    ckpt = Checkpointer(model_name="m", checkpoint_uid="u4", metadata={"a": {"b": (1, 2)}},
                        save_interval_steps=2, max_to_keep=2, keep_period=8)
    p = _state(Params(_linear(0), _linear(1)))
    assert not ckpt.save(3, p) and ckpt.save(4, p, episode_return=3.0)
    assert not ckpt.save(4, p) and not ckpt.save(2, p)
    for step, ret in ((6, 1.0), (8, 0.0), (10, 5.0), (12, 4.0)):
        assert ckpt.save(step, p, episode_return=ret)
    assert ckpt.all_steps() == [8, 10, 12] and ckpt.latest_step() == 12
    assert ckpt.get_cfg() == {"a": {"b": [1, 2]}, "checkpointer_version": CHECKPOINTER_VERSION}


def test_major_version_is_checked(workdir):
    ckpt = Checkpointer(model_name="m", checkpoint_uid="u5")
    assert ckpt.save(1, _state(Params(_linear(0), _linear(1))))
    path = os.path.join(ckpt.directory, "metadata.json")
    with open(path, "w") as f:
        json.dump({"checkpointer_version": CHECKPOINTER_VERSION + 1}, f)
    with pytest.raises(ValueError, match="major version"):
        Checkpointer(model_name="m", checkpoint_uid="u5").restore_params(
            Params(_linear(0), _linear(1)))


def test_default_checkpoint_uid_is_a_timestamp(workdir):
    uid = os.path.basename(Checkpointer(model_name="m").directory)
    assert len(uid) == 14 and uid.isdigit(), uid


def test_end_to_end_save_then_load(workdir, fast_config_overrides):
    """Train ff-IPPO with checkpointing on, then start a run that loads its
    parameters (the reference's `learner_setup` load path)."""
    base = fast_config_overrides + ["env.kwargs.time_limit=16", "+arch.device=cpu"]
    ff_ippo.run_experiment(load_config("default_ff_ippo", base + [
        "logger.checkpointing.save_model=True",
        "logger.checkpointing.save_args.checkpoint_uid=e2e"]))
    saved = torch.load(next(workdir.glob("checkpoints/ff_ippo/e2e/*/model.pt")),
                       weights_only=True)
    cfg = load_config("default_ff_ippo", base + [
        "logger.checkpointing.load_model=True", "logger.checkpointing.load_args.checkpoint_uid=e2e"])
    env, _ = tenvs.make(cfg, "cpu")
    cfg.system.num_updates_per_eval = 1
    _, actor, _ = ff_ippo.learner_setup(env, torch.Generator(), cfg, torch.device("cpu"))
    for name, value in actor.state_dict().items():
        assert torch.equal(value, saved["params"][0]["__module__"][name]), name
    assert isinstance(ff_ippo.run_experiment(cfg)[0], float)


# ---------------------------------------------------------------- exact-state resume
def test_differences_names_each_leaf_that_differs():
    want = {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor([1, 2, 3]), 4], "c": None}
    assert differences(want, {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor([1, 2, 3]), 4],
                              "c": None}) == []
    got = {"a": torch.tensor([1.0, 2.5]), "b": [torch.tensor([1, 0, 0]), 5], "c": None}
    d = dict(differences(got, want))
    assert d["state.a"] == 0.5 and d["state.b[0]"] == 2.0 and np.isnan(d["state.b[1]"])
    for bad in ({"a": torch.tensor([1.0]), "b": want["b"], "c": None},
                {"a": torch.tensor([1, 2]), "b": want["b"], "c": None},
                {"a": want["a"], "b": want["b"][:1], "c": None},
                {"a": want["a"], "b": want["b"]}):
        assert len(differences(bad, want)) == 1 and np.isnan(differences(bad, want)[0][1])


def _check_resume(setup, call):
    """`setup()` -> (learner fns, state) of a fresh learner; `call(fns, state)`
    -> (state, metrics). Saves after one call, continues, and resumes a fresh
    learner from the checkpoint."""
    fns, state = setup()
    state, _ = call(fns, state)
    ckpt = Checkpointer(model_name="m", checkpoint_uid="exact")
    assert ckpt.save(1, state, episode_return=0.0, full_state=True)
    want_state, want_metrics = call(fns, state)  # the run that never stopped

    fresh_fns, fresh = setup()
    restored = Checkpointer(model_name="m", checkpoint_uid="exact").restore_full_state(fresh)
    got_state, got_metrics = call(fresh_fns, restored)
    assert differences(to_host(got_state), to_host(want_state)) == []
    assert differences(to_host(got_metrics), to_host(want_metrics), "metrics") == []
    params_only, _ = Checkpointer(model_name="m", checkpoint_uid="exact").restore_params(
        input_params=fresh.params)
    assert params_only[0] is fresh.params[0]  # modules are loaded in place


TINY_PPO = ["env.kwargs.time_limit=8", "arch.num_envs=2", "system.rollout_length=4",
            "system.num_updates=2", "system.ppo_epochs=1", "system.num_minibatches=2",
            "logger.use_console=False", "+arch.device=cpu"]


@pytest.mark.parametrize("module,system", [(ff_ippo, "default_ff_ippo"),
                                           (rec_ippo, "default_rec_ippo")],
                         ids=["ff_ippo", "rec_ippo"])
def test_exact_state_resume_is_bitwise(workdir, module, system):
    def setup():
        cfg = load_config(system, TINY_PPO)
        cfg.arch.n_devices, cfg.system.num_updates_per_eval = 1, 1
        if system == "default_rec_ippo":
            cfg.system.recurrent_chunk_size = cfg.system.rollout_length
        env, _ = tenvs.make(cfg, "cpu")
        learn, _, state = module.learner_setup(env, torch.Generator().manual_seed(0), cfg,
                                               torch.device("cpu"))
        return learn, state

    def call(learn, state):
        out = learn(state)
        return out.learner_state, (out.episode_metrics, out.train_metrics)

    _check_resume(setup, call)


def test_exact_state_resume_iql_is_bitwise(workdir):
    def setup():
        cfg = load_config("default_rec_iql", [
            "env.kwargs.time_limit=8", "arch.num_envs=2", "system.num_updates=4",
            "system.sample_batch_size=4", "system.sample_sequence_length=4",
            "network.hidden_state_dim=16", "system.buffer_size=64", "system.min_buffer_size=4",
            "logger.use_console=False", "+arch.device=cpu"])
        cfg.arch.n_devices, cfg.system.num_updates_per_eval = 1, 2
        env, _ = tenvs.make(cfg, "cpu")
        learn, _, state = rec_iql.learner_setup(env, torch.Generator().manual_seed(0), cfg,
                                                torch.device("cpu"))
        return learn, state

    def call(learn, state):
        out = learn(state)
        return out.learner_state, (out.episode_metrics, out.train_metrics)

    _check_resume(setup, call)


def test_exact_state_resume_sac_is_bitwise(workdir):
    """The SAC counterpart: the item buffer and the env-step counter too."""
    def setup():
        cfg = load_config("default_ff_isac", [
            "env=maswarm", "env.kwargs.time_limit=8", "arch.num_envs=2",
            "system.rollout_length=2", "system.explore_steps=8", "system.buffer_size=32",
            "system.batch_size=4", "system.epochs=2", "logger.use_console=False",
            "+arch.device=cpu"])
        cfg.arch.n_devices, cfg.system.scan_steps = 1, 2
        env, _ = tenvs.make(cfg, "cpu")
        explore, learn, _, state = ff_isac.learner_setup(
            env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
        state, _ = explore(state)
        return learn, state

    def call(learn, state):
        out = learn(state)
        return out.learner_state, (out.episode_metrics, out.train_metrics)

    _check_resume(setup, call)


# ---------------------------------------------------------------- the CLIs
PPO_CLI = ["system.num_updates=2", "arch.num_evaluation=2", "system.rollout_length=4",
           "arch.num_envs=2", "arch.num_eval_episodes=2", "arch.absolute_metric=False",
           "+system.ppo_epochs=1", "+system.num_minibatches=2", "env.kwargs.time_limit=16"]
IQL_CLI = ["arch.num_evaluation=2", "arch.num_envs=2", "arch.num_eval_episodes=2",
           "arch.absolute_metric=False", "system.sample_batch_size=4",
           "network.hidden_state_dim=16", "system.sample_sequence_length=6",
           "env.kwargs.time_limit=16"]
SAC_CLI = ["arch.num_evaluation=2", "arch.num_envs=4", "system.explore_steps=40",
           "system.epochs=2", "arch.num_eval_episodes=2", "arch.absolute_metric=False",
           "network.actor_network.pre_torso.layer_sizes=[16]",
           "network.critic_network.pre_torso.layer_sizes=[16]", "env.kwargs.time_limit=16"]
SYSTEMS = {  # name -> (module, first run's budget, resumed run's budget, steps saved)
    "ff_ippo": (ff_ippo, PPO_CLI, PPO_CLI, 16),
    "ff_mappo": (ff_mappo, PPO_CLI, PPO_CLI, 16),
    "rec_ippo": (rec_ippo, PPO_CLI, PPO_CLI, 16),
    "rec_mappo": (rec_mappo, PPO_CLI, PPO_CLI, 16),
    "rec_iql": (rec_iql, IQL_CLI + ["system.num_updates=2"], IQL_CLI + ["system.num_updates=4"],
                8),
    # Rounds of 120 // 2 env-steps from the explore phase's 40: 100, 160.
    "ff_isac": (ff_isac, SAC_CLI + ["system.total_timesteps=120"],
                SAC_CLI + ["system.total_timesteps=200"], 160),
    "ff_masac": (ff_masac, SAC_CLI + ["system.total_timesteps=120"],
                 SAC_CLI + ["system.total_timesteps=200"], 160),
}


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_cli_saves_then_resumes(system, workdir, monkeypatch, capsys):
    """A run saves params and full state each round; a second run loads them
    (`load_model`, where the reference reads it, and `load_full_state`) and
    logs on from the saved step: a PPO resume trains a fresh budget on top,
    SAC and IQL the rest of theirs, without SAC's explore phase."""
    module, first, resumed, saved_at = SYSTEMS[system]
    keys = ["logger.checkpointing.save_model=True", "logger.checkpointing.save_full_state=True",
            "logger.checkpointing.save_args.checkpoint_uid=cli",
            "logger.checkpointing.save_args.max_to_keep=100", "+arch.device=cpu",
            "logger.use_console=True"]
    monkeypatch.setattr(sys, "argv", [system, *first, *keys])
    assert np.isfinite(module.main())
    directory = workdir / "checkpoints" / system / "cli"
    assert max(int(d.name) for d in directory.iterdir() if d.name.isdigit()) == saved_at
    assert (directory / str(saved_at) / "state.pt").exists()
    capsys.readouterr()

    shutil.move(str(directory), str(workdir / "checkpoints" / system / "from"))
    loads = ["logger.checkpointing.load_model=True", "logger.checkpointing.load_full_state=True",
             "logger.checkpointing.load_args.checkpoint_uid=from"]
    monkeypatch.setattr(sys, "argv", [system, *resumed, *keys, *loads])
    assert np.isfinite(module.main())
    logged = re.sub(r"\x1b\[[0-9;]*m", "", "".join(capsys.readouterr()))
    steps = [int(x) for x in re.findall(r"Timestep: (\d+)", logged)]
    assert steps and steps[0] > saved_at, (steps, saved_at)
    assert "Step: 40" not in logged  # no second explore phase
