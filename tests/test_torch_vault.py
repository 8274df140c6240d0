"""The vault and recorded experience of the port (`replay/vault.py`,
`systems/ppo/ff_ippo.py` `return_trajectories`,
`advanced_usage/ff_ippo_store_experience.py`, `examples/bc_from_vault.py`)
against the JAX package's (twins of `tests/test_replay.py:92,112` and
`tests/test_systems_integration.py:159`).

The JAX ff-IPPO learner wired as the reference's recording program wires it
(`return_trajectories=True`) and the port's learner run one update of RWARE
tiny-2ag from the same parameters, env state, Gumbel noise and permutations:
the transition batches agree to rtol = atol = 1e-5. A vault written by either
package reads back, leaf for leaf, in the other, also where one appends to
the other's. The recording program writes one vault a run, and
`bc_from_vault` clones a policy from it and evaluates the clone.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mava_tpu import envs as jenvs
from mava_tpu.networks import FeedForwardValueNet as JCritic
from mava_tpu.networks.factory import make_torso as jmake_torso
from mava_tpu.parallel import DATA_AXIS, build_learner, make_mesh
from mava_tpu.replay import Vault as JVault
from mava_tpu.systems.ppo import ff_ippo as jff_ippo
from mava_tpu.systems.ppo.types import LearnerState as JLearnerState
from mava_tpu.types import ExperimentOutput as JExperimentOutput
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu.utils.training import make_learning_rate as jmake_learning_rate
from mava_tpu.utils.training import make_optimizer as jmake_optimizer
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import ff_ippo_store_experience
from mava_tpu_torch.examples import bc_from_vault
from mava_tpu_torch.replay.vault import Vault, leaf_names
from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.utils.config import load_config
from test_torch_ff_ippo import TINY
from test_torch_rec_ippo import _prepare, _start_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
LEAVES = {".done", ".action", ".value", ".reward", ".log_prob", ".obs.agents_view",
          ".obs.action_mask", ".obs.step_count", ".info_episode_return",
          ".info_episode_length", ".info_is_terminal_step"}


@functools.lru_cache(maxsize=None)
def _jax_trajectories(devices: int = 1):
    """One update of the JAX learner built as the recording program builds it
    (ff_ippo_store_experience.py:51-89) on a mesh of `devices`, its first
    state and each shard's draws (noise, permutations)."""
    cfg = _prepare(jax_load_config("default_ff_ippo", TINY))
    cfg.arch.n_devices = devices
    mesh = make_mesh(jax.devices()[:devices])
    env, _ = jenvs.make(cfg)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    _, actor, state = jff_ippo.learner_setup(env, tuple(keys), cfg, mesh)
    critic = JCritic(torso=jmake_torso(cfg.network.critic_network.pre_torso))
    optims = [jmake_optimizer(jmake_learning_rate(lr, cfg), cfg.system.max_grad_norm)
              for lr in (cfg.system.actor_lr, cfg.system.critic_lr)]
    learner = jff_ippo.get_learner_fn(env, (actor.apply, critic.apply),
                                      tuple(o.update for o in optims), cfg,
                                      return_trajectories=True)
    specs = JLearnerState(params=P(), opt_states=P(), key=P(DATA_AXIS), env_state=P(DATA_AXIS),
                          timestep=P(DATA_AXIS))
    out_specs = (JExperimentOutput(learner_state=specs, episode_metrics=P(None, None, DATA_AXIS),
                                   train_metrics=P()), P(None, None, DATA_AXIS))
    learn = build_learner(learner, mesh, in_specs=(specs,), out_specs=out_specs)
    draws = []
    for shard_key in state.key:
        # Each shard's own draws (ff_ippo.py:116-126 and :262-270).
        key, sample_key = jax.random.split(shard_key)
        noise = jax.random.gumbel(sample_key, (cfg.system.rollout_length, cfg.arch.num_envs,
                                               env.num_agents, env.action_dim))
        _, shuffle_key = jax.random.split(key)
        perms = jax.numpy.argsort(jax.random.bits(
            shuffle_key, (cfg.system.ppo_epochs, cfg.system.rollout_length * cfg.arch.num_envs),
            dtype=jax.numpy.uint32), axis=1)
        draws.append((np.asarray(noise), np.asarray(perms)))
    out, trajectories = jax.device_get(learn(state))
    return jax.device_get(state), draws, out, trajectories


@functools.lru_cache(maxsize=None)
def _port_trajectories():
    jstate, draws, _, _ = _jax_trajectories()
    (noise, perms), = draws
    cfg = _prepare(load_config("default_ff_ippo", TINY + ["+arch.device=cpu"]))
    env, _ = tenvs.make(cfg, "cpu")
    learn, _, state = ff_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
        return_trajectories=True)
    return learn(_start_from_jax(state, jstate))


def _batch_major(tree):
    """The reference's reshape (ff_ippo_store_experience.py:115-121)."""
    return jax.tree.map(lambda x: np.moveaxis(np.asarray(x), 2, 0).reshape(
        x.shape[2] * x.shape[0], x.shape[1], *x.shape[3:]), tree)


def test_return_trajectories_matches_jax_learner():
    _, _, jout, jtraj = _jax_trajectories()
    out, traj = _port_trajectories()
    assert type(traj).__name__ == "PPOTransition" and traj.done.shape[:3] == (1, 8, 2)
    got, want = traj._asdict(), jtraj._asdict()
    for name in ("done", "action", "value", "reward", "log_prob"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    for g, w in zip(got["obs"], want["obs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for k, v in want["info"].items():
        np.testing.assert_allclose(got["info"][k].numpy(), np.asarray(v), err_msg=k, **TOL)
        np.testing.assert_array_equal(out.episode_metrics[k].numpy(), np.asarray(v))
    for name, values in jout.train_metrics.items():
        np.testing.assert_allclose(out.train_metrics[name].numpy(), np.asarray(values), **TOL)
    for g, w in zip(jax.tree.leaves(ff_ippo_store_experience.batch_major(traj)),
                    jax.tree.leaves(_batch_major(jtraj))):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def _assert_read_equal(got, want):
    assert set(got) == set(want) == LEAVES
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "port", "port_appends_to_jax"])
def test_vault_written_by_either_package_reads_back_in_the_other(writer, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jslab = _batch_major(_jax_trajectories()[-1])
    tslab = ff_ippo_store_experience.batch_major(_port_trajectories()[1])
    assert set(leaf_names(tslab)) == LEAVES
    if writer == "jax":
        jvault = JVault("rec", vault_uid="u")
        jvault.write(jslab)
        jvault.write(jslab)
    elif writer == "port":
        tvault = Vault("rec", vault_uid="u")
        assert tvault.write(tslab) == sum(x.numel() for x in jax.tree.leaves(tslab))
        tvault.write(tslab)
    else:
        JVault("rec", vault_uid="u").write(jslab)
        Vault("rec", vault_uid="u").write(tslab)  # its leaves flatten in another order
    port_read, jax_read = Vault("rec", vault_uid="u").read(), JVault("rec", vault_uid="u").read()
    _assert_read_equal(port_read, jax_read)
    first = jslab if writer != "port" else jax.tree.map(lambda x: x.numpy(), tslab)
    np.testing.assert_allclose(port_read[".obs.agents_view"][:, :8],
                               first.obs.agents_view, **TOL)
    assert port_read[".reward"].shape == (2, 16, 2)  # two slabs along time
    assert sorted(os.listdir(tmp_path / "vaults" / "rec" / "u")) == [
        "chunk_000000", "chunk_000001", "manifest.json", "treedef.txt"]


def test_vault_refuses_a_slab_of_other_leaves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vault = Vault("v", vault_uid="u")
    vault.write({"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="not the vault's"):
        vault.write({"b": torch.zeros(2, 3)})


STORE = ["system.num_updates=2", "arch.num_evaluation=2", "system.rollout_length=4",
         "arch.num_envs=2", "arch.num_eval_episodes=4", "env.kwargs.time_limit=16"]


def test_store_experience_then_behaviour_clone(tmp_path, monkeypatch, capsys):
    """The recording program writes one vault of every update's transitions
    (twin of `test_systems_integration.py:159`); `bc_from_vault` reads it,
    clones a policy and evaluates it."""
    monkeypatch.chdir(tmp_path)
    cfg = load_config("default_ff_ippo", STORE + ["+arch.device=cpu"])
    cfg.logger.system_name = "store_exp_test"
    perf = ff_ippo_store_experience.run_experiment(cfg)
    assert isinstance(perf, float) and np.isfinite(perf)
    vault_dirs = list((tmp_path / "vaults" / "store_exp_test").iterdir())
    assert len(vault_dirs) == 1 and (vault_dirs[0] / "manifest.json").exists()
    data = Vault("store_exp_test", vault_uid=vault_dirs[0].name).read()
    assert set(data) == LEAVES
    assert data[".action"].shape == (2, 8, 2)  # E * updates a round, 2 rounds of T = 4

    capsys.readouterr()
    ret = bc_from_vault.main(["+arch.device=cpu", "vault_name=store_exp_test", "bc_epochs=2",
                              "bc_batch_size=8", "arch.num_eval_episodes=4",
                              "env.kwargs.time_limit=16"])
    out = capsys.readouterr().out
    assert np.isfinite(ret) and "dataset: 16 timesteps x 2 agents" in out
    assert "epoch 1: bc loss" in out and "BC policy eval return" in out


def test_store_experience_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["store", *STORE, "+arch.device=cpu"])
    assert np.isfinite(ff_ippo_store_experience.main())
    out = capsys.readouterr().out
    assert out.rstrip().endswith("ff-IPPO experience-recording run completed.")
    assert "Experience stored in " in out
    assert os.listdir(tmp_path / "vaults") == ["ff_ippo_store_experience"]


def test_programs_run_on_the_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        ff_ippo_store_experience.run_experiment(load_config("default_ff_ippo", STORE))
    Vault("ff_ippo_store_experience", vault_uid="u").write(
        ff_ippo_store_experience.batch_major(_port_trajectories()[1]))
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        bc_from_vault.main(["vault_uid=u", "bc_epochs=1"])
