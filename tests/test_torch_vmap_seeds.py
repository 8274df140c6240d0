"""The port's stacked seed programs (`mava_tpu_torch/advanced_usage/*_vmap_seeds.py`)
against the port's stock learners and against the JAX package's vmapped
learners (twin of `tests/test_vmap_seeds.py:30`).

One update of S = 2 seeds of ff-IPPO and ff-MAPPO here, rec-IPPO and rec-MAPPO
in `test_torch_vmap_seeds_rec.py`, on RWARE tiny-2ag at small widths: seed s of the stacked update equals the port's stock
learner started from seed s's slice (parameters, env state) with seed s's
draws, and the JAX vmapped learner's seed s from the same parameters, state and
draws (the JAX draws re-derived from seed s's key, as `test_torch_rec_ippo.py`
does for one seed), losses and parameters to rtol = atol = 1e-5. Each JAX
vmapped learner is compiled once for the file.
"""

import functools
import sys

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.advanced_usage import ff_ippo_vmap_seeds as jff_seeds
from mava_tpu.advanced_usage import rec_ippo_vmap_seeds as jrec_seeds
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import (
    common,
    ff_ippo_vmap_seeds,
    ff_mappo_vmap_seeds,
    rec_ippo_vmap_seeds,
    rec_mappo_vmap_seeds,
)
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from mava_tpu_torch.utils.training import SweptClippedAdam
from test_torch_rec_ippo import _prepare, _torch_timestep
from test_torch_rware import _to_torch_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = 2
FF = [
    "arch.num_envs=2",
    "system.rollout_length=8",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    "system.num_updates=1",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "env.kwargs.time_limit=50",
    "logger.use_console=False",
]
REC = FF[:5] + [
    "system.recurrent_chunk_size=4",
    "network.hidden_state_dim=16",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.actor_network.post_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.post_torso.layer_sizes=[16]",
    "env.kwargs.time_limit=50",
    "logger.use_console=False",
]
# system: (config, centralised, recurrent, port stacked module, port stock module)
SYSTEMS = {
    "ff_ippo": ("default_ff_ippo", False, False, ff_ippo_vmap_seeds, ff_ippo),
    "ff_mappo": ("default_ff_mappo", True, False, ff_ippo_vmap_seeds, ff_ippo),
    "rec_ippo": ("default_rec_ippo", False, True, rec_ippo_vmap_seeds, rec_ippo),
    "rec_mappo": ("default_rec_mappo", True, True, rec_ippo_vmap_seeds, rec_ippo),
}
CLIS = {
    "ff_ippo": (ff_ippo_vmap_seeds, "ff-IPPO vmap-seeds experiment completed."),
    "ff_mappo": (ff_mappo_vmap_seeds, "ff-MAPPO vmap-seeds experiment completed."),
    "rec_ippo": (rec_ippo_vmap_seeds, "rec-IPPO vmap-seeds experiment completed."),
    "rec_mappo": (rec_mappo_vmap_seeds, "rec-MAPPO vmap-seeds experiment completed."),
}


def _overrides(system):
    return REC if SYSTEMS[system][2] else FF


@functools.lru_cache(maxsize=None)
def _jax_vmapped(system):
    """The JAX vmapped learner's initial state, each seed's draws (from its own
    key, as the stock learner draws them) and its output after one update."""
    config_name, centralised, recurrent, _, _ = SYSTEMS[system]
    cfg = _prepare(jax_load_config(config_name, _overrides(system)))
    if recurrent:
        cfg.system.recurrent_chunk_size = 4
    env, _ = jenvs.make(cfg, add_global_state=centralised)
    module = jrec_seeds if recurrent else jff_seeds
    learn, _, state = module.learner_setup(
        env, jax.random.PRNGKey(3), cfg, make_mesh(jax.devices()[:1]), SEEDS, centralised)
    rows = cfg.arch.num_envs * cfg.system.rollout_length
    n = rows // cfg.system.recurrent_chunk_size if recurrent else rows
    noise, perms = [], []
    for s in range(SEEDS):
        key, sample_key = jax.random.split(state.key[s][0])
        noise.append(jax.random.gumbel(sample_key, (
            cfg.system.rollout_length, cfg.arch.num_envs, env.num_agents, env.action_dim)))
        _, shuffle_key = jax.random.split(key)
        perms.append(jax.numpy.argsort(jax.random.bits(
            shuffle_key, (cfg.system.ppo_epochs, n), dtype=jax.numpy.uint32), axis=1))
    out = jax.device_get(learn(state))
    return (jax.device_get(state), torch.tensor(np.stack(noise))[None],
            torch.tensor(np.stack(perms))[None], out)


def _entry(tree, s):
    return jax.tree.map(lambda x: x[s], tree)


def _flat_envs(tree):
    """(S, E, ...) -> (S * E, ...) for every leaf."""
    return jax.tree.map(lambda x: np.asarray(x).reshape(-1, *np.asarray(x).shape[2:]), tree)


def _port_config(system):
    config_name, _, recurrent, _, _ = SYSTEMS[system]
    cfg = _prepare(load_config(config_name, _overrides(system)))
    if recurrent:
        cfg.system.recurrent_chunk_size = 4
        cfg.network.gru_impl = "pallas"
    return cfg


def _load(stacked, s, params):
    with torch.no_grad():
        for name, value in from_flax_params(params).items():
            stacked.params[name][s].copy_(value)


def _assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


@pytest.mark.parametrize("system", ["ff_ippo", "ff_mappo"])
def test_stacked_update_matches_stock_and_jax_learners(system):
    check_stacked_update(system)


def check_stacked_update(system):
    """Seed s of one stacked update against the stock learner and the JAX
    vmapped learner (the recurrent systems: `test_torch_vmap_seeds_rec.py`,
    so that each file compiles two JAX learners)."""
    jstate, noise, perms, jout = _jax_vmapped(system)
    assert not np.any(jout.episode_metrics["episode_return"]), "a reward was earned"
    _, centralised, recurrent, stacked_module, stock_module = SYSTEMS[system]

    cfg = _port_config(system)
    env, _ = tenvs.make(cfg, "cpu", add_global_state=centralised)
    learn, _, state = stacked_module.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), SEEDS, centralised,
        noise=noise, permutations=perms)
    for stacked, jparams in zip(state.params, jstate.params):
        for s in range(SEEDS):
            _load(stacked, s, _entry(jparams, s))
    state = state._replace(env_state=_to_torch_state(_flat_envs(jstate.env_state)),
                           timestep=_torch_timestep(_flat_envs(jstate.timestep)))
    initial = [[p[s].detach().clone() for p in net.parameters()] for net in state.params
               for s in range(SEEDS)]
    out = learn(state)
    assert all(torch.isfinite(v).all() for v in out.train_metrics.values())

    for s in range(SEEDS):
        # The JAX vmapped learner's seed s.
        for name, values in jout.train_metrics.items():
            _assert_close(out.train_metrics[name][s].detach(), values[s], f"{system} {name} {s}")
        for net, jparams in zip(out.learner_state.params, jout.learner_state.params):
            want = from_flax_params(_entry(jparams, s))
            for name, p in net.params.items():
                _assert_close(p[s].detach(), want[name], f"{system} {name} seed {s}")
        # The port's stock learner from seed s's slice and draws.
        cfg_s = _port_config(system)
        stock_learn, _, stock = stock_module.learner_setup(
            env, torch.Generator().manual_seed(0), cfg_s, torch.device("cpu"), centralised,
            noise=noise[:, s], permutations=perms[:, s])
        for net, start in zip(stock.params, initial[s::SEEDS]):
            with torch.no_grad():
                for p, q in zip(net.parameters(), start):
                    p.copy_(q)
        stock = stock._replace(
            env_state=_to_torch_state(_entry(jstate.env_state, s)),
            timestep=_torch_timestep(_entry(jstate.timestep, s)))
        stock_out = stock_learn(stock)
        for name, values in stock_out.train_metrics.items():
            _assert_close(out.train_metrics[name][s, 0].detach(), values[0].detach(),
                          f"{system} {name} stock {s}")
        for net, stacked in zip(stock_out.learner_state.params, out.learner_state.params):
            for p, q in zip(net.parameters(), stacked.parameters()):
                _assert_close(q[s].detach(), p.detach(), f"{system} stock params {s}")
        if recurrent:
            for got, want in zip(out.learner_state.hstates, stock_out.learner_state.hstates):
                _assert_close(got[s], want, f"{system} hidden states {s}")
            for got, want in zip(out.learner_state.hstates, jout.learner_state.hstates):
                _assert_close(got[s], want[s], f"{system} hidden states vs JAX {s}")


def test_clip_is_per_seed():
    """Each entry is clipped by its own global norm: a huge gradient in one
    entry leaves another entry's step exactly the stock optimizer's."""
    torch.manual_seed(0)
    base = [torch.randn(3, 4), torch.randn(4)]
    stacked = [torch.stack([b.clone(), b.clone()]) for b in base]
    swept = SweptClippedAdam(stacked, [1e-3, 1e-3], max_grad_norm=0.5)
    stock_params = [b.clone() for b in base]
    stock = ff_ippo.make_optimizer(stock_params, 1e-3, 0.5)
    huge_params = [b.clone() for b in base]
    huge_stock = ff_ippo.make_optimizer(huge_params, 1e-3, 0.5)
    for t in range(3):
        small = [torch.full_like(b, 0.01 * (t + 1)) for b in base]
        huge = [torch.full_like(b, 1e6) for b in base]
        swept.step([torch.stack([h, g]) for h, g in zip(huge, small)])
        stock.step(small)
        huge_stock.step(huge)
    for p, q, r in zip(swept.params, stock_params, huge_params):
        assert torch.equal(p[1], q)  # untouched by entry 0's gradient
        assert torch.equal(p[0], r)  # clipped as its own


def test_one_seeds_state_leaves_the_others_update_untouched():
    """Seed 1's update is bitwise the same whether seed 0 starts from its own
    parameters or from parameters 1000 times as large (whose gradients the clip
    cuts): the losses, the advantage normalisation and the clip are per seed."""
    def update(scale):
        cfg = _port_config("ff_ippo")
        env, _ = tenvs.make(cfg, "cpu")
        learn, _, state = ff_ippo_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(1), cfg, torch.device("cpu"), SEEDS)
        with torch.no_grad():
            for net in state.params:
                for p in net.parameters():
                    p[0].mul_(scale)
        return learn(state)

    a, b = update(1.0), update(1000.0)
    for net_a, net_b in zip(a.learner_state.params, b.learner_state.params):
        for p, q in zip(net_a.parameters(), net_b.parameters()):
            assert torch.equal(p[1], q[1])
            assert not torch.equal(p[0], q[0])
    for name, values in a.train_metrics.items():
        assert torch.equal(values[1], b.train_metrics[name][1]), name


def test_seeds_draw_their_own_and_a_sweep_shares_its_draws():
    """Independent seeds start from different parameters and envs and draw
    their own noise; the entries of a sweep start and draw alike."""
    cfg = _port_config("rec_ippo")
    env, _ = tenvs.make(cfg, "cpu")
    for sweep_lrs in (None, [1e-4, 1e-3]):
        _, _, state = rec_ippo_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), SEEDS,
            sweep_lrs=sweep_lrs)
        draws = common.Draws(SEEDS, sweep_lrs is not None, torch.Generator().manual_seed(0),
                             "cpu")
        grid = state.env_state.env_state.agent_pos.reshape(SEEDS, -1)
        values = [state.params.actor_params.parameters()[0], grid,
                  draws.permutations(2, 16), draws.reset(env, 2).cell_uniform.reshape(SEEDS, -1)]
        same = [torch.equal(v[0], v[1]) for v in values]
        assert all(same) if sweep_lrs else not any(same), (sweep_lrs, same)
    assert common.entry_seeds(cfg, 3, shared=False) == [42, 43, 44]
    assert common.entry_seeds(cfg, 3, shared=True) == [42, 42, 42]


@pytest.mark.parametrize("system", sorted(CLIS))
def test_seed_shards_is_refused(system, fast_config_overrides):
    module, _ = CLIS[system]
    cfg = load_config(SYSTEMS[system][0], fast_config_overrides + [
        "+arch.device=cpu", "+system.seed_shards=2"])
    with pytest.raises(ValueError, match=r"seed_shards=2 must divide the device count \(1\)"):
        module.run_experiment(cfg)


@pytest.mark.parametrize("system", sorted(CLIS))
def test_cli_end_to_end(system, fast_config_overrides, monkeypatch, capsys):
    module, last_line = CLIS[system]
    monkeypatch.setattr(sys, "argv", [system, *fast_config_overrides, "env.kwargs.time_limit=16",
                                      "+arch.device=cpu", "+system.num_seeds=2",
                                      "+system.gae_impl=sequential"])
    performance = module.main()
    assert np.isfinite(performance)
    out = capsys.readouterr().out
    assert last_line in out and "final eval returns per seed: " in out


@pytest.mark.parametrize("system", ["ff_ippo", "rec_ippo"])
def test_runs_on_the_card_by_default(system, fast_config_overrides):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        CLIS[system][0].run_experiment(load_config(SYSTEMS[system][0], fast_config_overrides))
