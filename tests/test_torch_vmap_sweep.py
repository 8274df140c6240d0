"""The port's learning-rate sweeps (`mava_tpu_torch/advanced_usage/*_vmap_sweep.py`)
and their optimizer (twins of `tests/test_vmap_sweep.py:46,71,151,394`).

1. `SweptClippedAdam` (the lr in the optimizer's state, one entry per lr) is
   bitwise the stock `ClippedAdam` at each entry's lr, constant and decayed.
2. Entry i of a stacked sweep update equals the port's stock learner at
   `sweep_lrs[i]` started from the same state with the same draws
   (rtol = atol = 1e-5), feed-forward and recurrent; the entries share their
   init and envs and diverge by their lr alone.
3. `parse_sweep_lrs` reads what the reference's reads.
"""

import sys

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs as jax_parse_sweep_lrs
from mava_tpu.utils.config import Config as JaxConfig
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import (
    common,
    ff_ippo_vmap_seeds,
    ff_ippo_vmap_sweep,
    ff_mappo_vmap_sweep,
    rec_ippo_vmap_seeds,
    rec_ippo_vmap_sweep,
    rec_mappo_vmap_sweep,
)
from mava_tpu_torch.distributions import gumbel
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import (
    make_learning_rate,
    make_learning_rate_schedule,
    make_optimizer,
    make_swept_optimizer,
    set_peak_lr,
)
from test_torch_vmap_seeds import FF, REC, _prepare

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SWEEP_LRS = [1e-4, 1e-3]
CLIS = {
    "ff_ippo": (ff_ippo_vmap_sweep, "default_ff_ippo", "ff-IPPO vmap-lr-sweep experiment completed."),
    "ff_mappo": (ff_mappo_vmap_sweep, "default_ff_mappo",
                 "ff-MAPPO vmap-lr-sweep experiment completed."),
    "rec_ippo": (rec_ippo_vmap_sweep, "default_rec_ippo",
                 "rec-IPPO vmap-lr-sweep experiment completed."),
    "rec_mappo": (rec_mappo_vmap_sweep, "default_rec_mappo",
                  "rec-MAPPO vmap-lr-sweep experiment completed."),
}


def _toy_config(decay: bool) -> Config:
    return Config.from_dict({"system": {"ppo_epochs": 2, "num_minibatches": 2, "num_updates": 3,
                                        "decay_learning_rates": decay}})


@pytest.mark.parametrize("decay", [False, True], ids=["constant", "decayed"])
def test_swept_optimizer_bitwise_matches_stock(decay):
    cfg = _toy_config(decay)
    lrs = [2.5e-4, 1e-3, 3e-3]
    base = [torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7.0, torch.linspace(-1, 1, 5)]
    stacked = [torch.stack([b.clone() for _ in lrs]) for b in base]
    swept = make_swept_optimizer(stacked, cfg, 0.5, lrs)
    stock = [[b.clone() for b in base] for _ in lrs]
    opts = [make_optimizer(p, make_learning_rate(lr, cfg), 0.5) for p, lr in zip(stock, lrs)]
    for t in range(15):  # past the 12-update decay horizon; clipped and unclipped steps
        grads = [torch.sin(torch.arange(6, dtype=torch.float32).reshape(2, 3) + t),
                 torch.cos(torch.linspace(0, 3, 5) * t) * (10.0 if t % 2 else 0.01)]
        for opt in opts:
            opt.step(grads)
        swept.step([torch.stack([g] * len(lrs)) for g in grads])
    for s in range(len(lrs)):
        for p, q in zip(swept.params, stock[s]):
            assert torch.equal(p[s], q), (decay, lrs[s])


def test_swept_schedule_reaches_zero_and_set_peak_lr():
    cfg = _toy_config(True)
    assert make_learning_rate_schedule(1e-3, cfg)(12) == 0.0
    swept = make_swept_optimizer([torch.ones(2, 3)], cfg, 10.0, 1e-3)
    assert swept.peak_lr.tolist() == [1e-3, 1e-3] and swept.peak_lr.dtype == torch.float64
    for _ in range(20):
        swept.step([torch.ones(2, 3)])
    assert torch.equal(swept.learning_rates(), torch.zeros(2))
    set_peak_lr(swept, [1e-4, 2e-4])
    assert swept.peak_lr.tolist() == [1e-4, 2e-4]


def _sweep_entries_match_stock(recurrent: bool):
    overrides = (REC if recurrent else FF) + ["arch.num_envs=2"]
    config_name = "default_rec_ippo" if recurrent else "default_ff_ippo"
    cfg = _prepare(load_config(config_name, overrides))
    if recurrent:
        cfg.system.recurrent_chunk_size = 4
        cfg.network.gru_impl = "pallas"
    env, _ = tenvs.make(cfg, "cpu")
    cfg.system.num_agents = env.num_agents
    e, t_len = cfg.arch.num_envs, cfg.system.rollout_length
    # One entry's draws, shared by the sweep's entries as its own draws would be.
    draws = common.Draws(len(SWEEP_LRS), True, torch.Generator().manual_seed(5), "cpu")
    n = e * t_len // (cfg.system.recurrent_chunk_size if recurrent else 1)
    inject = dict(noise=draws(gumbel, (t_len, e, env.num_agents, env.action_dim))[None],
                  permutations=draws.permutations(cfg.system.ppo_epochs, n)[None])
    if recurrent:
        inject["env_noise"] = [[draws.env(env, e) for _ in range(t_len)]]
    module = rec_ippo_vmap_seeds if recurrent else ff_ippo_vmap_seeds
    learn, _, state = module.learner_setup(env, torch.Generator().manual_seed(0), cfg,
                                           torch.device("cpu"), len(SWEEP_LRS),
                                           sweep_lrs=SWEEP_LRS, **inject)
    # Shared init: every entry starts from the same parameters and envs.
    for net in state.params:
        for p in net.parameters():
            assert torch.equal(p[0], p[1])
    rows = lambda tree: pytree.tree_map(  # noqa: E731
        lambda x: x[:e].clone() if isinstance(x, torch.Tensor) and x.dim() else x, tree)
    start = [[p[0].detach().clone() for p in net.parameters()] for net in state.params]
    envs = rows((state.env_state, state.timestep))
    out = learn(state)
    assert not out.episode_metrics["episode_return"].any(), "a reward was earned"

    for s, lr in enumerate(SWEEP_LRS):
        cfg_s = _prepare(load_config(config_name, overrides + [
            f"system.actor_lr={lr}", f"system.critic_lr={lr}"]))
        if recurrent:
            cfg_s.system.recurrent_chunk_size = 4
            cfg_s.network.gru_impl = "pallas"
        stock_module = rec_ippo if recurrent else ff_ippo
        extra = {"env_noise": [[rows(x) for x in inject["env_noise"][0]]]} if recurrent else {}
        stock_learn, _, stock = stock_module.learner_setup(
            env, torch.Generator().manual_seed(0), cfg_s, torch.device("cpu"),
            noise=inject["noise"][:, s], permutations=inject["permutations"][:, s], **extra)
        with torch.no_grad():
            for net, init in zip(stock.params, start):
                for p, q in zip(net.parameters(), init):
                    p.copy_(q)
        got = stock_learn(stock._replace(env_state=envs[0], timestep=envs[1]))
        for name, values in got.train_metrics.items():
            np.testing.assert_allclose(out.train_metrics[name][s, 0].numpy(), values[0].numpy(),
                                       err_msg=f"{name} lr={lr}", **TOL)
        for net, stacked in zip(got.learner_state.params, out.learner_state.params):
            for p, q in zip(net.parameters(), stacked.parameters()):
                np.testing.assert_allclose(q[s].detach().numpy(), p.detach().numpy(),
                                           err_msg=f"lr={lr}", **TOL)
    # The lr does something: the entries diverged.
    assert any(not torch.equal(p[0], p[1]) for p in out.learner_state.params[0].parameters())


def test_vmap_sweep_entry_matches_stock_learner_at_that_lr():
    _sweep_entries_match_stock(recurrent=False)


def test_rec_vmap_sweep_entry_matches_stock_learner_at_that_lr():
    _sweep_entries_match_stock(recurrent=True)


@pytest.mark.parametrize("raw", [["1e-4", "3e-4", 0.001], "1e-4, 3e-4", "[1e-4,2e-4]", None])
def test_parse_sweep_lrs_accepts_yaml_list_and_comma_string(raw):
    system = {} if raw is None else {"sweep_lrs": raw}
    got = ff_ippo_vmap_sweep.parse_sweep_lrs(Config.from_dict({"system": system}))
    assert got == jax_parse_sweep_lrs(JaxConfig.from_dict({"system": system}))
    assert len(got) == (4 if raw is None else len(got))


@pytest.mark.parametrize("system", sorted(CLIS))
def test_cli_end_to_end(system, fast_config_overrides, monkeypatch, capsys):
    module, _, last_line = CLIS[system]
    monkeypatch.setattr(sys, "argv", [system, *fast_config_overrides, "env.kwargs.time_limit=16",
                                      "+arch.device=cpu", "+system.sweep_lrs=[1e-4, 1e-3]"])
    performance = module.main()
    assert np.isfinite(performance)
    out = capsys.readouterr().out
    assert last_line in out and "vmap-sweep final eval returns per lr: lr=0.0001:" in out


@pytest.mark.parametrize("sweep_lrs", [None, SWEEP_LRS], ids=["seeds", "sweep"])
def test_stagger_resets_per_seed_or_shared_by_a_sweep(sweep_lrs, fast_config_overrides):
    """`arch.stagger_resets` (ff programs): each seed its own burn-in offsets;
    a sweep's entries one entry's offsets, as the reference tiles them."""
    cfg = _prepare(load_config("default_ff_ippo", fast_config_overrides + [
        "env.kwargs.time_limit=16", "arch.num_envs=8", "arch.stagger_resets=True"]))
    env, _ = tenvs.make(cfg, "cpu")
    _, _, state = ff_ippo_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), 2, sweep_lrs=sweep_lrs)
    counts = state.env_state.env_state.step_count.reshape(2, 8)
    assert len(set(counts.flatten().tolist())) > 2  # desynchronised envs
    assert torch.equal(counts[0], counts[1]) == (sweep_lrs is not None)
