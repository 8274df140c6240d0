"""The port's PBT programs (`mava_tpu_torch/advanced_usage/{ff,rec}_ippo_pbt.py`),
twins of `tests/test_pbt.py:55-170`.

The exploit/explore step works in place on a stacked population: the bottom
`frac` of the members take a top member's parameters and optimizer state
(Adam moments and peak learning rate) with a perturbed lr; the survivors,
every top member among them, stay bit for bit; the perturbation stays in its
bounds. Then the rank metric, the rec PBT CLI on SMAX, the fixed-lr control and
the refusal of `system.seed_shards`.
"""

import sys

import numpy as np
import pytest
import torch
from torch import nn

from mava_tpu.advanced_usage.ff_ippo_pbt import resolve_rank_metric as jax_resolve_rank_metric
from mava_tpu.utils.config import Config as JaxConfig
from mava_tpu_torch.advanced_usage import ff_ippo_pbt, rec_ippo_pbt
from mava_tpu_torch.advanced_usage.ff_ippo_pbt import pbt_exploit_explore, resolve_rank_metric
from mava_tpu_torch.networks import StackedNetwork
from mava_tpu_torch.systems.ppo.types import OptStates, Params
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import SweptClippedAdam

torch.set_num_threads(1)


def _population(pop=8, seed=0):
    torch.manual_seed(seed)
    actor = StackedNetwork([nn.Linear(3, 2) for _ in range(pop)])
    critic = StackedNetwork([nn.Linear(3, 1) for _ in range(pop)])
    lrs = np.linspace(1e-4, 1e-3, pop)
    opts = OptStates(SweptClippedAdam(actor.parameters(), lrs, 0.5),
                     SweptClippedAdam(critic.parameters(), lrs, 0.5))
    for opt in opts:  # moments that differ from member to member
        opt.step([torch.randn_like(p) for p in opt.params])
    return Params(actor, critic), opts, lrs


def _snapshot(params, opts):
    return ([p.detach().clone() for net in params for p in net.parameters()],
            [m.clone() for opt in opts for m in (*opt.mu, *opt.nu)])


def test_exploit_copies_top_into_bottom_and_survivors_untouched():
    pop = 8
    params, opts, lrs = _population(pop)
    before_params, before_moments = _snapshot(params, opts)
    returns = np.arange(pop, dtype=np.float32)  # member i has return i
    src, factors = pbt_exploit_explore(params, opts, returns, torch.Generator().manual_seed(1),
                                       frac=0.25, perturb=(0.8, 1.25))
    k = pop // 4
    bottom, top = list(range(k)), list(range(pop - k, pop))
    for i in range(pop):
        assert src[i] in top if i in bottom else src[i] == i
    after_params, after_moments = _snapshot(params, opts)
    for before, after in ((before_params, after_params), (before_moments, after_moments)):
        for b, a in zip(before, after):
            for i in range(pop):
                assert torch.equal(a[i], b[src[i]])  # copied, or left bit for bit
    new_lrs = opts.actor_opt_state.peak_lr.numpy()
    np.testing.assert_array_equal(new_lrs, opts.critic_opt_state.peak_lr.numpy())
    for i in range(pop):
        base = lrs[src[i]]
        if i in bottom:
            assert 0.8 * base - 1e-12 <= new_lrs[i] <= 1.25 * base + 1e-12
            assert factors[i] != 1.0
        else:
            assert new_lrs[i] == base


def test_explore_perturbs_only_copied_members():
    pop = 4
    params, opts, lrs = _population(pop, seed=3)
    returns = np.array([5.0, 1.0, 3.0, 4.0], dtype=np.float32)  # member 1 worst
    src, factors = pbt_exploit_explore(params, opts, returns, torch.Generator().manual_seed(2),
                                       frac=0.25, perturb=(0.5, 2.0))
    assert src[1] == 0  # k = 1: the single worst copies the single best
    assert all(src[i] == i for i in (0, 2, 3))
    assert 0.5 <= factors[1] <= 2.0 and factors[1] != 1.0
    np.testing.assert_array_equal(factors[[0, 2, 3]], np.ones(3))
    np.testing.assert_allclose(opts.actor_opt_state.peak_lr.numpy(),
                               lrs[src] * factors, rtol=0, atol=0)


def test_overlapping_fractions_are_refused():
    params, opts, _ = _population(4)
    with pytest.raises(ValueError, match="overlap"):
        pbt_exploit_explore(params, opts, np.arange(4.0), torch.Generator(), frac=0.75)


@pytest.mark.parametrize("env", [{"eval_metric": "win_rate"}, {"eval_metric": "episode_return"},
                                 {}])
def test_resolve_rank_metric_maps_win_rate_to_won_episode(env):
    got = resolve_rank_metric(Config.from_dict({"env": env}))
    assert got == jax_resolve_rank_metric(JaxConfig.from_dict({"env": env}))
    assert got == ("won_episode" if env.get("eval_metric") == "win_rate" else "episode_return")


def test_rec_pbt_end_to_end_on_win_rate_env(fast_config_overrides, monkeypatch, capsys):
    """rec-PBT on SMAX (the env whose headline metric is the win rate) through
    `main`: evaluator output, rank metric, one exploit/explore step."""
    steps = []
    real = ff_ippo_pbt.pbt_exploit_explore
    monkeypatch.setattr(ff_ippo_pbt, "pbt_exploit_explore",
                        lambda *a, **k: steps.append(1) or real(*a, **k))
    monkeypatch.setattr(sys, "argv", ["rec_ippo_pbt", *fast_config_overrides, "env=smax",
                                      "env.scenario=2s3z", "system.recurrent_chunk_size=2",
                                      "arch.num_evaluation=2", "+system.pbt_population=4",
                                      "+arch.device=cpu"])
    perf = rec_ippo_pbt.main()
    assert isinstance(perf, float) and 0.0 <= perf <= 1.0  # a win fraction
    assert steps == [1]  # between the two evaluations, not after the last
    out = capsys.readouterr().out
    assert "rec PBT final: best member" in out and "rec-IPPO PBT experiment completed." in out


def test_ff_pbt_fixed_lr_control(fast_config_overrides, monkeypatch):
    """`+system.pbt_exploit=False`: the same population and evaluations with no
    exploit/explore step, the fixed-lr control arm."""
    def refuse(*args, **kwargs):
        raise AssertionError("exploit/explore ran in the control arm")

    monkeypatch.setattr(ff_ippo_pbt, "pbt_exploit_explore", refuse)
    cfg = load_config("default_ff_ippo", fast_config_overrides + [
        "arch.num_evaluation=2", "+system.pbt_population=4", "+system.pbt_exploit=False",
        "env.kwargs.time_limit=16", "+arch.device=cpu"])
    assert isinstance(ff_ippo_pbt.run_experiment(cfg), float)


@pytest.mark.parametrize("module", [ff_ippo_pbt, rec_ippo_pbt], ids=["ff", "rec"])
def test_pbt_rejects_seed_shards(module):
    cfg = load_config("default_ff_ippo", ["+system.seed_shards=2", "logger.use_console=False",
                                          "+arch.device=cpu"])
    with pytest.raises(ValueError, match="seed_shards=2 is not supported by the PBT programs"):
        module.run_experiment(cfg)
