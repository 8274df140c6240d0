"""rec-IQL of the port's stacked programs (`advanced_usage/rec_iql_vmap_{seeds,
sweep}.py`) against the port's stock learner and the JAX package's vmapped
learner (twins of `tests/test_vmap_seeds.py:153` and `test_vmap_sweep.py:316`).

The JAX vmapped learner of S = 2 seeds on RWARE tiny-2ag at small widths is
warmed up for a few updates (each ring of 7 wraps), then every entry's state
is loaded into the port (parameters, Adam moments and count, buffer, envs,
carries) and handed the draws of the next JAX update, recomputed from the
entry's keys. Entry s of one stacked update equals the JAX vmapped learner's
entry s and the port's stock learner from entry s's state and draws, to rtol =
atol = 1e-5, through the stacked GRU op (`gru_impl=pallas`: on CPU tensors its
plain versions). The JAX learner is compiled once for the file.
"""

import functools
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu.advanced_usage import rec_iql_vmap_seeds as jvs
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import rec_iql_vmap_seeds, rec_iql_vmap_sweep
from mava_tpu_torch.ops import gru
from mava_tpu_torch.replay import StackedTrajectoryBuffer, TrajectoryBuffer, TrajectoryBufferState
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.q_learning.types import Draws
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_rec_iql import TINY, WARMUP_UPDATES, _load_learner_state, _prepare, _update_draws

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = 2
CPU = torch.device("cpu")


def _entry(tree, s):
    return jax.tree.map(lambda x: x[s], tree)


@functools.lru_cache(maxsize=None)
def _jax_vmapped():
    """The JAX vmapped learner's state after the warm-up and its next update."""
    cfg = _prepare(jax_load_config("default_rec_iql", TINY))
    (jenv, _), _, update, jstate = jvs.learner_setup(cfg, make_mesh(jax.devices()[:1]), SEEDS)
    for _ in range(WARMUP_UPDATES):
        jstate, _ = update(jstate)
    jout = jax.device_get(update(jstate))  # on its own arrays: no second compile
    return cfg, jenv.unwrapped, jax.device_get(jstate), jout


def _port_config(overrides=()):
    cfg = _prepare(load_config("default_rec_iql", TINY + list(overrides) + ["+arch.device=cpu"]))
    cfg.network.gru_impl = "pallas"
    return cfg


def _stock_states_and_draws(cfg, env):
    """Each entry's port stock learner state loaded from the JAX entry, and the
    draws of its next update."""
    jcfg, unwrapped, jstate, jout = _jax_vmapped()
    buffer = rec_iql.make_buffer(cfg)
    full = bool(np.asarray(jstate.buffer_state.is_full)[0])
    size = cfg.system.buffer_size if full else int(np.asarray(jstate.buffer_state.current_index)[0])
    size = min(size + cfg.system.rollout_length, cfg.system.buffer_size)
    num_starts = max(size - buffer.sample_sequence_length + 1, 1)
    states, draws = [], []
    for s in range(SEEDS):
        _, _, state = rec_iql.learner_setup(env, torch.Generator().manual_seed(0), cfg, CPU)
        states.append(_load_learner_state(state, _entry(jstate, s)))
        draws.append(_update_draws(_entry(jstate, s), _entry(jout, s), jcfg, unwrapped, buffer,
                                   num_starts))
    return states, draws


def _stacked_draws(draws):
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    return Draws(
        action_noise=torch.stack([d.action_noise for d in draws]),
        env_noise=[pytree.tree_map(cat, *steps) for steps in zip(*[d.env_noise for d in draws])],
        rows=torch.stack([d.rows for d in draws]),
        starts=torch.stack([d.starts for d in draws]),
    )


@torch.no_grad()
def stack_states(state, stocks):
    """The stacked learner state holding each stock state as its entry:
    parameters, Adam moments and count, rings, envs, flags, carries, counters."""
    for stacked, nets in zip(state.params, zip(*[st.params for st in stocks])):
        for s, net in enumerate(nets):
            for name, value in net.named_parameters():
                stacked.params[name][s].copy_(value)
    for s, stock in enumerate(stocks):
        for moments, stock_moments in ((state.opt_state.mu, stock.opt_state.mu),
                                       (state.opt_state.nu, stock.opt_state.nu)):
            for m, v in zip(moments, stock_moments):
                m[s].copy_(v)
    state.opt_state.count = stocks[0].opt_state.count
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    first = stocks[0].buffer_state
    return state._replace(
        obs=pytree.tree_map(cat, *[st.obs for st in stocks]),
        terminal=cat(*[st.terminal for st in stocks]),
        term_or_trunc=cat(*[st.term_or_trunc for st in stocks]),
        hidden_state=torch.stack([st.hidden_state for st in stocks]),
        env_state=pytree.tree_map(cat, *[st.env_state for st in stocks]),
        time_steps=stocks[0].time_steps, train_steps=stocks[0].train_steps,
        buffer_state=TrajectoryBufferState(
            pytree.tree_map(lambda *xs: torch.stack(xs),
                            *[st.buffer_state.experience for st in stocks]),
            first.current_index, first.is_full),
    )


def _stacked_update(overrides=(), sweep_lrs=None):
    """One stacked update from the JAX entries' states and draws, and the
    stock states and draws it was built from."""
    cfg = _port_config(overrides)
    env, _ = tenvs.make(cfg, CPU)
    stocks, draws = _stock_states_and_draws(cfg, env)
    learn, _, state = rec_iql_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, sweep_lrs,
        draws=[_stacked_draws(draws)])
    return learn(stack_states(state, stocks)), stocks, draws, env


def _numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, what):
    np.testing.assert_allclose(_numpy(got), _numpy(want), err_msg=what, **TOL)


def test_stacked_update_matches_jax_vmapped_and_stock_learners():
    out, stocks, draws, env = _stacked_update()
    _, _, _, (jnew, (jmetrics, jlosses)) = _jax_vmapped()
    new = out.learner_state
    for s in range(SEEDS):
        for name, values in jlosses.items():  # (S, updates, epochs)
            _assert_close(out.train_metrics[name][s], values[s], f"{name} {s}")
        for net, jparams in zip(new.params, (jnew.params.online, jnew.params.target)):
            want = from_flax_params(_entry(jparams, s), head="q_head")
            for name, p in net.params.items():
                _assert_close(p[s], want[name], f"{name} {s}")
        _assert_close(new.hidden_state[s], jnew.hidden_state[s], f"hidden {s}")
        np.testing.assert_array_equal(new.buffer_state.experience.action[s].numpy(),
                                      np.asarray(jnew.buffer_state.experience.action[s]))
        # The port's stock learner from entry s's state and draws.
        cfg = _port_config()
        stock_learn, _, _ = rec_iql.learner_setup(env, torch.Generator().manual_seed(0), cfg, CPU,
                                                  draws=[draws[s]])
        stock = stock_learn(stocks[s])
        for name, values in stock.train_metrics.items():
            _assert_close(out.train_metrics[name][s], values, f"{name} stock {s}")
        for net, stock_net in zip(new.params, stock.learner_state.params):
            for name, p in stock_net.named_parameters():
                _assert_close(net.params[name][s].detach(), p.detach(), f"{name} stock {s}")
        _assert_close(new.hidden_state[s], stock.learner_state.hidden_state, f"hidden stock {s}")
    assert new.time_steps == int(np.ravel(jnew.time_steps)[0])
    assert new.train_steps == int(np.ravel(jnew.train_steps)[0])
    assert new.buffer_state.current_index == int(np.asarray(jnew.buffer_state.current_index)[0])
    for k, v in jmetrics.items():  # (S, updates, rollout, E) against (updates, rollout, S * E)
        _assert_close(out.episode_metrics[k].reshape(1, -1, SEEDS, 2).movedim(2, 0), v, k)


def test_unfused_target_pass_gives_the_same_update():
    """`system.fused_target_pass=False` (two stacked passes over S) against the
    fused pass over 2S, from the same state and draws."""
    fused, _, _, _ = _stacked_update()
    unfused, _, _, _ = _stacked_update(["system.fused_target_pass=False"])
    for name, values in fused.train_metrics.items():
        _assert_close(unfused.train_metrics[name], values, name)
    for a, b in zip(fused.learner_state.params, unfused.learner_state.params):
        for p, q in zip(a.parameters(), b.parameters()):
            _assert_close(q.detach(), p.detach(), "params")


def test_sweep_entry_matches_the_stock_learner_at_its_lr():
    """Entry i of a sweep (every entry entry 0's state and draws) is the stock
    learner at q_lr = sweep_lrs[i] (twin of `test_vmap_sweep.py:316`)."""
    lrs = [1e-4, 1e-3]
    cfg = _port_config()
    env, _ = tenvs.make(cfg, CPU)
    stocks, draws = _stock_states_and_draws(cfg, env)
    learn, _, state = rec_iql_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, lrs,
        draws=[_stacked_draws([draws[0]] * SEEDS)])
    state = stack_states(state, [stocks[0]] * SEEDS)
    assert state.opt_state.peak_lr.tolist() == lrs
    out = learn(state)
    for i, lr in enumerate(lrs):
        cfg_i = _port_config([f"system.q_lr={lr}"])
        stock_learn, _, fresh = rec_iql.learner_setup(env, torch.Generator().manual_seed(0),
                                                      cfg_i, CPU, draws=[draws[0]])
        stock = _stock_states_and_draws(cfg_i, env)[0][0]
        assert stock.opt_state.lr == lr
        got = stock_learn(stock)
        for net, stock_net in zip(out.learner_state.params, got.learner_state.params):
            for name, p in stock_net.named_parameters():
                _assert_close(net.params[name][i].detach(), p.detach(), f"{name} lr {lr}")
    p = out.learner_state.params.online.parameters()[0]
    assert not torch.equal(p[0], p[1])


def test_one_entrys_state_leaves_the_others_update_untouched():
    """Entry 1's update is bitwise the same whether entry 0 starts from its own
    parameters or from parameters 1000 times as large: the losses, the clip and
    the Adam steps are per entry."""
    def update(scale):
        cfg = _port_config()
        env, _ = tenvs.make(cfg, CPU)
        learn, _, state = rec_iql_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(1), cfg, CPU, SEEDS)
        with torch.no_grad():
            for net in state.params:
                for p in net.parameters():
                    p[0].mul_(scale)
        for _ in range(3):  # past the ring's first sequence
            out = learn(state)
            state = out.learner_state
        return out

    a, b = update(1.0), update(1000.0)
    for net_a, net_b in zip(a.learner_state.params, b.learner_state.params):
        for p, q in zip(net_a.parameters(), net_b.parameters()):
            assert torch.equal(p[1], q[1]) and not torch.equal(p[0], q[0])
    for name, values in a.train_metrics.items():
        assert torch.equal(values[1], b.train_metrics[name][1]), name


def test_update_makes_the_stacked_gru_calls_of_one_stock_update(monkeypatch):
    """At epochs = 2 an update runs the stacked GRU op 4 times forward (two
    fused target passes over 2S, two loss passes over S) and twice backward
    (over S), and the unstacked op never: on the card, 4 stacked K1 and 2 of
    each stacked backward kernel. The T = 1 act steps take the plain loop."""
    calls = {"fwd": [], "bwd": [], "unstacked": 0}
    fwd, bwd, unstacked = (gru.gru_sequence_stacked_forward, gru.gru_sequence_stacked_backward,
                           gru.gru_sequence)
    monkeypatch.setattr(gru, "gru_sequence_stacked_forward",
                        lambda *a: calls["fwd"].append(a[0].shape[0]) or fwd(*a))
    monkeypatch.setattr(gru, "gru_sequence_stacked_backward",
                        lambda *a: calls["bwd"].append(a[0].shape[0]) or bwd(*a))

    def count_unstacked(*a):
        calls["unstacked"] += 1
        return unstacked(*a)

    from mava_tpu_torch.networks import actor_critic
    monkeypatch.setattr(actor_critic, "gru_sequence", count_unstacked)
    for fused, stacks in ((True, [2 * SEEDS, SEEDS] * 2), (False, [SEEDS] * 6)):
        calls.update(fwd=[], bwd=[])
        cfg = _port_config([f"system.fused_target_pass={fused}"])
        env, _ = tenvs.make(cfg, CPU)
        learn, _, state = rec_iql_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS)
        learn(state)
        assert calls["fwd"] == stacks and calls["bwd"] == [SEEDS, SEEDS], (fused, calls)
    assert calls["unstacked"] == 0


@pytest.mark.parametrize("entries", [1, 3])
def test_stacked_buffer_is_one_allocation_and_each_entry_a_stock_ring(entries):
    """The stacked ring is allocated once, (S, ...) on the dummy's device, and
    each entry adds and samples exactly as a stock buffer of its own."""
    kw = dict(sample_sequence_length=3, period=1, add_batch_size=2, sample_batch_size=5,
              max_length_time_axis=7, min_length_time_axis=4)
    stacked, stock = StackedTrajectoryBuffer(entries, **kw), TrajectoryBuffer(**kw)
    dummy = {"x": torch.zeros(3), "m": torch.zeros(2, dtype=torch.bool)}
    state = stacked.init(dummy)
    for name, leaf in state.experience.items():
        assert leaf.shape == (entries, 2, 7, *dummy[name].shape) and leaf.is_contiguous()
        assert leaf.device == dummy[name].device and not leaf.any()
    singles = [stock.init(dummy) for _ in range(entries)]
    gen = torch.Generator().manual_seed(0)
    draw = lambda fn, shape: fn((entries, *shape), gen, "cpu")  # noqa: E731
    for t_add in (2, 1, 3, 4, 2):
        batch = {"x": torch.randn(entries, 2, t_add, 3, generator=gen),
                 "m": torch.rand(entries, 2, t_add, 2, generator=gen) < 0.5}
        state = stacked.add(state, batch)
        singles = [stock.add(st, {k: v[s] for k, v in batch.items()})
                   for s, st in enumerate(singles)]
        rows, starts = stacked.sample_indices(state, draw)
        got = stacked.sample(state, rows, starts)
        for s, single in enumerate(singles):
            assert (state.current_index, state.is_full) == (single.current_index, single.is_full)
            want = stock.sample(single, rows[s], starts[s])
            for name in dummy:
                assert torch.equal(got[name][s], want[name])
                assert torch.equal(state.experience[name][s], single.experience[name])


CLIS = {"seeds": (rec_iql_vmap_seeds, "rec-IQL vmap-seeds experiment completed.",
                  ["+system.num_seeds=2"], "vmap-seeds final eval returns per seed: "),
        "sweep": (rec_iql_vmap_sweep, "rec-IQL vmap-lr-sweep experiment completed.",
                  ["+system.sweep_lrs=[1e-4, 1e-3]"], "vmap-sweep final eval returns per lr: ")}
CLI = ["system.num_updates=2", "arch.num_evaluation=1", "arch.num_envs=2",
       "arch.num_eval_episodes=2", "system.sample_batch_size=4", "network.hidden_state_dim=16",
       "system.sample_sequence_length=6"]


@pytest.mark.parametrize("program", sorted(CLIS))
def test_cli_end_to_end(program, monkeypatch, capsys):
    module, last_line, extra, per_entry = CLIS[program]
    monkeypatch.setattr(sys, "argv", [program, *CLI, "env=smax", "env/scenario=2s3z",
                                      "+env.kwargs.time_limit=16", "+arch.device=cpu", *extra])
    performance = module.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    out, logged = captured.out, captured.out + captured.err
    assert out.rstrip().endswith(last_line) and per_entry in out
    # The reference's EVAL keys and no others: no win rate on SMAX either.
    assert "Seed return best" in logged and "Win rate" not in logged and "win rates" not in out


@pytest.mark.parametrize("program", sorted(CLIS))
def test_runs_on_the_card_by_default(program):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    module, _, extra, _ = CLIS[program]
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        module.run_experiment(load_config("default_rec_iql", CLI + extra))


def test_seed_shards_is_refused():
    cfg = load_config("default_rec_iql", CLI + ["+arch.device=cpu", "+system.seed_shards=2"])
    with pytest.raises(ValueError, match=r"seed_shards=2 must divide the device count \(1\)"):
        rec_iql_vmap_seeds.run_experiment(cfg)
