"""ff-ISAC of the port's stacked programs (`advanced_usage/ff_isac_vmap_{seeds,
sweep}.py`) against the port's stock learner and the JAX package's vmapped
learner (twins of `tests/test_vmap_seeds.py:95` and `test_vmap_sweep.py:223,
245`); ff-MASAC's half is `test_torch_masac_vmap.py`.

The JAX vmapped learner of S = 2 seeds on MaSwarm at small widths runs its
explore phase, one warm-up update (each ring of 7 items wraps) and the update
held here. The port's stacked explore phase runs from the JAX entries' first
states with their Uniform[-1, 1] actions, recomputed from each entry's keys,
and must leave the JAX learner's buffers, observations and step count. Then
every entry's state after the warm-up is loaded into the port (parameters,
`log_alpha`, the three Adam states, the ring, the envs) and handed the draws
of the next JAX update: entry s of one stacked update equals the JAX vmapped
learner's entry s and the port's stock learner from entry s's state and draws,
to rtol = atol = 1e-5. The JAX learner is compiled once for the file.
"""

import functools
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu.advanced_usage import ff_isac_vmap_seeds as jvs
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import (
    common,
    ff_isac_vmap_seeds,
    ff_isac_vmap_sweep,
    ff_masac_vmap_seeds,
    ff_masac_vmap_sweep,
)
from mava_tpu_torch.envs.maswarm import MaSwarmResetNoise
from mava_tpu_torch.replay import ItemBuffer, ItemBufferState, StackedItemBuffer
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.systems.sac.types import Draws
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from mava_tpu_torch.utils.training import ClippedAdam, make_swept_adam
from test_torch_maswarm import auto_reset_draws, to_torch_state
from test_torch_sac import TINY, _adam_states, _adam_values, _load_learner_state, _prepare, _t
from test_torch_sac import _update_draws

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = 2
CPU = torch.device("cpu")
SYSTEMS = {False: "default_ff_isac", True: "default_ff_masac"}


def _entry(tree, s):
    return jax.tree.map(lambda x: x[s], tree)


def _numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, what):
    np.testing.assert_allclose(_numpy(got), _numpy(want), err_msg=what, **TOL)


def jax_vmapped(centralised, overrides=()):
    """The JAX vmapped learner's first state, its explore phase, the state after
    a warm-up update and the output of the next one, compiled once a config."""
    return _jax_vmapped(centralised, tuple(overrides))


def _jax_learner(centralised, overrides=()):
    cfg = _prepare(jax_load_config(SYSTEMS[centralised], TINY + list(overrides)))
    (jenv, _), _, fns, state, _ = jvs.learner_setup(cfg, make_mesh(jax.devices()[:1]), SEEDS,
                                                    centralised)
    return cfg, jenv.unwrapped, fns, state


@functools.lru_cache(maxsize=None)
def _jax_explored(centralised):
    """The shipped config's learner, first state and explore phase (its arrays
    kept on the device, so that an update compiled for them is reused)."""
    cfg, unwrapped, (explore, update), state = _jax_learner(centralised)
    return cfg, unwrapped, update, jax.device_get(state), explore(state)


@functools.lru_cache(maxsize=None)
def _jax_vmapped(centralised, overrides):
    # An override here leaves the explore phase as shipped (the reward scale
    # scales only the TD target), so only the update is compiled for it.
    cfg, unwrapped, update, first, explored = _jax_explored(centralised)
    if overrides:
        cfg, _, (_, update), _ = _jax_learner(centralised, overrides)
    warm, _ = update(explored[0])
    out = jax.device_get(update(warm))
    return cfg, unwrapped, first, jax.device_get(explored), jax.device_get(warm), out


def port_config(centralised, overrides=()):
    return _prepare(load_config(SYSTEMS[centralised], TINY + list(overrides) + ["+arch.device=cpu"]))


def _cat(*xs):
    return torch.cat(xs)


@torch.no_grad()
def stack_states(state, stocks):
    """The stacked learner state holding each stock state as its entry:
    parameters, `log_alpha`, Adam moments and counts, rings, envs, t."""
    nets = lambda p: (p.actor, *p.q.online, *p.q.targets)  # noqa: E731
    for stacked, singles in zip(nets(state.params), zip(*[nets(st.params) for st in stocks])):
        for s, net in enumerate(singles):
            for name, value in net.named_parameters():
                stacked.params[name][s].copy_(value)
    for s, stock in enumerate(stocks):
        state.params.log_alpha[s].copy_(stock.params.log_alpha)
        for opt, stock_opt in zip(state.opt_states, stock.opt_states):
            for moments, stock_moments in ((opt.mu, stock_opt.mu), (opt.nu, stock_opt.nu)):
                for m, v in zip(moments, stock_moments, strict=True):
                    m[s].copy_(v)
            opt.count = stock_opt.count
    first = stocks[0].buffer_state
    return state._replace(
        obs=pytree.tree_map(_cat, *[st.obs for st in stocks]),
        env_state=pytree.tree_map(_cat, *[st.env_state for st in stocks]),
        t=stocks[0].t,
        buffer_state=ItemBufferState(
            pytree.tree_map(lambda *xs: torch.stack(xs),
                            *[st.buffer_state.experience for st in stocks]),
            first.current_index, first.is_full),
    )


def stacked_draws(draws):
    """Each entry's `Draws` as one with the entry axis in front."""
    stack = lambda name: torch.stack([getattr(d, name) for d in draws])  # noqa: E731
    env_noise = [(None, pytree.tree_map(_cat, *[step[1] for step in steps]))
                 for steps in zip(*[d.env_noise for d in draws])]
    return Draws(act_noise=stack("act_noise"), rows=stack("rows"), q_noise=stack("q_noise"),
                 actor_noise=stack("actor_noise"), alpha_noise=stack("alpha_noise"),
                 env_noise=env_noise)


def stock_states_and_draws(centralised, cfg, env, entries=range(SEEDS), overrides=()):
    """The port's stock learner state of each JAX entry after the warm-up, and
    the draws of its next update."""
    jcfg, unwrapped, _, _, warm, out = jax_vmapped(centralised, overrides)
    states, draws = [], []
    for s in entries:
        _, _, _, state = ff_isac.learner_setup(env, torch.Generator().manual_seed(0), cfg, CPU,
                                               centralised)
        states.append(_load_learner_state(state, _entry(warm, s)))
        draws.append(_update_draws(_entry(warm, s), _entry(out, s), jcfg, env))
    return states, draws


def _explore_draws(jstate, jmetrics, env):
    """The explore phase's Uniform[-1, 1] actions and auto-reset draws of one
    JAX entry, from its keys (ff_isac.py:434-439)."""
    key, env_keys = jstate.key[0], jstate.env_state.env_state.key
    shape = (env_keys.shape[0], env.num_agents, env.action_dim)
    actions, env_noise = [], []
    for done in np.asarray(jmetrics["is_terminal_step"]):  # (steps, E)
        key, explore_key = jax.random.split(key)
        actions.append(np.asarray(jax.random.uniform(explore_key, shape, minval=-1.0, maxval=1.0)))
        env_noise.append((None, MaSwarmResetNoise(*map(_t, jax.vmap(
            lambda k: auto_reset_draws(k, env))(env_keys)))))
        reset_keys = jax.vmap(lambda k: jax.random.split(jax.random.split(k)[0], 3)[0])(env_keys)
        env_keys = jax.numpy.where(jax.numpy.asarray(done)[:, None], reset_keys, env_keys)
    return torch.tensor(np.stack(actions)), env_noise


def check_stacked_explore(centralised):
    """The stacked explore phase from the JAX entries' first states and draws."""
    _, _, first, (explored, jmetrics), _, _ = jax_vmapped(centralised)
    cfg = port_config(centralised)
    env, _ = tenvs.make(cfg, CPU, add_global_state=centralised)
    explore, _, _, state = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, centralised)
    flat = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: np.asarray(x).reshape(-1, *np.asarray(x).shape[2:]), tree)
    state = state._replace(obs=type(state.obs)(*(_t(x) for x in flat(first.obs))),
                           env_state=to_torch_state(flat(first.env_state)))
    draws = [_explore_draws(_entry(first, s), _entry(jmetrics, s), env) for s in range(SEEDS)]
    explore_actions = torch.stack([d[0] for d in draws])
    env_noise = [(None, pytree.tree_map(_cat, *[step[1] for step in steps]))
                 for steps in zip(*[d[1] for d in draws])]
    new, _ = explore(state, Draws(explore=explore_actions, env_noise=env_noise))
    assert new.t == int(np.asarray(explored.t)[0])
    assert new.buffer_state.current_index == int(np.asarray(explored.buffer_state.current_index)[0])
    for got, want in zip(jax.tree.leaves(tuple(new.buffer_state.experience)),
                         jax.tree.leaves(explored.buffer_state.experience)):
        _assert_close(got, want, "explored buffer")
    for got, want in zip(jax.tree.leaves(tuple(new.obs)), jax.tree.leaves(flat(explored.obs))):
        _assert_close(got, want, "explored obs")


def check_stacked_update(centralised, overrides=()):
    """Entry s of one stacked update against the JAX vmapped learner's entry s
    and the port's stock learner from entry s's state and draws."""
    cfg = port_config(centralised, overrides)
    env, _ = tenvs.make(cfg, CPU, add_global_state=centralised)
    stocks, draws = stock_states_and_draws(centralised, cfg, env, overrides=overrides)
    _, learn, _, state = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, centralised)
    out = learn(stack_states(state, stocks), [stacked_draws(draws)])
    jnew, (jmetrics, jlosses) = jax_vmapped(centralised, overrides)[-1]
    new = out.learner_state
    p = new.params
    nets = (p.actor, *p.q.online, *p.q.targets)
    for s in range(SEEDS):
        for name, values in jlosses.items():  # (S, updates, epochs)
            _assert_close(out.train_metrics[name][s], values[s], f"{name} {s}")
        jp = _entry(jnew.params, s)
        for net, tree, head in zip(nets, (jp.actor, *jp.q.online, *jp.q.targets),
                                   ("value_head",) + ("q_head",) * 4):
            want = from_flax_params(tree, head=head)
            for name, value in net.params.items():
                _assert_close(value[s], want[name], f"{name} {s}")
        _assert_close(p.log_alpha[s], jp.log_alpha, f"log_alpha {s}")
        _assert_close(out.train_metrics["log_alpha"][s], jp.log_alpha, f"logged log_alpha {s}")
        for kind, opt, adam in zip(("actor", "q", "alpha"), new.opt_states,
                                   _adam_states(_entry(jnew.opt_states, s))):
            assert opt.count == int(np.asarray(adam.count)), kind
            entry_params = SimpleNamespace(actor=_Entry(p.actor, s), q=SimpleNamespace(
                online=[_Entry(net, s) for net in p.q.online]))
            for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
                for m, w in zip(moments, _adam_values(kind, entry_params, tree), strict=True):
                    np.testing.assert_allclose(m[s].numpy(), w.numpy(), err_msg=kind, rtol=1e-5,
                                               atol=1e-8)
        for got, want in zip(jax.tree.leaves(tuple(new.buffer_state.experience)),
                             jax.tree.leaves(_entry(jnew.buffer_state.experience, s))):
            _assert_close(got[s], want, f"buffer {s}")
        # The port's stock learner from entry s's state and draws.
        _, stock_learn, _, _ = ff_isac.learner_setup(
            env, torch.Generator().manual_seed(0), cfg, CPU, centralised)
        stock = stock_learn(stocks[s], [draws[s]])
        for name, values in stock.train_metrics.items():
            _assert_close(out.train_metrics[name][s], values, f"{name} stock {s}")
        sp = stock.learner_state.params
        for net, stock_net in zip(nets, (sp.actor, *sp.q.online, *sp.q.targets)):
            for name, value in stock_net.named_parameters():
                _assert_close(net.params[name][s], value, f"{name} stock {s}")
    assert new.t == int(np.asarray(jnew.t)[0])
    for k, v in jmetrics.items():  # (S, updates, rollout, E) against (updates, rollout, S * E)
        _assert_close(out.episode_metrics[k].reshape(1, -1, SEEDS, 3).movedim(2, 0), v, k)
    return out


class _Entry:
    """Entry s of a `StackedNetwork` where a module is read for its parameter
    names and order (`_adam_values`)."""

    def __init__(self, stacked, s):
        self.stacked, self.s = stacked, s

    def named_parameters(self):
        return ((name, value[self.s]) for name, value in self.stacked.params.items())


def test_stacked_explore_matches_jax_vmapped_learner():
    check_stacked_explore(False)


def test_stacked_update_matches_jax_vmapped_and_stock_learners():
    out = check_stacked_update(False)
    actor_loss = out.train_metrics["actor_loss"][:, 0]  # actor and alpha on epochs 0 and 2
    assert (actor_loss[:, 1::2] == 0).all() and (actor_loss[:, 0::2] != 0).all()


def test_sweep_entry_matches_the_stock_learner_at_its_lr():
    """Entry i of a sweep (every entry JAX entry 0's state and draws) is the
    stock learner at policy_lr = q_lr = sweep_lrs[i]; alpha keeps alpha_lr
    (twin of `test_vmap_sweep.py:245`)."""
    lrs = [1e-4, 1e-3]
    cfg = port_config(False)
    env, _ = tenvs.make(cfg, CPU)
    stocks, draws = stock_states_and_draws(False, cfg, env, entries=[0])
    _, learn, _, state = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, sweep_lrs=lrs)
    assert [opt.peak_lr.tolist() for opt in state.opt_states] == [lrs, lrs, [cfg.system.alpha_lr] * 2]
    out = learn(stack_states(state, stocks * SEEDS), [stacked_draws(draws * SEEDS)])
    for i, lr in enumerate(lrs):
        cfg_i = port_config(False, [f"system.policy_lr={lr}", f"system.q_lr={lr}"])
        stock, = stock_states_and_draws(False, cfg_i, env, entries=[0])[0]
        assert (stock.opt_states.actor.lr, stock.opt_states.q.lr) == (lr, lr)
        _, stock_learn, _, _ = ff_isac.learner_setup(
            env, torch.Generator().manual_seed(0), cfg_i, CPU)
        got = stock_learn(stock, draws).learner_state.params
        p = out.learner_state.params
        for net, stock_net in zip((p.actor, *p.q.online), (got.actor, *got.q.online)):
            for name, value in stock_net.named_parameters():
                _assert_close(net.params[name][i], value, f"{name} lr {lr}")
        _assert_close(p.log_alpha[i], got.log_alpha, f"log_alpha lr {lr}")
    assert not torch.equal(out.learner_state.params.actor.parameters()[0][0],
                           out.learner_state.params.actor.parameters()[0][1])


def test_swept_adam_is_bitwise_the_stock_sac_optimizer():
    """`make_swept_adam` at eps 1e-8: each entry bitwise the stock clip-then-Adam
    at its lr, on a gradient stream that the clip cuts at some steps (one CPU
    thread; twin of `test_vmap_sweep.py:223`)."""
    base = [torch.arange(8, dtype=torch.float32).reshape(2, 4) / 3.0, torch.ones(3)]
    lrs = [3e-4, 1e-3]
    swept = make_swept_adam([torch.stack([b] * len(lrs)) for b in base], lrs, 10.0)
    assert swept.eps == 1e-8 and swept.decay_updates is None
    stocks = [ClippedAdam([b.clone() for b in base], lr, 10.0, eps=1e-8) for lr in lrs]
    for t in range(6):
        grads = [torch.cos(torch.arange(b.numel(), dtype=torch.float32).reshape(b.shape) + t)
                 * (20.0 if t % 2 else 1.0) for b in base]
        swept.step([torch.stack([g * (i + 1) for i in range(len(lrs))]) for g in grads])
        for i, stock in enumerate(stocks):
            stock.step([g * (i + 1) for g in grads])
    for i, stock in enumerate(stocks):
        for p, q in zip(swept.params, stock.params):
            assert torch.equal(p[i], q)


def test_each_optimizer_clips_each_entry_by_its_own_norm():
    """The Q optimizer clips each entry by one joint norm over its q1 and q2;
    the alpha optimizer each entry's `log_alpha` by its own; an entry's huge
    gradient leaves the other entry's step the stock one."""
    cfg = port_config(False)
    env, _ = tenvs.make(cfg, CPU)
    _, _, _, state = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS)
    online = state.params.q.online
    q_opt, alpha_opt = state.opt_states.q, state.opt_states.alpha
    assert q_opt.params == [*online.q1.parameters(), *online.q2.parameters()]
    assert alpha_opt.params == [state.params.log_alpha] and cfg.system.max_grad_norm == 10
    grads = [torch.zeros_like(p) for p in q_opt.params]
    grads[0][0].view(-1)[0] = 12.0  # entry 0's q1
    grads[-1][0].view(-1)[0] = 16.0  # entry 0's q2: a joint norm of 20, scaled by 10 / 20
    grads[0][1].view(-1)[0] = 3.0  # entry 1: a norm of 5, not clipped
    grads[-1][1].view(-1)[0] = 4.0
    q_opt.step(grads)
    assert torch.allclose(q_opt.mu[0][0].view(-1)[0], torch.tensor(0.1 * 12.0 * 0.5))
    assert torch.allclose(q_opt.mu[-1][0].view(-1)[0], torch.tensor(0.1 * 16.0 * 0.5))
    assert torch.allclose(q_opt.mu[0][1].view(-1)[0], torch.tensor(0.1 * 3.0))
    assert torch.allclose(q_opt.mu[-1][1].view(-1)[0], torch.tensor(0.1 * 4.0))
    alpha_grad = torch.zeros_like(state.params.log_alpha)
    alpha_grad[0, 0, 0], alpha_grad[1, 0, 0] = 1000.0, 1.0
    alpha_opt.step([alpha_grad])
    assert torch.allclose(alpha_opt.mu[0][:, 0, 0], torch.tensor([0.1 * 10.0, 0.1 * 1.0]))


def test_one_entrys_state_leaves_the_others_update_untouched():
    """Entry 1's explore phase and updates are bitwise the same whether entry 0
    starts from its own parameters or from parameters 1000 times as large."""
    def run(scale):
        cfg = port_config(False)
        env, _ = tenvs.make(cfg, CPU)
        explore, learn, _, state = ff_isac_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(1), cfg, CPU, SEEDS)
        with torch.no_grad():
            for p in state.params.actor.parameters() + state.params.q.online.q1.parameters():
                p[0].mul_(scale)
        state, _ = explore(state)
        for _ in range(2):
            out = learn(state)
            state = out.learner_state
        return out

    a, b = run(1.0), run(1000.0)
    for net_a, net_b in zip(a.learner_state.params.q.online, b.learner_state.params.q.online):
        for p, q in zip(net_a.parameters(), net_b.parameters()):
            assert torch.equal(p[1], q[1])
    for name, values in a.train_metrics.items():
        assert torch.equal(values[1], b.train_metrics[name][1]), name
        if name in ("loss", "q1_loss"):
            assert not torch.equal(values[0], b.train_metrics[name][0]), name


@pytest.mark.parametrize("entries", [1, 3])
def test_stacked_item_buffer_is_one_allocation_and_each_entry_a_stock_ring(entries):
    """The stacked ring is allocated once, (S, ...) on the dummy's device, and
    each entry adds (a slice, or a scatter where it wraps) and samples exactly
    as a stock buffer of its own."""
    kw = dict(max_length=7, min_length=2, sample_batch_size=5, add_batch_size=3)
    stacked, stock = StackedItemBuffer(entries, **kw), ItemBuffer(**kw)
    dummy = {"x": torch.zeros(2, 3), "done": torch.zeros(2, dtype=torch.bool)}
    state = stacked.init(dummy)
    for name, leaf in state.experience.items():
        assert leaf.shape == (entries, 7, *dummy[name].shape) and leaf.is_contiguous()
        assert leaf.device == dummy[name].device and not leaf.any()
    singles = [stock.init(dummy) for _ in range(entries)]
    gen = torch.Generator().manual_seed(0)
    draw = lambda fn, shape: fn((entries, *shape), gen, "cpu")  # noqa: E731
    for _ in range(5):
        batch = {"x": torch.randn(entries, 3, 2, 3, generator=gen),
                 "done": torch.rand(entries, 3, 2, generator=gen) < 0.5}
        state = stacked.add(state, batch)
        singles = [stock.add(st, {k: v[s] for k, v in batch.items()})
                   for s, st in enumerate(singles)]
        rows = stacked.sample_indices(state, draw)
        got = stacked.sample(state, rows)
        for s, single in enumerate(singles):
            assert (state.current_index, state.is_full) == (single.current_index, single.is_full)
            for name in dummy:
                assert torch.equal(got[name][s], stock.sample(single, rows[s])[name])
                assert torch.equal(state.experience[name][s], single.experience[name])


CLI = ["system.total_timesteps=240", "arch.num_evaluation=2", "arch.num_envs=4",
       "system.explore_steps=40", "system.epochs=4", "system.policy_update_delay=2",
       "system.buffer_size=512", "arch.num_eval_episodes=4",
       "network.actor_network.pre_torso.layer_sizes=[32]",
       "network.critic_network.pre_torso.layer_sizes=[32]", "env.kwargs.time_limit=16"]
CLIS = {
    "ff_isac_seeds": (ff_isac_vmap_seeds, "ff-ISAC vmap-seeds experiment completed.",
                      ["+system.num_seeds=2"]),
    "ff_isac_sweep": (ff_isac_vmap_sweep, "ff-ISAC vmap-lr-sweep experiment completed.",
                      ["+system.sweep_lrs=[1e-4, 1e-3]"]),
    "ff_masac_seeds": (ff_masac_vmap_seeds, "ff-MASAC vmap-seeds experiment completed.",
                       ["+system.num_seeds=2"]),
    "ff_masac_sweep": (ff_masac_vmap_sweep, "ff-MASAC vmap-lr-sweep experiment completed.",
                       ["+system.sweep_lrs=[1e-4, 1e-3]"]),
}


def check_cli(program, monkeypatch, capsys):
    module, last_line, extra = CLIS[program]
    monkeypatch.setattr(sys, "argv", [program, *CLI, "+arch.device=cpu", *extra])
    logged_at, log = [], common.MavaLogger.log

    def record(self, metrics, t, t_eval, event):
        logged_at.append((event.name, t))
        return log(self, metrics, t, t_eval, event)

    monkeypatch.setattr(common.MavaLogger, "log", record)
    performance = module.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    out, logged = captured.out, captured.out + captured.err
    assert out.rstrip().endswith(last_line) and "final eval returns per " in out
    # The explore phase first (40 env-steps, logged only where an episode ended),
    # then rounds of 240 // 2 from there: the reference's range(40, 241, 120),
    # each logged at its end.
    assert [t for event, t in logged_at if event == "TRAIN"] == [160, 280]
    assert [t for event, t in logged_at if event == "EVAL"] == [160, 280]
    assert "Log alpha" in logged and "Seed return best" in logged and "Win rate" not in logged


def check_runs_on_the_card_by_default(program, config_name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    module, _, extra = CLIS[program]
    cfg = load_config(config_name, CLI + extra)
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        (module.run_experiment if "sweep" in program else ff_isac_vmap_seeds.run_experiment)(cfg)


@pytest.mark.parametrize("program", ["ff_isac_seeds", "ff_isac_sweep"])
def test_cli_end_to_end(program, monkeypatch, capsys):
    check_cli(program, monkeypatch, capsys)


@pytest.mark.parametrize("program", ["ff_isac_seeds", "ff_isac_sweep"])
def test_runs_on_the_card_by_default(program):
    check_runs_on_the_card_by_default(program, "default_ff_isac")


def test_seed_shards_is_refused():
    cfg = load_config("default_ff_isac", CLI + ["+arch.device=cpu", "+system.seed_shards=2"])
    with pytest.raises(ValueError, match=r"seed_shards=2 must divide the device count \(1\)"):
        ff_isac_vmap_seeds.run_experiment(cfg)
