"""ff-ISAC of the port against `mava_tpu`'s: `TanhNormal` (1e-6, with the
gradients in loc and scale), `ContinuousActionHead` and `FeedForwardQNet`
(outputs and parameter gradients after `strict=True` loads, 1e-5), the
joint-action helpers and the item buffer (exact), one whole update against the
1-device-mesh JAX learner (1e-5), the reference's own behaviour that the port
keeps, and the CLI on the CPU.

The update test runs the JAX explore phase and one warm-up update (the buffer
of 7 items wraps during it, and again during the compared update), converts
the whole learner state (parameters, `log_alpha`, the three Adam states, the
buffer, the envs) and hands the port the draws of the next JAX update,
recomputed from its keys (ff_isac.py:454, :426, :393, :349): the act normals,
each auto-reset's uniform positions, the buffer rows, the normals of the Q
step and of every actor and alpha step. With 4 epochs and a delay of 2 the
actor and alpha steps run twice, two each. The explore phase is held the same
way, from the JAX learner's first env states and its Uniform[-1, 1] actions.
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu.distributions import TanhNormal as JTanhNormal
from mava_tpu.networks import FeedForwardActor as JActor
from mava_tpu.networks import FeedForwardQNet as JQNet
from mava_tpu.networks.heads import ContinuousActionHead as JHead
from mava_tpu.networks.torsos import MLPTorso as JTorso
from mava_tpu.parallel import make_mesh
from mava_tpu.replay import make_item_buffer
from mava_tpu.systems.sac import ff_isac as jff_isac
from mava_tpu.types import Observation as JObservation
from mava_tpu.types import ObservationGlobalState as JObservationGlobalState
from mava_tpu.utils import centralised_training as jct
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.distributions import TanhNormal
from mava_tpu_torch.envs.maswarm import MaSwarmResetNoise
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.networks import FeedForwardActor, FeedForwardQNet
from mava_tpu_torch.networks.heads import ContinuousActionHead
from mava_tpu_torch.networks.torsos import MLPTorso
from mava_tpu_torch.replay import ItemBuffer, ItemBufferState
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.systems.sac.types import Draws, Transition
from mava_tpu_torch.types import Observation, ObservationGlobalState
from mava_tpu_torch.utils import centralised_training as tct
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_maswarm import auto_reset_draws, to_torch_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
DIST_TOL = dict(rtol=1e-6, atol=1e-6)
TINY = [
    "arch.num_envs=3",
    "system.rollout_length=2",
    "system.explore_steps=6",
    "system.epochs=4",
    "system.policy_update_delay=2",
    "system.buffer_size=7",
    "system.batch_size=4",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "env.kwargs.time_limit=5",
    "logger.use_console=False",
]


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------------ TanhNormal
def _loc_scale(seed=0, shape=(4, 3, 2)):
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal(shape).astype(np.float32)
    scale = (0.05 + rng.random(shape)).astype(np.float32)
    return loc, scale


def test_tanh_normal_samples_log_probs_entropy_mode_match():
    loc, scale = _loc_scale()
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, loc.shape))  # what `sample(seed=key)` draws
    jd, td = JTanhNormal(jnp.asarray(loc), jnp.asarray(scale)), TanhNormal(_t(loc), _t(scale))
    np.testing.assert_allclose(td.sample_from_noise(_t(noise)).numpy(),
                               np.asarray(jd.sample(seed=key)), **DIST_TOL)
    ja, jlp = jd.sample_and_log_prob(seed=key)
    ta, tlp = td.sample_and_log_prob(noise=_t(noise))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **DIST_TOL)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **DIST_TOL)
    np.testing.assert_allclose(td.entropy(noise=_t(noise)).numpy(),
                               np.asarray(jd.entropy(seed=key)), **DIST_TOL)
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()), **DIST_TOL)
    lo, sc = td.raw_params()
    assert lo is td.loc and sc is td.scale
    # Events inside, at and beyond both clipped ends (threshold 0.999).
    events = np.tanh(loc + scale * noise).astype(np.float32)
    events[0, 0] = [-1.0, 1.0]
    events[0, 1] = [-0.9995, 0.9995]
    events[1, 0] = [-0.999, 0.999]
    events[1, 1] = [-0.99, 0.998]
    np.testing.assert_allclose(td.log_prob(_t(events)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(events))), **DIST_TOL)


def test_tanh_normal_gradients_in_loc_and_scale_match():
    loc, scale = _loc_scale(seed=1)
    noise = np.random.default_rng(2).standard_normal(loc.shape).astype(np.float32)
    events = np.tanh(loc + 0.5).astype(np.float32)
    events[0, 0] = [-1.0, 1.0]
    weights = np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(4, 3)

    def jloss(loc, scale):
        d = JTanhNormal(loc, scale)
        _, lp = d.sample_and_log_prob(seed=jax.random.PRNGKey(0))
        a = d.sample_from_noise(jnp.asarray(noise))
        return (jnp.sum(weights * d.log_prob(jnp.asarray(events)))
                + jnp.sum(weights * JTanhNormal(loc, scale).entropy(seed=jax.random.PRNGKey(1)))
                + jnp.sum(a) + jnp.sum(lp))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(scale))
    tloc, tscale = _t(loc).requires_grad_(), _t(scale).requires_grad_()
    d = TanhNormal(tloc, tscale)
    n0 = _t(jax.random.normal(jax.random.PRNGKey(0), loc.shape))
    n1 = _t(jax.random.normal(jax.random.PRNGKey(1), loc.shape))
    _, lp = d.sample_and_log_prob(noise=n0)
    loss = (torch.sum(_t(weights) * d.log_prob(_t(events)))
            + torch.sum(_t(weights) * d.entropy(noise=n1))
            + d.sample_from_noise(_t(noise)).sum() + lp.sum())
    for got, w in zip(torch.autograd.grad(loss, (tloc, tscale)), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **DIST_TOL)


# ------------------------------------------------------------------ networks
def _views(seed, e=5, a=3, f=7, g=None):
    rng = np.random.default_rng(seed)
    view = rng.standard_normal((e, a, f)).astype(np.float32)
    mask = np.ones((e, a, 2), bool)
    step = np.zeros((e, a), np.int32)
    if g is None:
        return JObservation(*map(jnp.asarray, (view, mask, step))), Observation(
            *map(_t, (view, mask, step)))
    gs = rng.standard_normal((e, a, g)).astype(np.float32)
    return (JObservationGlobalState(*map(jnp.asarray, (view, mask, gs, step))),
            ObservationGlobalState(*map(_t, (view, mask, gs, step))))


def _assert_grads(module, flax_grads, head="value_head"):
    want = from_flax_params(jax.device_get(flax_grads), head=head)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("independent_std", [False, True])
def test_continuous_actor_matches(independent_std):
    jobs, tobs = _views(3)
    jactor = JActor(torso=JTorso(layer_sizes=(16, 16)),
                    action_head=JHead(action_dim=2, independent_std=independent_std))
    params = jactor.init(jax.random.PRNGKey(0), jobs)
    # Move every parameter off its init (the loc and log-std layers start near 0).
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: x + 0.3 * rng.standard_normal(x.shape).astype(np.float32), params)
    tactor = FeedForwardActor(MLPTorso(7, (16, 16)),
                              ContinuousActionHead(16, 2, independent_std=independent_std))
    tactor.load_state_dict(from_flax_params(jax.device_get(params)), strict=True)
    noise = np.random.default_rng(2).standard_normal((5, 3, 2)).astype(np.float32)

    def jloss(p):
        d = jactor.apply(p, jobs)
        a = d.sample_from_noise(jnp.asarray(noise))
        return jnp.sum(a * a) + jnp.sum(d.scale) + jnp.sum(d.log_prob(a * 0.9)), (d.loc, d.scale)

    (_, (jloc, jscale)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    d = tactor(tobs)
    np.testing.assert_allclose(d.loc.detach().numpy(), np.asarray(jloc), **TOL)
    np.testing.assert_allclose(d.scale.detach().numpy(), np.asarray(jscale), **TOL)
    a = d.sample_from_noise(_t(noise))
    (torch.sum(a * a) + d.scale.sum() + d.log_prob(a * 0.9).sum()).backward()
    _assert_grads(tactor, jgrads)


@pytest.mark.parametrize("centralised", [False, True])
def test_q_network_matches(centralised):
    a, act, f, g = 3, 2, 7, 21
    jobs, tobs = _views(4, a=a, f=f, g=g if centralised else None)
    rng = np.random.default_rng(5)
    width = a * act if centralised else act
    action = rng.uniform(-1, 1, (5, a, width)).astype(np.float32)
    jq = JQNet(torso=JTorso(layer_sizes=(16, 16)), centralised_critic=centralised)
    params = jq.init(jax.random.PRNGKey(1), jobs, jnp.asarray(action))
    tq = FeedForwardQNet(MLPTorso((g if centralised else f) + width, (16, 16)), centralised)
    tq.load_state_dict(from_flax_params(jax.device_get(params), head="q_head"), strict=True)
    weights = np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3)

    jout, jgrads = jax.value_and_grad(
        lambda p: jnp.sum(weights * jq.apply(p, jobs, jnp.asarray(action))))(params)
    tout = tq(tobs, _t(action))
    assert tout.shape == (5, a)
    np.testing.assert_allclose(torch.sum(_t(weights) * tout).item(), float(jout), **TOL)
    torch.sum(_t(weights) * tout).backward()
    _assert_grads(tq, jgrads, head="q_head")
    if centralised:  # the centralised critic needs a global state
        with pytest.raises(ValueError, match="global state"):
            tq(Observation(tobs.agents_view, tobs.action_mask, tobs.step_count), _t(action))


def test_joint_actions_match():
    rng = np.random.default_rng(6)
    old = rng.standard_normal((4, 3, 2)).astype(np.float32)
    new = rng.standard_normal((4, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(tct.get_joint_action(_t(old)).numpy(),
                                  np.asarray(jct.get_joint_action(jnp.asarray(old))))
    np.testing.assert_array_equal(
        tct.get_updated_joint_actions(_t(old), _t(new)).numpy(),
        np.asarray(jct.get_updated_joint_actions(jnp.asarray(old), jnp.asarray(new))))


# ------------------------------------------------------------------ buffer
def test_item_buffer_add_with_wrap_and_sample_from_injected_rows():
    kw = dict(max_length=7, min_length=4, sample_batch_size=5, add_batch_size=3)
    jbuf, tbuf = make_item_buffer(**kw), ItemBuffer(**kw)
    dummy = {"x": np.zeros((2,), np.float32), "m": np.zeros((3,), bool)}
    jstate = jbuf.init(jax.tree.map(jnp.asarray, dummy))
    tstate = tbuf.init(jax.tree.map(_t, dummy))
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    for _ in range(5):  # the third batch wraps, the fourth fills up to one short
        batch = {"x": rng.standard_normal((3, 2)).astype(np.float32), "m": rng.random((3, 3)) < 0.5}
        jstate = jbuf.add(jstate, jax.tree.map(jnp.asarray, batch))
        tstate = tbuf.add(tstate, jax.tree.map(_t, batch))
        assert (tstate.current_index, tstate.is_full) == (int(jstate.current_index),
                                                           bool(jstate.is_full))
        assert tbuf.can_sample(tstate) == bool(jbuf.can_sample(jstate))
        for name in dummy:
            np.testing.assert_array_equal(tstate.experience[name].numpy(),
                                          np.asarray(jstate.experience[name]))
        key, sample_key = jax.random.split(key)
        rows = jax.random.randint(sample_key, (5,), 0, tbuf.size(tstate))  # item_buffer.py:92
        want = jbuf.sample(jstate, sample_key).experience
        got = tbuf.sample(tstate, _t(rows))
        for name in dummy:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert tstate.is_full
    with pytest.raises(ValueError):
        tbuf.add(tstate, {"x": torch.zeros(2, 2), "m": torch.zeros(2, 3, dtype=torch.bool)})


def test_compress_and_expand_stored_obs():
    _, tobs = _views(7, e=2, a=3, f=4, g=12)
    tobs = tobs._replace(global_state=tobs.global_state[:, :1].expand(2, 3, 12))
    stored = ff_isac.compress_stored_obs(tobs)
    assert stored.global_state.shape == (2, 1, 12)
    assert torch.equal(ff_isac.expand_sampled_obs(stored, 3).global_state, tobs.global_state)
    grid = tobs._replace(global_state=torch.zeros(2, 3, 5, 5))
    with pytest.raises(ValueError, match="Grid global states"):
        ff_isac.compress_stored_obs(grid)
    plain = Observation(tobs.agents_view, tobs.action_mask, tobs.step_count)
    assert ff_isac.compress_stored_obs(plain) is plain


# ------------------------------------------------------------------ one update
def _prepare(cfg):
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = 1
    return cfg


def _maswarm_reset_noise(env_keys, unwrapped):
    """What the auto-resets after a step of the envs whose keys are `env_keys` draw."""
    return MaSwarmResetNoise(*map(_t, jax.vmap(lambda k: auto_reset_draws(k, unwrapped))(env_keys)))


def _maswarm_key_after_reset(key):
    """The env key after `MaSwarm.reset(key)` (its first split of three)."""
    return jax.random.split(key, 3)[0]


def _update_draws(jstate, jout, cfg, unwrapped, reset_noise=_maswarm_reset_noise,
                  key_after_reset=_maswarm_key_after_reset):
    """The draws of one JAX update (ff_isac.py:454, :426, :393, :349);
    `reset_noise(env_keys, unwrapped)` gives the env's auto-reset draws and
    `key_after_reset` the key a reset leaves in the env's state."""
    sys_cfg = cfg.system
    e, a, act, b = cfg.arch.num_envs, unwrapped.num_agents, unwrapped.action_dim, sys_cfg.batch_size
    _, act_key, learn_key = jax.random.split(jstate.key[0], 3)
    act_noise = []
    for _ in range(sys_cfg.rollout_length):
        act_key, sample_key = jax.random.split(act_key)
        act_noise.append(np.asarray(jax.random.normal(sample_key, (e, a, act))))
    full = bool(np.asarray(jstate.buffer_state.is_full))
    size = sys_cfg.buffer_size if full else int(np.asarray(jstate.buffer_state.current_index))
    size = min(size + e * sys_cfg.rollout_length, sys_cfg.buffer_size)
    rows, q_noise, actor_noise, alpha_noise = [], [], [], []
    for _ in range(sys_cfg.epochs):
        learn_key, buff_key, q_key, actor_key = jax.random.split(learn_key, 4)
        rows.append(np.asarray(jax.random.randint(buff_key, (b,), 0, size)))
        q_noise.append(np.asarray(jax.random.normal(q_key, (b, a, act))))
        steps = ([], [])
        for _ in range(sys_cfg.policy_update_delay):
            actor_key, a_key, al_key = jax.random.split(actor_key, 3)
            steps[0].append(np.asarray(jax.random.normal(a_key, (b, a, act))))
            steps[1].append(np.asarray(jax.random.normal(al_key, (b, a, act))))
        actor_noise.append(np.stack(steps[0]))
        alpha_noise.append(np.stack(steps[1]))
    env_keys = jstate.env_state.env_state.key
    dones = np.asarray(jout[1][0]["is_terminal_step"])[0]  # (rollout, E)
    env_noise = []
    for done in dones:
        env_noise.append((None, reset_noise(env_keys, unwrapped)))
        reset_keys = jax.vmap(lambda k: key_after_reset(jax.random.split(k)[0]))(env_keys)
        env_keys = jnp.where(jnp.asarray(done)[:, None], reset_keys, env_keys)
    stack = lambda xs: torch.tensor(np.stack(xs))  # noqa: E731
    return Draws(act_noise=stack(act_noise), rows=stack(rows), q_noise=stack(q_noise),
                 actor_noise=stack(actor_noise), alpha_noise=stack(alpha_noise),
                 env_noise=env_noise)


def _adam_states(opt_states):
    """The three `ScaleByAdamState`s of the reference's optimizers."""
    return [next(x for x in jax.tree_util.tree_leaves(s, is_leaf=lambda x: hasattr(x, "mu"))
                 if hasattr(x, "mu")) for s in opt_states]


def _ordered(module, tree, head="value_head"):
    values = from_flax_params(tree, head=head)
    return [values[name] for name, _ in module.named_parameters()]


def _adam_values(kind: str, params, tree):
    """A flax-shaped moment tree in the order of the port optimizer's
    parameters: the actor's, q1's then q2's, or `log_alpha`."""
    if kind == "actor":
        return _ordered(params.actor, tree)
    if kind == "q":
        return [v for net, q in zip(params.q.online, (tree.q1, tree.q2))
                for v in _ordered(net, q, "q_head")]
    return [_t(tree)]


def _load_learner_state(state, jstate, to_state=to_torch_state):
    """The port's learner state with the JAX learner's: parameters,
    `log_alpha`, the three Adam states, the buffer, env states, obs, t."""
    s = jax.device_get(jstate)
    params = state.params
    params.actor.load_state_dict(from_flax_params(s.params.actor), strict=True)
    for net, tree in zip((*params.q.online, *params.q.targets), (*s.params.q.online, *s.params.q.targets)):
        net.load_state_dict(from_flax_params(tree, head="q_head"), strict=True)
    with torch.no_grad():
        params.log_alpha.copy_(_t(s.params.log_alpha))
    for kind, opt, adam in zip(("actor", "q", "alpha"), state.opt_states,
                               _adam_states(s.opt_states)):
        for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for m, v in zip(moments, _adam_values(kind, params, tree), strict=True):
                m.copy_(v)
        opt.count = int(np.asarray(adam.count))
    exp = jax.tree.map(_t, s.buffer_state.experience)
    obs_type = type(state.obs)
    exp = Transition(obs_type(*exp.obs), exp.action, exp.reward, exp.done, obs_type(*exp.next_obs))
    buffer_state = ItemBufferState(exp, int(np.asarray(s.buffer_state.current_index)),
                                   bool(np.asarray(s.buffer_state.is_full)))
    return state._replace(obs=obs_type(*(_t(x) for x in s.obs)),
                          env_state=to_state(s.env_state), buffer_state=buffer_state,
                          t=int(np.asarray(s.t)))


def check_one_update(system: str, centralised: bool, overrides=(),
                     reset_noise=_maswarm_reset_noise, to_state=to_torch_state,
                     key_after_reset=_maswarm_key_after_reset):
    """One update of the port from the JAX learner's state and draws, against
    the JAX learner's (parameters, log_alpha, Adam states, losses, buffer).
    `reset_noise`, `key_after_reset` and `to_state` give the env's draws, keys
    and state (MaSwarm's by default)."""
    overrides = TINY + list(overrides)
    cfg = _prepare(jax_load_config(system, overrides))
    mesh = make_mesh(jax.devices()[:1])
    explore, update, jstate = jff_isac.build_bench_learners(cfg, mesh, centralised)
    jstate, _ = explore(jstate)
    jstate, _ = update(jstate)  # warm-up: the buffer wraps
    # The update called on the arrays it made, so its compiled program is reused
    # (host copies in would compile it again).
    jout = jax.device_get(update(jstate))
    jstate = jax.device_get(jstate)

    tcfg = _prepare(load_config(system, overrides + ["+arch.device=cpu"]))
    tenv, _ = tenvs.make(tcfg, "cpu", add_global_state=centralised)
    draws = _update_draws(jstate, jout, cfg, tenv, reset_noise, key_after_reset)
    _, learn, _, state = ff_isac.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg,
                                               torch.device("cpu"), centralised)
    state = _load_learner_state(state, jstate, to_state)
    out = learn(state, [draws])

    jnew, (jmetrics, jlosses) = jout
    for name, values in jlosses.items():
        np.testing.assert_allclose(out.train_metrics[name].numpy(), np.asarray(values),
                                   err_msg=name, **TOL)
    new = out.learner_state
    p = new.params
    for net, tree, head in ((p.actor, jnew.params.actor, "value_head"),
                            *((n, tr, "q_head") for n, tr in zip(
                                (*p.q.online, *p.q.targets),
                                (*jnew.params.q.online, *jnew.params.q.targets)))):
        want = from_flax_params(tree, head=head)
        for name, value in net.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **TOL)
    np.testing.assert_allclose(p.log_alpha.detach().numpy(), np.asarray(jnew.params.log_alpha),
                               **TOL)
    np.testing.assert_allclose(out.train_metrics["log_alpha"].numpy(),
                               np.asarray(jnew.params.log_alpha), **TOL)
    for kind, opt, adam in zip(("actor", "q", "alpha"), new.opt_states,
                               _adam_states(jnew.opt_states)):
        assert opt.count == int(np.asarray(adam.count)), kind
        for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for m, w in zip(moments, _adam_values(kind, p, tree), strict=True):
                np.testing.assert_allclose(m.numpy(), w.numpy(), err_msg=kind, rtol=1e-5, atol=1e-8)
    assert new.t == int(np.asarray(jnew.t))
    assert (new.buffer_state.current_index, new.buffer_state.is_full) == (
        int(np.asarray(jnew.buffer_state.current_index)), bool(np.asarray(jnew.buffer_state.is_full)))
    for got, want in zip(jax.tree.leaves(tuple(new.buffer_state.experience)),
                         jax.tree.leaves(jnew.buffer_state.experience)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(out.episode_metrics[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    # The actor and alpha ran on epochs 0 and 2, twice each (see TINY).
    actor_loss = out.train_metrics["actor_loss"][0]
    assert (actor_loss[1::2] == 0).all() and (actor_loss[0::2] != 0).all()
    return out


def test_one_isac_update_matches_jax_learner():
    check_one_update("default_ff_isac", centralised=False)


def test_explore_phase_matches_jax_learner():
    """The explore phase from the JAX learner's first env states, handed the
    Uniform[-1, 1] actions of its keys (ff_isac.py:436-439): buffer, env
    states, observations and t equal the JAX learner's after it."""
    overrides = TINY + ["system.explore_steps=18", "system.buffer_size=16"]  # 6 steps: a wrap, a reset
    cfg = _prepare(jax_load_config("default_ff_masac", overrides))
    explore, _, jstate = jff_isac.build_bench_learners(cfg, make_mesh(jax.devices()[:1]), True)
    jstate = jax.device_get(jstate)
    jnew, jmetrics = jax.device_get(explore(jstate))

    tcfg = _prepare(load_config("default_ff_masac", overrides + ["+arch.device=cpu"]))
    tenv, _ = tenvs.make(tcfg, "cpu", add_global_state=True)
    explore_fn, _, _, state = ff_isac.learner_setup(
        tenv, torch.Generator().manual_seed(0), tcfg, torch.device("cpu"), True)
    state = state._replace(obs=type(state.obs)(*(_t(x) for x in jstate.obs)),
                           env_state=to_torch_state(jstate.env_state))
    key, env_keys = jstate.key[0], jstate.env_state.env_state.key
    actions, env_noise = [], []
    for done in np.asarray(jmetrics["is_terminal_step"]):  # (steps, E)
        key, explore_key = jax.random.split(key)
        actions.append(np.asarray(jax.random.uniform(explore_key, (3, 3, 2), minval=-1.0, maxval=1.0)))
        env_noise.append((None, MaSwarmResetNoise(*map(_t, jax.vmap(
            lambda k: auto_reset_draws(k, tenv))(env_keys)))))
        reset_keys = jax.vmap(lambda k: jax.random.split(jax.random.split(k)[0], 3)[0])(env_keys)
        env_keys = jnp.where(jnp.asarray(done)[:, None], reset_keys, env_keys)
    assert np.asarray(jmetrics["is_terminal_step"]).any()
    new, metrics = explore_fn(state, Draws(explore=torch.tensor(np.stack(actions)),
                                           env_noise=env_noise))
    assert new.t == int(np.asarray(jnew.t)) == 18
    assert (new.buffer_state.current_index, new.buffer_state.is_full) == (2, True)
    for got, want in zip(jax.tree.leaves(tuple(new.buffer_state.experience)),
                         jax.tree.leaves(jnew.buffer_state.experience)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)
    for got, want in zip(jax.tree.leaves(tuple(new.obs)), jax.tree.leaves(jnew.obs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIST_TOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), err_msg=k, **DIST_TOL)


# ------------------------------------------------------------------ kept behaviour
def _setup(overrides=(), centralised=False, system="default_ff_isac"):
    cfg = _prepare(load_config(system, TINY + list(overrides) + ["+arch.device=cpu"]))
    env, _ = tenvs.make(cfg, "cpu", add_global_state=centralised)
    explore, learn, _, state = ff_isac.learner_setup(
        env, torch.Generator().manual_seed(1), cfg, torch.device("cpu"), centralised)
    return cfg, explore, learn, state


def test_targets_start_as_copies_and_optimizers_follow_the_reference():
    """Targets are copies of the online critics, not fresh draws; each
    optimizer is clip-then-Adam at eps 1e-8; the Q optimizer clips by the
    global norm over q1 and q2 together."""
    cfg, _, _, state = _setup()
    online, targets = state.params.q
    for o, t in zip(online, targets):
        assert o is not t
        for a, b in zip(o.parameters(), t.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert not torch.equal(online.q1.q_head.weight, online.q2.q_head.weight)
    assert all(opt.eps == 1e-8 for opt in state.opt_states)
    q_opt = state.opt_states.q
    q_params = [*online.q1.parameters(), *online.q2.parameters()]
    assert len(q_opt.params) == len(q_params) and all(
        a is b for a, b in zip(q_opt.params, q_params))
    # One step on gradients whose joint norm is 20 at max_grad_norm 10: every
    # gradient, q1's and q2's alike, is scaled by 10 / 20 before Adam.
    grads = [torch.zeros_like(p) for p in q_params]
    grads[0].view(-1)[0] = 12.0  # q1
    grads[-1].view(-1)[0] = 16.0  # q2
    q_opt.step(grads)
    assert cfg.system.max_grad_norm == 10
    assert torch.allclose(q_opt.mu[0].view(-1)[0], torch.tensor(0.1 * 12.0 * 0.5))
    assert torch.allclose(q_opt.mu[-1].view(-1)[0], torch.tensor(0.1 * 16.0 * 0.5))


def test_explore_draws_uniform_on_minus_one_one():
    cfg, explore, _, state = _setup(["system.explore_steps=600", "system.buffer_size=900"])
    state, metrics = explore(state)
    assert state.t == 600 and state.buffer_state.current_index == 600
    actions = state.buffer_state.experience.action[:600]
    assert actions.min() >= -1.0 and actions.max() <= 1.0
    assert (actions < -0.9).any() and (actions > 0.9).any()
    assert abs(actions.mean().item()) < 0.05  # centred on 0, not on 0.5
    assert metrics["episode_return"].shape == (200, 3)


def test_actor_delay_follows_the_epoch_index():
    """With 6 epochs and a delay of 3: actor and alpha steps on epochs 0 and 3,
    3 of each, whatever the env-step count."""
    _, explore, learn, state = _setup(["system.epochs=6", "system.policy_update_delay=3"])
    state, _ = explore(state)
    for t in (state.t, 7):  # a count that no delay divides
        before = [opt.count for opt in state.opt_states]  # the optimizers step in place
        out = learn(state._replace(t=t))
        loss = out.train_metrics["actor_loss"][0]
        assert [bool(x != 0) for x in loss] == [True, False, False, True, False, False]
        steps = [opt.count - b for opt, b in zip(out.learner_state.opt_states, before)]
        assert steps == [6, 6, 6]  # actor, q, alpha
        state = out.learner_state


@pytest.mark.parametrize("greedy", [True, False])
def test_ff_eval_act_fn_takes_a_tanh_normal(greedy):
    """The evaluator's act fn on the SAC actor: tanh(loc) when greedy, else a
    sample with the normals of the evaluator's generator."""
    cfg, _, _, state = _setup([f"arch.evaluation_greedy={greedy}"])
    act_fn = make_ff_eval_act_fn(cfg)
    timestep = SimpleNamespace(observation=state.obs)
    with torch.no_grad():
        action, actor_state = act_fn(state.params.actor, timestep, torch.Generator().manual_seed(3), {})
        pi = state.params.actor(state.obs)
        noise = torch.randn(pi.loc.shape, generator=torch.Generator().manual_seed(3))
    assert actor_state == {} and action.shape == (3, 3, 2)
    assert torch.equal(action, pi.mode() if greedy else pi.sample_from_noise(noise))
    assert action.abs().max() <= 1.0


def test_stagger_resets_raise():
    with pytest.raises(ValueError, match="stagger_resets"):
        _setup(["arch.stagger_resets=True"])


# ------------------------------------------------------------------ CLI
CLI = ["system.total_timesteps=240", "arch.num_evaluation=2", "arch.num_envs=4",
       "system.explore_steps=40", "system.epochs=4", "system.policy_update_delay=2",
       "arch.num_eval_episodes=4", "arch.num_absolute_metric_eval_episodes=4",
       "network.actor_network.pre_torso.layer_sizes=[32]",
       "network.critic_network.pre_torso.layer_sizes=[32]", "+arch.device=cpu"]


@pytest.mark.parametrize("env_overrides", [
    ["env.kwargs.time_limit=16"],
    ["env=mareacher", "env.kwargs.time_limit=8"],
], ids=["maswarm", "mareacher"])
def test_cli_end_to_end(monkeypatch, capsys, env_overrides):
    monkeypatch.setattr(sys, "argv", ["ff_isac", *CLI, *env_overrides])
    performance = ff_isac.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    assert "ISAC experiment completed." in captured.out
    logged = captured.out + captured.err
    # The explore phase logs first; then rounds of 240 // 2 env-steps from its
    # 40 up to 240 (the reference's range(40, 241, 120)), logged at their ends.
    assert "Step: 40" in logged and "Timestep: 160" in logged and "Timestep: 280" in logged
    assert "Timestep: 400" not in logged
    assert "Log alpha" in logged and "Q1 a vals" in logged and "ABSOLUTE" in logged


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        ff_isac.run_experiment(load_config("default_ff_isac", ["system.num_updates=2"]))
