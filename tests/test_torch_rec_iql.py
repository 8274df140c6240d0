"""rec-IQL of the port against `mava_tpu`'s: the trajectory buffer (exact), the
epsilon-greedy distribution (1e-6), `RecQNetwork` and its fused target pass
(1e-5), the stacked plain GRU against `jax.vmap` of the Pallas GRU in interpret
mode (1e-6), one whole update against the 1-device-mesh JAX learner (1e-5) and
the CLI on the CPU.

The update test warms the JAX learner up for a few updates (the buffer wraps),
converts its whole state, and hands the port the draws of the next JAX update,
recomputed from its keys (rec_iql.py:84-132, :233-244): the Gumbel noise of
each epsilon-greedy sample, the env's request Gumbels and auto-reset uniforms,
and the buffer's (rows, starts).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu.distributions import MaskedEpsGreedy as JMaskedEpsGreedy
from mava_tpu.distributions import masked_greedy as jmasked_greedy
from mava_tpu.networks import RecQNetwork as JRecQNetwork
from mava_tpu.networks.factory import make_torso as jmake_torso
from mava_tpu.ops.pallas_gru import gru_sequence as jax_gru_sequence
from mava_tpu.parallel import make_mesh
from mava_tpu.replay import make_trajectory_buffer
from mava_tpu.systems.q_learning import rec_iql as jrec_iql
from mava_tpu.types import Observation as JObservation
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.distributions import MaskedEpsGreedy, masked_greedy
from mava_tpu_torch.envs.rware import RwareResetNoise
from mava_tpu_torch.networks import RecQNetwork
from mava_tpu_torch.networks.factory import make_torso
from mava_tpu_torch.ops import gru
from mava_tpu_torch.replay import TrajectoryBuffer, TrajectoryBufferState
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.q_learning.types import Draws, Transition
from mava_tpu_torch.types import Observation
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from mava_tpu_torch.utils.training import warn_q_divergence
from test_torch_rware import _to_torch_state, _step_draws

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = [
    "arch.num_envs=2",
    "system.rollout_length=2",
    "system.epochs=2",
    "system.buffer_size=7",
    "system.min_buffer_size=2",
    "system.sample_batch_size=3",
    "system.sample_sequence_length=3",
    "system.eps_decay=40",
    "network.hidden_state_dim=16",
    "network.q_network.pre_torso.layer_sizes=[16]",
    "network.q_network.post_torso.layer_sizes=[16]",
    "env.kwargs.time_limit=50",
    "logger.use_console=False",
]
WARMUP_UPDATES = 4


def _tree_to_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


# ------------------------------------------------------------------ buffer
def test_buffer_add_with_wrap_and_sample_from_injected_indices():
    kw = dict(sample_sequence_length=3, period=1, add_batch_size=2, sample_batch_size=5,
              max_length_time_axis=7, min_length_time_axis=4)
    jbuf, tbuf = make_trajectory_buffer(**kw), TrajectoryBuffer(**kw)
    rng = np.random.default_rng(0)
    dummy = {"x": np.zeros((3,), np.float32), "m": np.zeros((2,), bool)}
    jstate = jbuf.init(jax.tree.map(jnp.asarray, dummy))
    tstate = tbuf.init(_tree_to_torch(dummy))
    key = jax.random.PRNGKey(0)
    for t_add in (2, 1, 3, 4, 2):  # the third slab fills it, the fourth wraps
        batch = {"x": rng.standard_normal((2, t_add, 3)).astype(np.float32),
                 "m": rng.random((2, t_add, 2)) < 0.5}
        jstate = jbuf.add(jstate, jax.tree.map(jnp.asarray, batch))
        tstate = tbuf.add(tstate, _tree_to_torch(batch))
        assert (tstate.current_index, tstate.is_full) == (int(jstate.current_index),
                                                           bool(jstate.is_full))
        assert tbuf.can_sample(tstate) == bool(jbuf.can_sample(jstate))
        for name in dummy:
            np.testing.assert_array_equal(tstate.experience[name].numpy(),
                                          np.asarray(jstate.experience[name]))
        # The reference's draws (trajectory_buffer.py:124-134), then the gather.
        key, sample_key = jax.random.split(key)
        row_key, start_key = jax.random.split(sample_key)
        rows = jax.random.randint(row_key, (5,), 0, 2)
        starts = jax.random.randint(start_key, (5,), 0, tbuf.num_starts(tstate))
        want = jbuf.sample(jstate, sample_key).experience
        got = tbuf.sample(tstate, torch.tensor(np.asarray(rows)), torch.tensor(np.asarray(starts)))
        for name in dummy:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert tstate.is_full


def test_buffer_shorter_than_a_sequence_reads_zero_rows():
    """As the reference: one start and the unwritten rows of the ring."""
    buf = TrajectoryBuffer(5, 1, 1, 2, 8, 1)
    state = buf.add(buf.init({"x": torch.zeros(())}), {"x": torch.ones(1, 2)})
    assert buf.num_starts(state) == 1
    rows, starts = buf.sample_indices(state, torch.Generator().manual_seed(0))
    assert starts.tolist() == [0, 0]
    got = buf.sample(state, rows, starts)["x"]
    assert got.tolist() == [[1.0, 1.0, 0.0, 0.0, 0.0]] * 2
    with pytest.raises(ValueError):
        TrajectoryBuffer(9, 1, 1, 2, 8, 1)


# ------------------------------------------------------------------ distribution
@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_masked_eps_greedy_matches(eps):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, 3, 7)).astype(np.float32)
    mask = rng.random((4, 3, 7)) < 0.6
    mask[..., 0] = True
    key = jax.random.PRNGKey(3)
    jdist = JMaskedEpsGreedy(jnp.asarray(q), eps, jnp.asarray(mask))
    tdist = MaskedEpsGreedy(torch.tensor(q), eps, torch.tensor(mask))
    np.testing.assert_allclose(tdist.logits.numpy(), np.asarray(jdist.logits), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tdist.mode().numpy(), np.asarray(jdist.mode()))
    np.testing.assert_array_equal(masked_greedy(torch.tensor(q), torch.tensor(mask)).numpy(),
                                  np.asarray(jmasked_greedy(jnp.asarray(q), jnp.asarray(mask))))
    noise = jax.random.gumbel(key, q.shape)  # what `categorical` draws from `key`
    np.testing.assert_array_equal(tdist.sample_from_noise(torch.tensor(np.asarray(noise))).numpy(),
                                  np.asarray(jdist.sample(seed=key)))


def test_warn_q_divergence():
    with pytest.warns(UserWarning, match="mean_q"):
        assert warn_q_divergence({"mean_q": torch.tensor([1.0, -2e3]), "q_loss": 1e9}, 1e3)
    with pytest.warns(UserWarning, match="mean_target"):
        assert warn_q_divergence({"mean_target": torch.tensor(float("nan"))}, 1e3)
    assert not warn_q_divergence({"mean_q": torch.tensor([5.0])}, 1e3)


# ------------------------------------------------------------------ networks and GRU
def _q_networks(gru_impl, overrides=()):
    cfg = jax_load_config("default_rec_iql", TINY + list(overrides))
    net = cfg.network
    jnet = JRecQNetwork(jmake_torso(net.q_network.pre_torso), jmake_torso(net.q_network.post_torso),
                        6, net.hidden_state_dim)
    tnet = RecQNetwork(make_torso(net.q_network.pre_torso, 9),
                       make_torso(net.q_network.post_torso, net.hidden_state_dim),
                       6, net.hidden_state_dim, gru_impl)
    return jnet, tnet


def _q_inputs(t_len=5, b=3, a=2, seed=2):
    rng = np.random.default_rng(seed)
    view = rng.standard_normal((t_len, b, a, 9)).astype(np.float32)
    mask = rng.random((t_len, b, a, 6)) < 0.7
    mask[..., 0] = True
    resets = rng.random((t_len, b, 1)) < 0.3
    hidden = rng.standard_normal((b, a, 16)).astype(np.float32)
    step = np.zeros((t_len, b, a), np.int32)
    jin = (JObservation(jnp.asarray(view), jnp.asarray(mask), jnp.asarray(step)), jnp.asarray(resets))
    tin = (Observation(torch.tensor(view), torch.tensor(mask), torch.tensor(step)),
           torch.tensor(resets))
    return hidden, jin, tin


@pytest.mark.parametrize("gru_impl", ["hoisted", "pallas"])
def test_rec_q_network_outputs_and_grads_match(gru_impl):
    jnet, tnet = _q_networks(gru_impl)
    hidden, jin, tin = _q_inputs()
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(hidden), jin)
    tnet.load_state_dict(from_flax_params(jax.device_get(params), head="q_head"), strict=True)
    weights = np.linspace(-1, 1, 5 * 3 * 2 * 6, dtype=np.float32).reshape(5, 3, 2, 6)

    def jloss(p):
        h, q = jnet.apply(p, jnp.asarray(hidden), jin, method="get_q_values")
        return jnp.sum(q * weights) + jnp.sum(h), (h, q)

    (_, (jh, jq)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    th, tq = tnet.get_q_values(torch.tensor(hidden), tin)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    (torch.sum(tq * torch.tensor(weights)) + th.sum()).backward()
    want = from_flax_params(jax.device_get(jgrads), head="q_head")
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)

    _, jdist = jnet.apply(params, jnp.asarray(hidden), jin, 0.25)
    _, tdist = tnet(torch.tensor(hidden), tin, 0.25)
    np.testing.assert_allclose(tdist.logits.detach().numpy(), np.asarray(jdist.logits), **TOL)


@pytest.mark.parametrize(
    "gru_impl,layer_norm", [("hoisted", False), ("pallas", False), ("hoisted", True), ("pallas", True)],
    ids=["hoisted", "pallas", "hoisted-layer_norm", "pallas-layer_norm"])
def test_fused_target_pass_matches_jax_vmap_of_stacked_params(gru_impl, layer_norm):
    """`stacked_q_values(online, target)` against the reference's fused pass:
    `jax.vmap` of `get_q_values` over the stacked parameters (rec_iql.py:183-189),
    and against the two networks run one by one. With `layer_norm` both torsos
    normalise and every parameter is moved off its initial value, so that a
    norm bias (zero at init) the fused pass dropped would show."""
    overrides = [f"network.q_network.{torso}.use_layer_norm={layer_norm}"
                 for torso in ("pre_torso", "post_torso")]
    perturb = 0.1 if layer_norm else 0.0
    jnet, online = _q_networks(gru_impl, overrides)
    _, target = _q_networks(gru_impl, overrides)
    hidden, jin, tin = _q_inputs(seed=4)
    rng = np.random.default_rng(5)
    shift = lambda p: jax.tree.map(  # noqa: E731
        lambda x: x + perturb * rng.standard_normal(x.shape).astype(np.float32), p)
    p_online = shift(jnet.init(jax.random.PRNGKey(1), jnp.asarray(hidden), jin))
    p_target = shift(jnet.init(jax.random.PRNGKey(2), jnp.asarray(hidden), jin))
    online.load_state_dict(from_flax_params(jax.device_get(p_online), head="q_head"))
    target.load_state_dict(from_flax_params(jax.device_get(p_target), head="q_head"))
    stacked = jax.tree.map(lambda o, t: jnp.stack([o, t]), p_online, p_target)
    _, jq = jax.vmap(lambda p: jnet.apply(p, jnp.asarray(hidden), jin, method="get_q_values"))(stacked)
    tq = RecQNetwork.stacked_q_values(online, target, torch.tensor(hidden), tin)
    assert not tq.requires_grad
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    for s, net in enumerate((online, target)):  # the unfused networks, one by one
        np.testing.assert_allclose(tq[s].numpy(), net.get_q_values(torch.tensor(hidden), tin)[1]
                                   .detach().numpy(), **TOL)


@pytest.mark.parametrize("stack,t_len,b,h", [(2, 6, 5, 16), (3, 4, 2, 8)])
def test_stacked_plain_gru_matches_jax_vmap_of_pallas(stack, t_len, b, h):
    rng = np.random.default_rng(stack + t_len)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    keep = np.ascontiguousarray(np.broadcast_to(
        (rng.random((t_len, b, 1)) >= 0.3).astype(np.float32), (t_len, b, h)))
    args = tuple(a.astype(np.float32) for a in (
        f32(stack, t_len, b, 3 * h), keep, f32(stack, b, h),
        f32(stack, h, 3 * h) / np.sqrt(h), 0.1 * f32(stack, h)))
    want = jax.vmap(jax_gru_sequence, in_axes=(0, None, 0, 0, 0))(*map(jnp.asarray, args))
    targs = [torch.tensor(a) for a in args]
    counts = dict(gru.kernel_launches)
    got = gru.gru_sequence_stacked(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), gru.gru_sequence_stacked_reference(*targs).numpy())
    assert gru.kernel_launches == counts  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        gru.gru_sequence_stacked(targs[0], targs[1], targs[2][:1], targs[3], targs[4])


# ------------------------------------------------------------------ one update
def _prepare(cfg):
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = 1
    cfg.system.scan_steps = 1
    return cfg


def _rware_step_key(key, num_agents):
    for _ in range(num_agents):
        key, _ = jax.random.split(key)
    return key


def _env_draws(env_key, dones, unwrapped):
    """The env's draws of each rollout step, from the RWARE key of each env:
    after a step the key is the stepped one, or the auto-reset's (rware.py:229,
    :328-352; wrappers.py:163)."""
    draws = []
    for done in dones:  # (E,) per step
        gumbels, reset = jax.vmap(lambda k: _step_draws(k, unwrapped))(env_key)
        reset_noise = RwareResetNoise(*(torch.tensor(np.asarray(x)) for x in reset))
        draws.append((torch.tensor(np.asarray(gumbels)),
                      reset_noise._replace(agent_dir=reset_noise.agent_dir.long())))
        stepped = jax.vmap(lambda k: _rware_step_key(k, unwrapped.num_agents))(env_key)
        reset_key = jax.vmap(lambda k: jax.random.split(jax.random.split(k)[0], 4)[0])(stepped)
        env_key = jnp.where(jnp.asarray(done)[:, None], reset_key, stepped)
    return draws


def _update_draws(jstate, jout, cfg, unwrapped, buffer, num_starts):
    """The draws of one JAX update (rec_iql.py:236, :104, :206-207 and
    trajectory_buffer.py:124-134)."""
    _, act_key, train_key = jax.random.split(jstate.key[0], 3)
    e, a, n = cfg.arch.num_envs, unwrapped.num_agents, unwrapped.action_dim
    noise = []
    for _ in range(cfg.system.rollout_length):
        act_key, explore_key = jax.random.split(act_key)
        noise.append(np.asarray(jax.random.gumbel(explore_key, (1, e, a, n)))[0])
    rows, starts = [], []
    for _ in range(cfg.system.epochs):
        train_key, buff_key = jax.random.split(train_key)
        row_key, start_key = jax.random.split(buff_key)
        rows.append(np.asarray(jax.random.randint(row_key, (cfg.system.sample_batch_size,), 0, e)))
        starts.append(np.asarray(jax.random.randint(
            start_key, (cfg.system.sample_batch_size,), 0, num_starts)))
    dones = np.asarray(jout[1][0]["is_terminal_step"])[0]  # (rollout, E)
    return Draws(
        action_noise=torch.tensor(np.stack(noise)),
        env_noise=_env_draws(jstate.env_state.env_state.key, dones, unwrapped),
        rows=torch.tensor(np.stack(rows)),
        starts=torch.tensor(np.stack(starts)),
    )


def _load_learner_state(state, jstate):
    """The port's learner state with the JAX learner's: parameters, Adam
    moments and count, buffer, env state, observation, flags and counters."""
    s = jax.device_get(jstate)
    online, target = state.params
    online.load_state_dict(from_flax_params(s.params.online, head="q_head"), strict=True)
    target.load_state_dict(from_flax_params(s.params.target, head="q_head"), strict=True)
    (adam,) = [x for x in jax.tree_util.tree_leaves(s.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(x, "mu")]
    opt = state.opt_state
    for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        values = from_flax_params(tree, head="q_head")
        for m, (name, _) in zip(moments, online.named_parameters()):
            m.copy_(values[name])
    opt.count = int(np.asarray(adam.count))
    exp = _tree_to_torch(s.buffer_state.experience)
    exp = Transition(Observation(*exp.obs), exp.action.long(), exp.reward, exp.terminal,
                     exp.term_or_trunc, Observation(*exp.next_obs))
    buffer_state = TrajectoryBufferState(exp, int(np.asarray(s.buffer_state.current_index)),
                                         bool(np.asarray(s.buffer_state.is_full)))
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    return state._replace(
        obs=Observation(*(t(x) for x in s.obs)),
        terminal=t(s.terminal), term_or_trunc=t(s.term_or_trunc), hidden_state=t(s.hidden_state),
        env_state=_to_torch_state(s.env_state), time_steps=int(np.ravel(s.time_steps)[0]),
        train_steps=int(np.ravel(s.train_steps)[0]), buffer_state=buffer_state,
    )


@pytest.mark.parametrize("fused,hard", [(True, False), (False, True)])
def test_one_update_matches_jax_learner(fused, hard):
    overrides = TINY + [f"system.fused_target_pass={fused}", f"system.hard_update={hard}",
                        "system.update_period=5"]
    cfg = _prepare(jax_load_config("default_rec_iql", overrides))
    mesh = make_mesh(jax.devices()[:1])
    (jenv, _), q_net, opt, rb, jstate, _ = jrec_iql.init(cfg, mesh)
    update = jrec_iql.build_learn_fn(cfg, jenv, q_net, opt, rb, mesh, jstate.buffer_state)
    for _ in range(WARMUP_UPDATES):  # 8 steps into a ring of 7: it has wrapped
        jstate, _ = update(jstate)
    # The update called on the arrays it made, so its compiled program is reused
    # (host copies in would compile it again).
    jout = jax.device_get(update(jstate))
    jstate = jax.device_get(jstate)

    tcfg = _prepare(load_config("default_rec_iql", overrides + ["+arch.device=cpu"]))
    tenv, _ = tenvs.make(tcfg, "cpu")
    unwrapped = jenv.unwrapped
    buffer = rec_iql.make_buffer(tcfg)
    full = bool(np.asarray(jstate.buffer_state.is_full))
    size = tcfg.system.buffer_size if full else int(np.asarray(jstate.buffer_state.current_index))
    size = min(size + tcfg.system.rollout_length, tcfg.system.buffer_size)
    num_starts = max(size - buffer.sample_sequence_length + 1, 1)
    draws = _update_draws(jstate, jout, cfg, unwrapped, buffer, num_starts)
    learn, _, state = rec_iql.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg,
                                            torch.device("cpu"), draws=[draws])
    out = learn(_load_learner_state(state, jstate))

    jnew, (jmetrics, jlosses) = jout
    for name, values in jlosses.items():
        np.testing.assert_allclose(out.train_metrics[name].numpy(), np.asarray(values),
                                   err_msg=name, **TOL)
    for net, jparams in zip(out.learner_state.params, (jnew.params.online, jnew.params.target)):
        want = from_flax_params(jparams, head="q_head")
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=name, **TOL)
    new = out.learner_state
    assert new.time_steps == int(np.ravel(jnew.time_steps)[0])
    assert new.train_steps == int(np.ravel(jnew.train_steps)[0])
    assert new.buffer_state.current_index == int(np.asarray(jnew.buffer_state.current_index))
    np.testing.assert_array_equal(new.buffer_state.experience.action.numpy(),
                                  np.asarray(jnew.buffer_state.experience.action))
    np.testing.assert_allclose(new.hidden_state.numpy(), np.asarray(jnew.hidden_state), **TOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(out.episode_metrics[k].numpy(), np.asarray(v), err_msg=k, **TOL)


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("env_overrides", [
    ["env.kwargs.time_limit=16"],
    ["env=smax", "env/scenario=2s3z", "+env.kwargs.time_limit=16"],
])
def test_cli_end_to_end(monkeypatch, capsys, env_overrides):
    argv = ["rec_iql", "system.num_updates=2", "arch.num_evaluation=1", "arch.num_envs=2",
            "arch.num_eval_episodes=2", "arch.num_absolute_metric_eval_episodes=2",
            "system.sample_batch_size=4", "network.hidden_state_dim=16",
            "system.sample_sequence_length=6", "+arch.device=cpu", *env_overrides]
    monkeypatch.setattr(sys, "argv", argv)
    performance = rec_iql.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    assert "IDQN experiment completed." in captured.out
    logged = captured.out + captured.err
    assert "Epsilon" in logged
    if "env=smax" in env_overrides:  # eval_metric win_rate is what run_experiment returns
        assert "Win rate" in logged and 0.0 <= performance <= 100.0


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        rec_iql.run_experiment(load_config("default_rec_iql", ["system.num_updates=2"]))


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("RUN_LEARNING_GATE") != "1",
                    reason="learning gate is opt-in: set RUN_LEARNING_GATE=1")
def test_rec_iql_learns_matrax_climbing():
    """The port's twin of `test_learning_gate.py::test_rec_iql_learns_matrax_climbing`:
    the same config and threshold (the safe equilibrium pays 50 an episode,
    random about -34)."""
    cfg = load_config("default_rec_iql", [
        "env=matrax",
        "env.scenario.task_name=Climbing-stateless-v0",
        "env.kwargs.time_limit=10",
        "arch.num_envs=16",
        "system.total_timesteps=120000",
        "arch.num_evaluation=3",
        "arch.num_eval_episodes=32",
        "arch.absolute_metric=False",
        "logger.use_console=False",
        "+arch.device=cpu",
    ])
    perf, _ = rec_iql.run_experiment(cfg)
    assert perf > 20.0, f"rec-IQL failed the Climbing learning gate: {perf}"
