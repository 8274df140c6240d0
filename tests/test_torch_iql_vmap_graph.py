"""The stacked rec-IQL update as its inputs and one body on device tensors
(`advanced_usage/rec_iql_vmap_seeds.py`, `utils/cuda_graphs.py`
`CapturedPhase`), and the stacked trajectory ring's parts that the body uses
(`replay/stacked.py`).

On the CPU: updates drawn by the stacked learner are bitwise the updates of
the loop as it stood before the split (kept here, its draws taken from its own
learner's generator in its order: every act step's Gumbel noise, each act
step's env noise, then each epoch's rows and starts), through rings that wrap
twice, for S = 2 seeds and a sweep of 2 learning rates (whose draws are one
entry's, expanded), with the soft and the hard target update; the inputs'
ring positions, sequence starts, epsilons and hard-update flags are what the
host counters give; the body makes no host read and the same ops at every
call; no graph is built. On the card (`gpu`): three updates replayed are
bitwise three op by op with the exact stacked GRU launches, and a state whose
rings moved to new storage captures once more.

No JAX learner is built here: the stacked learner's parity with the JAX
vmapped one is `tests/test_torch_rec_iql_vmap.py`'s. On the card (where JAX
is not installed) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_iql_vmap_graph.py -q
"""

import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs
from mava_tpu_torch.advanced_usage import common, rec_iql_vmap_seeds as vs
from mava_tpu_torch.distributions import gumbel
from mava_tpu_torch.networks import stack_observation
from mava_tpu_torch.ops import gru
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.systems.anakin import stack_trees
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.q_learning.types import Draws, Transition
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.training import soft_update
from test_torch_iql_graph import ENVS, HARD, HOST_BOUND, TINY, UPDATES, OpRecorder, periodic_update

torch.set_num_threads(1)
LRS = [3e-4, 1e-3]
CASES = {"seeds-soft": (None, []), "seeds-hard": (None, HARD), "sweep-soft": (LRS, []),
         "sweep-hard": (LRS, HARD)}
# Launches of one stacked update (epochs = 2) at any S (chip_smoke.IQL_VMAP_PER_UPDATE).
PER_UPDATE = {"fwd_stacked": 4, "bwd_gates_stacked": 2, "bwd_recurrence_stacked": 2,
              "bwd_reduce_stacked": 2, "bwd_reduce_sum_stacked": 2}


def stacked(sweep=None, device="cpu", overrides=(), env_name="rware"):
    """(config, env, learn, state, num, shared) of a tiny stacked rec-IQL
    learner of 2 seeds (or one entry a learning rate of `sweep`) from seed 1,
    one update a call."""
    cfg = load_config("default_rec_iql", TINY + ENVS[env_name] + list(overrides)
                      + [f"+arch.device={torch.device(device).type}"])
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = 1
    env, _ = envs.make(cfg, device)
    num, shared = (2, False) if sweep is None else (len(sweep), True)
    learn, _, state = vs.learner_setup(env, torch.Generator(device=device).manual_seed(1), cfg,
                                       torch.device(device), num, sweep)
    return cfg, env, learn, state, num, shared


def pre_split_update(cfg, env, buffer, num, shared, state):
    """One stacked update as the learner made it before its split into inputs
    and a body: its draws from the state's generator as it went, the rings'
    host counters read in the loop, the hard update's test on the host."""
    sys_cfg = cfg.system
    num_envs, agents, rollout = cfg.arch.num_envs, sys_cfg.num_agents, sys_cfg.rollout_length
    online, _ = state.params
    obs, terminal, term_or_trunc = state.obs, state.terminal, state.term_or_trunc
    hidden, env_state, buffer_state = state.hidden_state, state.env_state, state.buffer_state
    t = state.time_steps
    device = terminal.device
    draw = common.Draws(num, shared, state.key, device)
    action_noise = draw(gumbel, (rollout, num_envs, agents, env.action_dim))
    metrics = []
    with torch.no_grad():
        for step in range(rollout):
            eps = rec_iql.epsilon_schedule(cfg, t).to(device)
            entry_obs = stack_observation(obs, num)
            resets = term_or_trunc.reshape(num, 1, num_envs, 1)
            hidden, greedy = online(hidden, (vs.one_step(entry_obs), resets), eps)
            action = greedy.sample_from_noise(action_noise[:, step][:, None])[:, 0]
            t += num_envs
            env_state, timestep = env.step(env_state, action.flatten(0, 1),
                                           draw.env(env, num_envs))
            transition = Transition(
                entry_obs, action, timestep.reward.reshape(num, num_envs, agents),
                terminal.reshape(num, num_envs, 1), term_or_trunc.reshape(num, num_envs, 1),
                stack_observation(timestep.extras["real_next_obs"], num))
            buffer_state = buffer.add(buffer_state,
                                      pytree.tree_map(lambda x: x[:, :, None], transition))
            obs = timestep.observation
            terminal = (1 - timestep.discount[:, :1]) != 0
            term_or_trunc = timestep.last()[:, None]
            metrics.append(timestep.extras["episode_metrics"])
    losses = []
    for epoch in range(sys_cfg.epochs):
        rows, starts = buffer.sample_indices(buffer_state, draw)
        data = buffer.sample(buffer_state, rows, starts)
        q_loss, q_online, target = vs.q_loss_pass(state.params, data, sys_cfg.gamma, True)
        grads = torch.autograd.grad(q_loss.sum(), state.params.online.parameters())
        state.opt_state.step(grads)
        if sys_cfg.hard_update:
            periodic_update(state.params.target, state.params.online,
                            state.train_steps + epoch, sys_cfg.update_period)
        else:
            soft_update(state.params.target, state.params.online, sys_cfg.tau)
        losses.append({"q_loss": q_loss.detach(), "mean_q": common.per_entry_mean(q_online.detach()),
                       "mean_target": common.per_entry_mean(target)})
    new = state._replace(obs=obs, terminal=terminal, term_or_trunc=term_or_trunc,
                         hidden_state=hidden, env_state=env_state, time_steps=t,
                         train_steps=state.train_steps + sys_cfg.epochs, buffer_state=buffer_state)
    return new, stack_trees(metrics), stack_trees(losses)


def leaves(state, metrics, losses) -> dict:
    """Every tensor of a stacked update's result, by name."""
    out = {f"param {i}": p.detach() for i, p in
           enumerate(p for net in state.params for p in net.parameters())}
    opt = state.opt_state
    out.update({f"adam {i}": m for i, m in enumerate([*opt.mu, *opt.nu, opt.device_count])})
    out.update({f"ring {i}": x for i, x in
                enumerate(pytree.tree_leaves(state.buffer_state.experience))})
    carry = (state.obs, state.terminal, state.term_or_trunc, state.hidden_state, state.env_state)
    out.update({f"carry {i}": x for i, x in enumerate(pytree.tree_leaves(carry))})
    out.update({f"metric {k}": v for k, v in metrics.items()})
    out.update({f"loss {k}": v for k, v in losses.items()})
    return out


def out_leaves(out) -> dict:
    return leaves(out.learner_state, out.episode_metrics, out.train_metrics)


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def host_counts(state):
    return (state.time_steps, state.train_steps, state.buffer_state.current_index,
            state.buffer_state.is_full, state.opt_state.count)


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_are_the_pre_split_loop(case):
    sweep, overrides = CASES[case]
    cfg, env, learn, state, num, shared = stacked(sweep, overrides=overrides)
    *_, old, _, _ = stacked(sweep, overrides=overrides)
    buffer = rec_iql.make_buffer(cfg, entries=num)
    wraps = 0
    for _ in range(UPDATES):
        out = learn(state)
        old, metrics, losses = pre_split_update(cfg, env, buffer, num, shared, old)
        state = out.learner_state
        assert_same(out_leaves(out), leaves(
            old, pytree.tree_map(lambda x: x[None], metrics),
            {k: v[None].movedim(-1, 0) for k, v in losses.items()}))
        assert host_counts(state) == host_counts(old)
        assert torch.equal(state.key.get_state(), old.key.get_state())
        wraps += state.buffer_state.current_index < cfg.system.rollout_length
    assert wraps == 2 and state.buffer_state.is_full
    first = state.params.online.parameters()[0]
    assert not torch.equal(first[0], first[1])  # seeds by their init, a sweep by its lrs


def test_inputs_hold_what_the_host_counters_say():
    """Ring positions, sequence starts, epsilons and hard-update flags of each
    update's inputs, against the counters read here; handed-in draws (S,
    epochs, B) are taken as they are, their logical starts made ring
    positions."""
    cfg, env, learn, state, num, _ = stacked(overrides=HARD)
    sys_cfg = cfg.system
    length, rollout = sys_cfg.buffer_size, sys_cfg.rollout_length
    gen = torch.Generator().manual_seed(5)
    shape = (num, sys_cfg.epochs, sys_cfg.sample_batch_size)
    for _ in range(UPDATES):
        rows = torch.randint(0, 2, shape, generator=gen)
        starts = torch.randint(0, 3, shape, generator=gen)
        inputs = learn.update.draw(state, Draws(rows=rows, starts=starts))
        index, full = state.buffer_state.current_index, state.buffer_state.is_full
        assert inputs.positions.tolist() == [(index + k) % length for k in range(rollout)]
        index_after = (index + rollout) % length
        oldest = index_after if full or index + rollout >= length else 0
        assert torch.equal(inputs.starts, (oldest + starts) % length)
        assert inputs.rows is rows
        assert inputs.replace.tolist() == [(state.train_steps + e) % sys_cfg.update_period == 0
                                           for e in range(sys_cfg.epochs)]
        want = [rec_iql.epsilon_schedule(cfg, state.time_steps + k * cfg.arch.num_envs)
                for k in range(rollout)]
        assert torch.equal(inputs.epsilon, torch.stack(want))
        assert inputs.carry.hidden_state is state.hidden_state
        assert inputs.action_noise.shape[:3] == (num, rollout, cfg.arch.num_envs)
        state = learn(state).learner_state
    assert state.buffer_state.is_full


def test_drawn_sequences_are_each_entrys_own():
    """Drawn by the learner, every entry's rows and starts (S, epochs, B) are
    its own, and the starts fall among the valid ones of the rings after the
    act steps' writes."""
    cfg, _, learn, state, num, _ = stacked()
    buffer = rec_iql.make_buffer(cfg, entries=num)
    for _ in range(3):
        inputs = learn.update.draw(state, Draws())
        after = buffer.advance(state.buffer_state, cfg.system.rollout_length)
        assert inputs.rows.shape == inputs.starts.shape == (
            num, cfg.system.epochs, cfg.system.sample_batch_size)
        logical = (inputs.starts - (after.current_index if after.is_full else 0)) % \
            cfg.system.buffer_size
        assert int(logical.max()) < buffer.num_starts(after)
        assert not torch.equal(inputs.rows[0], inputs.rows[1])
        state = learn(state).learner_state


# ------------------------------------------------------------------ no host read
@pytest.mark.parametrize("case", ["seeds-hard", "sweep-soft"])
def test_body_reads_nothing_back_and_repeats_its_ops(case):
    sweep, overrides = CASES[case]
    _, _, learn, state, _, _ = stacked(sweep, overrides=overrides)
    for _ in range(2):
        state = learn(state).learner_state
    inputs = learn.update.draw(state, Draws())
    recorded = []
    for _ in range(2):
        with OpRecorder() as rec:
            _, _, losses = learn.update.body(state, inputs)
        recorded.append(rec.ops)
        assert all(torch.isfinite(v).all() for v in losses.values())
    assert not set(recorded[0]) & HOST_BOUND, set(recorded[0]) & HOST_BOUND
    assert recorded[0] == recorded[1]
    assert len(recorded[0]) > 200


def test_cpu_learner_builds_no_graph():
    _, _, learn, state, _, _ = stacked(LRS)
    for _ in range(2):
        state = learn(state).learner_state
    assert learn.update.graph is None and learn.update.captures == 0


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the update is captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


WIDE = ["network.hidden_state_dim=64"]  # the resident route, K2p included


def _launches():
    return (dict(gru.kernel_launches), dict(gru.launch_shapes), gru.fwd_launches,
            gru.bwd_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("case,env_name", [("seeds-hard", "rware"), ("sweep-soft", "smax")])
def test_replayed_update_is_the_eager_one(cuda, case, env_name):
    """Three updates replayed (the first runs the body and captures it)
    against three op by op: bitwise, the generator and host counts alike; the
    stacked GRU launches exactly those op by op and `PER_UPDATE` an update,
    no unstacked launch; one graph, no re-capture."""
    sweep, overrides = CASES[case]
    _, _, learn, state, _, _ = stacked(sweep, cuda, WIDE + overrides, env_name)
    _, _, learn_eager, state_eager, _, _ = stacked(sweep, cuda, WIDE + overrides, env_name)
    learn_eager.update = learn_eager.update.eager
    reduces = mesh_module.all_reduces
    counts = {}
    for route in ("graph", "eager"):
        gru.reset_launch_counts()
        run, st = (learn, state) if route == "graph" else (learn_eager, state_eager)
        outs = []
        for _ in range(3):
            out = run(st)
            st = out.learner_state
            outs.append(out_leaves(out))
        counts[route] = (_launches(), host_counts(st), st.key.get_state(), outs)
    (launches, host, key, outs), (launches_e, host_e, key_e, outs_e) = (
        counts["graph"], counts["eager"])
    for got, want in zip(outs, outs_e):
        assert_same(got, want)
    assert host == host_e and torch.equal(key, key_e)
    assert launches == launches_e
    assert {k: v for k, v in launches[0].items() if v} == {k: 3 * n for k, n in PER_UPDATE.items()}
    assert mesh_module.all_reduces == reduces  # no data group: no collective
    assert learn.update.captures == 1 and learn.update.recaptures == 0


@pytest.mark.gpu
def test_a_state_at_new_addresses_captures_once_more(cuda):
    """A stacked learner state whose rings were copied into new storage (what a
    restore makes of them; the stacked programs keep no checkpoint) is not at
    the captured addresses: the next update captures again (once), and goes
    on as an eager learner moved the same way."""
    _, _, learn, state, _, _ = stacked(None, cuda, WIDE, "smax")
    _, _, learn_eager, state_eager, _, _ = stacked(None, cuda, WIDE, "smax")
    learn_eager.update = learn_eager.update.eager
    state = learn(state).learner_state
    state_eager = learn_eager(state_eager).learner_state

    def moved(st):
        ring = st.buffer_state
        return st._replace(buffer_state=ring._replace(
            experience=pytree.tree_map(torch.clone, ring.experience)))

    state, state_eager = moved(state), moved(state_eager)
    for _ in range(2):
        out, out_eager = learn(state), learn_eager(state_eager)
        state, state_eager = out.learner_state, out_eager.learner_state
        assert_same(out_leaves(out), out_leaves(out_eager))
    assert learn.update.captures == 2 and learn.update.recaptures == 1
