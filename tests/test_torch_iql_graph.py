"""The rec-IQL update as its inputs and one body on device tensors
(`systems/q_learning/rec_iql.py`, `utils/cuda_graphs.py` `CapturedPhase`), and
the trajectory ring's parts that the body uses (`replay/trajectory_buffer.py`).

On the CPU: updates drawn by the learner are bitwise the updates of the loop
as it stood before the split (kept here, its draws taken from its own
learner's generator in its order: every act step's Gumbel noise, each act
step's env noise, then each epoch's rows and starts), through a ring that
wraps twice, with the soft and the hard target update; the inputs' ring
positions, sequence starts, epsilons and hard-update flags are what the host
counters give; the body makes no host read and the same ops at every call.
On the card (`gpu`): three updates replayed are bitwise three op by op, a
restore captures once more, the GRU launch counts are exact, and a FLOP
counter sees the products of a replaying learner's update.

This file imports neither JAX nor `mava_tpu`; the tests marked `gpu` skip
without a CUDA device. On the card (where JAX is not installed) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_iql_graph.py -q
"""

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from mava_tpu_torch import envs
from mava_tpu_torch.distributions import gumbel
from mava_tpu_torch.ops import gru
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.systems.anakin import stack_trees
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.q_learning.types import Draws, Transition
from mava_tpu_torch.utils.checkpointing import restore_into, to_host
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.training import soft_update

torch.set_num_threads(1)
UPDATES = 13  # 52 act steps into a ring of 24: it wraps twice
TINY = [
    "arch.num_envs=2",
    "system.rollout_length=4",
    "system.epochs=2",
    "system.buffer_size=24",
    "system.min_buffer_size=2",
    "system.sample_batch_size=3",
    "system.sample_sequence_length=5",
    "system.eps_decay=60",
    "network.hidden_state_dim=16",
    "network.q_network.pre_torso.layer_sizes=[16]",
    "network.q_network.post_torso.layer_sizes=[16]",
    "logger.use_console=False",
]
ENVS = {"rware": ["env.kwargs.time_limit=5"],
        "smax": ["env=smax", "env/scenario=3s_vs_5z", "+env.kwargs.time_limit=5"]}
HARD = ["system.hard_update=True", "system.update_period=3"]
# The ops that read a value back to the host, or copy one from it.
HOST_BOUND = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero",
              "aten.lift_fresh", "aten.equal"}
# Launches of one update at the shipped width on the resident route (chip_smoke.IQL_PER_UPDATE).
PER_UPDATE = {"fwd_stacked": 2, "fwd": 2, "bwd_gates": 2, "bwd_recurrence": 2, "bwd_reduce": 2,
              "bwd_reduce_sum": 2}


def stock(env_name: str = "rware", device="cpu", overrides=()):
    """(config, env, learn, state) of a tiny rec-IQL learner from seed 1, one
    update a call."""
    cfg = load_config("default_rec_iql", TINY + ENVS[env_name] + list(overrides)
                      + [f"+arch.device={torch.device(device).type}"])
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = 1
    env, _ = envs.make(cfg, device)
    learn, _, state = rec_iql.learner_setup(
        env, torch.Generator(device=device).manual_seed(1), cfg, torch.device(device))
    return cfg, env, learn, state


@torch.no_grad()
def periodic_update(target, online, steps: int, update_period: int) -> None:
    """The hard target update as the learner made it before the split: the test on the host."""
    if steps % update_period == 0:
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_(o)


def pre_split_update(cfg, env, buffer, state):
    """One update as the learner made it before its split into inputs and a
    body: its draws from the state's generator as it went, the ring's host
    counters read in the loop, the hard update's test on the host."""
    sys_cfg = cfg.system
    gen, device = state.key, state.terminal.device
    num_envs, rollout = cfg.arch.num_envs, sys_cfg.rollout_length
    online, _ = state.params
    obs, terminal, term_or_trunc = state.obs, state.terminal, state.term_or_trunc
    hidden, env_state, buffer_state, t = (state.hidden_state, state.env_state,
                                          state.buffer_state, state.time_steps)
    action_noise = gumbel((rollout, num_envs, sys_cfg.num_agents, env.action_dim), gen, device)
    metrics = []
    with torch.no_grad():
        for step in range(rollout):
            eps = rec_iql.epsilon_schedule(cfg, t).to(device)
            hidden, greedy = online(hidden, (rec_iql._first(obs), term_or_trunc[None]), eps)
            action = greedy.sample_from_noise(action_noise[step][None])[0]
            t += num_envs
            env_state, timestep = env.step(env_state, action, env.step_noise(num_envs, gen))
            transition = Transition(obs, action, timestep.reward, terminal, term_or_trunc,
                                    timestep.extras["real_next_obs"])
            buffer_state = buffer.add(buffer_state,
                                      pytree.tree_map(lambda x: x[:, None], transition))
            obs = timestep.observation
            terminal = (1 - timestep.discount[:, :1]) != 0
            term_or_trunc = timestep.last()[:, None]
            metrics.append(timestep.extras["episode_metrics"])
    losses = []
    for epoch in range(sys_cfg.epochs):
        data = buffer.sample(buffer_state, *buffer.sample_indices(buffer_state, gen))
        q_loss, q_online, target = rec_iql.q_loss_pass(state.params, data, sys_cfg.gamma, True)
        grads = torch.autograd.grad(q_loss, list(state.params.online.parameters()))
        state.opt_state.step(grads)
        if sys_cfg.hard_update:
            periodic_update(state.params.target, state.params.online,
                            state.train_steps + epoch, sys_cfg.update_period)
        else:
            soft_update(state.params.target, state.params.online, sys_cfg.tau)
        losses.append({"q_loss": q_loss.detach(), "mean_q": q_online.detach().mean(),
                       "mean_target": target.mean()})
    new = state._replace(obs=obs, terminal=terminal, term_or_trunc=term_or_trunc,
                         hidden_state=hidden, env_state=env_state, time_steps=t,
                         train_steps=state.train_steps + sys_cfg.epochs, buffer_state=buffer_state)
    return new, stack_trees(metrics), stack_trees(losses)


def leaves(state, metrics, losses) -> dict:
    """Every tensor of an update's result, by name."""
    out = {f"param {i}": p.detach() for i, p in
           enumerate(p for net in state.params for p in net.parameters())}
    out.update({f"adam {i}": m for i, m in enumerate(state.opt_state.mu + state.opt_state.nu)})
    out.update({f"ring {i}": x for i, x in
                enumerate(pytree.tree_leaves(state.buffer_state.experience))})
    carry = (state.obs, state.terminal, state.term_or_trunc, state.hidden_state, state.env_state)
    out.update({f"carry {i}": x for i, x in enumerate(pytree.tree_leaves(carry))})
    out.update({f"metric {k}": v for k, v in metrics.items()})
    out.update({f"loss {k}": v for k, v in losses.items()})
    return out


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def host_counts(state):
    return (state.time_steps, state.train_steps, state.buffer_state.current_index,
            state.buffer_state.is_full, state.opt_state.count)


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("env_name,overrides", [("rware", []), ("rware", HARD), ("smax", [])],
                         ids=["rware-soft", "rware-hard", "smax-soft"])
def test_updates_are_the_pre_split_loop(env_name, overrides):
    cfg, env, learn, state = stock(env_name, overrides=overrides)
    _, _, _, old = stock(env_name, overrides=overrides)
    buffer = rec_iql.make_buffer(cfg)
    wraps = 0
    for _ in range(UPDATES):
        out = learn(state)
        old, metrics, losses = pre_split_update(cfg, env, buffer, old)
        state = out.learner_state
        assert_same(leaves(state, out.episode_metrics, out.train_metrics),
                    leaves(old, pytree.tree_map(lambda x: x[None], metrics),
                           pytree.tree_map(lambda x: x[None], losses)))
        assert host_counts(state) == host_counts(old)
        assert torch.equal(state.key.get_state(), old.key.get_state())
        wraps += state.buffer_state.current_index < cfg.system.rollout_length
    assert wraps == 2 and state.buffer_state.is_full


def test_inputs_hold_what_the_host_counters_say():
    """Ring positions, sequence starts, epsilons and hard-update flags of each
    update's inputs, against the counters read here; handed-in draws are
    taken as they are, their logical starts made ring positions."""
    cfg, env, learn, state = stock(overrides=HARD)
    sys_cfg, buffer = cfg.system, rec_iql.make_buffer(cfg)
    length, rollout = sys_cfg.buffer_size, sys_cfg.rollout_length
    gen = torch.Generator().manual_seed(5)
    for _ in range(UPDATES):
        rows = torch.randint(0, 2, (sys_cfg.epochs, sys_cfg.sample_batch_size), generator=gen)
        starts = torch.randint(0, 3, (sys_cfg.epochs, sys_cfg.sample_batch_size), generator=gen)
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
        state = learn(state).learner_state


# ------------------------------------------------------------------ no host read
class OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("env_name,overrides", [("rware", HARD), ("smax", [])],
                         ids=["rware-hard", "smax-soft"])
def test_body_reads_nothing_back_and_repeats_its_ops(env_name, overrides):
    _, _, learn, state = stock(env_name, overrides=overrides)
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
    _, _, learn, state = stock()
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
@pytest.mark.parametrize("env_name,overrides", [("rware", HARD), ("smax", [])],
                         ids=["rware-hard", "smax-soft"])
def test_replayed_update_is_the_eager_one(cuda, env_name, overrides):
    """Three updates replayed (the first runs the body and captures it)
    against three op by op: bitwise, the generator and host counts alike; the
    GRU launches of the replayed learner are exactly those op by op; one graph,
    no re-capture."""
    _, _, learn, state = stock(env_name, cuda, WIDE + overrides)
    _, _, learn_eager, state_eager = stock(env_name, cuda, WIDE + overrides)
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
            outs.append(leaves(st, out.episode_metrics, out.train_metrics))
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
def test_a_flop_counter_sees_the_update_of_a_replaying_learner(cuda):
    """Under a dispatch mode the captured update runs op by op, so that
    `FlopCounterMode` (the one `scripts/bench_mfu.py` counts with) sees its
    products, as in an op-by-op learner; the graph is kept and replays after."""
    from torch.utils.flop_counter import FlopCounterMode

    _, _, learn, state = stock("smax", cuda, WIDE)
    _, _, learn_eager, state_eager = stock("smax", cuda, WIDE)
    learn_eager.update = learn_eager.update.eager
    state, state_eager = learn(state).learner_state, learn_eager(state_eager).learner_state
    flops = []
    for run, st in ((learn, state), (learn_eager, state_eager)):
        with FlopCounterMode(display=False) as counter:
            out = run(st)
        flops.append((counter.get_total_flops(), out))
    (replaying, out), (eager, out_eager) = flops
    assert replaying == eager > 0
    assert_same(leaves(out.learner_state, out.episode_metrics, out.train_metrics),
                leaves(out_eager.learner_state, out_eager.episode_metrics,
                       out_eager.train_metrics))
    learn(out.learner_state)
    assert learn.update.captures == 1 and learn.update.recaptures == 0


@pytest.mark.gpu
def test_restore_captures_once_more(cuda):
    """A learner state restored from a checkpoint holds a new ring: the next
    update captures again (once), and goes on as an eager learner restored
    the same way."""
    _, _, learn, state = stock("smax", cuda, WIDE)
    _, _, learn_eager, state_eager = stock("smax", cuda, WIDE)
    learn_eager.update = learn_eager.update.eager
    state = learn(state).learner_state
    state_eager = learn_eager(state_eager).learner_state
    saved = to_host(state)
    state = restore_into(state, saved)
    state_eager = restore_into(state_eager, saved)
    for _ in range(2):
        out, out_eager = learn(state), learn_eager(state_eager)
        state, state_eager = out.learner_state, out_eager.learner_state
        assert_same(leaves(state, out.episode_metrics, out.train_metrics),
                    leaves(state_eager, out_eager.episode_metrics, out_eager.train_metrics))
    assert learn.update.captures == 2 and learn.update.recaptures == 1
