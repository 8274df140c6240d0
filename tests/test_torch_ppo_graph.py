"""The PPO updates as their inputs and one body on device tensors
(`systems/ppo/ff_ippo.py`, which is ff-MAPPO too, and `systems/ppo/rec_ippo.py`,
which is rec-MAPPO too; `utils/cuda_graphs.py` `CapturedPhase`), and the
schedules formed on the device (`utils/training.py`).

On the CPU: updates drawn by the learner are bitwise the updates of the loop
as it stood before the split (kept here, its draws taken from its own
learner's generator in its order: the sampling noise, each step's env noise,
the epochs' shuffles, then a tanh-Normal's entropy normals a minibatch, and
its entropy coefficient and decayed learning rate formed from the host
count), through episode ends, with and without the schedules; the device
forms of the schedules are the host forms bitwise at every count; the body
makes no host read and the same ops at every call; a CPU learner builds no
graph. On the card (`gpu`): three updates replayed are bitwise three op by
op, the GRU launch counts are exact (none on the feed-forward path), a
restore in place replays, a state at other addresses captures once more,
and a FLOP counter sees a replaying learner's products.

This file imports neither JAX nor `mava_tpu`; the tests marked `gpu` skip
without a CUDA device. On the card (where JAX is not installed) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ppo_graph.py -q
"""

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from mava_tpu_torch import envs
from mava_tpu_torch.networks.factory import make_log_prob_from_params, make_rollout_noise_fn
from mava_tpu_torch.ops import clipped_ppo_policy_loss, clipped_value_loss
from mava_tpu_torch.ops import gru
from mava_tpu_torch.ops.gae import calculate_gae, calculate_gae_with_next_done
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.systems.anakin import stack_trees
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.systems.ppo.types import (
    Draws,
    HiddenStates,
    PPOTransition,
    RNNPPOTransition,
)
from mava_tpu_torch.utils.checkpointing import restore_into, to_host
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.training import (
    entropy_schedule,
    epoch_permutations,
    make_learning_rate_schedule,
    make_swept_optimizer,
)

torch.set_num_threads(1)
UPDATES = 3
TINY = [
    "arch.num_envs=2",
    "system.rollout_length=4",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    f"system.num_updates={UPDATES}",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "logger.use_console=False",
]
REC = ["network.hidden_state_dim=16", "network.actor_network.post_torso.layer_sizes=[16]",
       "network.critic_network.post_torso.layer_sizes=[16]", "system.recurrent_chunk_size=2"]
ENVS = {"rware": ["env.kwargs.time_limit=5"],
        "smax": ["env=smax", "env/scenario=2s3z", "+env.kwargs.time_limit=5"],
        "maswarm": ["env=maswarm", "network=continuous_mlp", "env.kwargs.time_limit=5"]}
SCHEDULES = ["system.ent_coef_final=0.001", "system.decay_learning_rates=True"]
# system, env: the four PPO systems on RWARE, rec-IPPO and rec-MAPPO on SMAX,
# ff-IPPO with a continuous head.
CASES = [("ff_ippo", "rware"), ("ff_mappo", "rware"), ("rec_ippo", "rware"),
         ("rec_mappo", "rware"), ("rec_ippo", "smax"), ("rec_mappo", "smax"),
         ("ff_ippo", "maswarm")]
# The ops that read a value back to the host, or copy one from it.
HOST_BOUND = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero",
              "aten.lift_fresh", "aten.equal"}


def stock(system: str, env_name: str = "rware", device="cpu", overrides=()):
    """(config, env, learn, state) of a tiny PPO learner from seed 1, one update a call."""
    recurrent = system.startswith("rec")
    cfg = load_config(f"default_{system}", TINY + (REC if recurrent else []) + ENVS[env_name]
                      + list(overrides) + [f"+arch.device={torch.device(device).type}"])
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = 1
    centralised = system.endswith("mappo")
    env, _ = envs.make(cfg, device, add_global_state=centralised)
    module = rec_ippo if recurrent else ff_ippo
    learn, _, state = module.learner_setup(
        env, torch.Generator(device=device).manual_seed(1), cfg, torch.device(device),
        centralised)
    return cfg, env, learn, state


# ------------------------------------------------------------------ the loop before the split
def host_entropy_coefficient(config, opt):
    """The entropy coefficient as the loop formed it: from the host count."""
    if config.system.get("ent_coef_final", None) is None:
        return config.system.ent_coef
    return float(entropy_schedule(config, opt.count))


@torch.no_grad()
def host_step(opt, grads):
    """`ClippedAdam.step` as it stood: a scheduled rate read at the host count."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < opt.max_grad_norm
    grads = [torch.where(keep, g, (g / g_norm) * opt.max_grad_norm) for g in grads]
    lr = opt.lr(opt.count) if callable(opt.lr) else opt.lr
    bc1, bc2 = opt._advance()
    for p, g, mu, nu in zip(opt.params, grads, opt.mu, opt.nu):
        mu.copy_((1 - opt.b1) * g + opt.b1 * mu)
        nu.copy_((1 - opt.b2) * (g * g) + opt.b2 * nu)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
        p.add_(-lr * update)


def minibatch_steps(cfg, state, batch, num_rows, pass_fn, time_major=False):
    """The epochs as the loop made them: shuffles and entropy normals drawn
    from the generator as it went; `pass_fn(actor, critic, mb)` -> (pi, value).
    `time_major`: the rows are sequences, each minibatch's leaves are taken
    back to (T, rows, ...)."""
    sys_cfg, gen = cfg.system, state.key
    actor, critic = state.params
    actor_opt, critic_opt = state.opt_states
    perms = epoch_permutations(sys_cfg.ppo_epochs, num_rows, gen, gen.device)
    mb_size = num_rows // sys_cfg.num_minibatches
    loss_info = []
    for epoch in range(sys_cfg.ppo_epochs):
        shuffled = pytree.tree_map(lambda x: x[perms[epoch]], batch)
        for i in range(sys_cfg.num_minibatches):
            mb_traj, mb_adv, mb_targets = pytree.tree_map(
                lambda x: x[i * mb_size:(i + 1) * mb_size].swapaxes(0, 1) if time_major
                else x[i * mb_size:(i + 1) * mb_size], shuffled)
            ent_coef = host_entropy_coefficient(cfg, actor_opt)
            pi, value = pass_fn(actor, critic, mb_traj)
            actor_loss = clipped_ppo_policy_loss(pi.log_prob(mb_traj.action), mb_traj.log_prob,
                                                 mb_adv, sys_cfg.clip_eps)
            entropy = pi.entropy(gen).mean()
            actor_total = actor_loss - ent_coef * entropy
            actor_grads = torch.autograd.grad(actor_total, list(actor.parameters()))
            value_loss = clipped_value_loss(value, mb_traj.value, mb_targets, sys_cfg.clip_eps)
            critic_total = sys_cfg.vf_coef * value_loss
            critic_grads = torch.autograd.grad(critic_total, list(critic.parameters()))
            host_step(actor_opt, actor_grads)
            host_step(critic_opt, critic_grads)
            loss_info.append({"total_loss": (actor_total + critic_total).detach(),
                              "value_loss": value_loss.detach(),
                              "actor_loss": actor_loss.detach(), "entropy": entropy.detach()})
    return {k: torch.stack([m[k] for m in loss_info]).reshape(
        sys_cfg.ppo_epochs, sys_cfg.num_minibatches) for k in loss_info[0]}


def pre_split_ff_update(cfg, env, state):
    """One feed-forward update as the learner made it before its split."""
    sys_cfg, gen = cfg.system, state.key
    num_envs, rollout = cfg.arch.num_envs, sys_cfg.rollout_length
    actor, critic = state.params
    env_state, timestep = state.env_state, state.timestep
    sample_noise = make_rollout_noise_fn(cfg.network.action_head)(
        (rollout, num_envs, sys_cfg.num_agents, env.action_dim), gen, gen.device)
    steps = []
    with torch.no_grad():
        for t in range(rollout):
            obs = timestep.observation
            pi = actor(obs)
            action = pi.sample_from_noise(sample_noise[t])
            logits = pi.raw_params()
            env_state, timestep = env.step(env_state, action, env.step_noise(num_envs, gen))
            done = timestep.last()[:, None].expand(-1, sys_cfg.num_agents).float()
            steps.append((done, action, timestep.reward, logits, obs,
                          timestep.extras["episode_metrics"]))
        dones, actions, rewards, logits, obs_seq, infos = stack_trees(steps)
        log_probs = make_log_prob_from_params(cfg.network.action_head)(logits, actions)
        values = critic(obs_seq)
        last_val = critic(timestep.observation)
        traj = PPOTransition(dones, actions, values, rewards, log_probs, obs_seq, infos)
        advantages, targets = calculate_gae(rewards, values, dones, last_val, sys_cfg.gamma,
                                            sys_cfg.gae_lambda)
        batch = pytree.tree_map(lambda x: x.flatten(0, 1),
                                (traj._replace(info={}), advantages, targets))
    losses = minibatch_steps(cfg, state, batch, rollout * num_envs,
                             lambda a, c, mb: (a(mb.obs), c(mb.obs)))
    return state._replace(env_state=env_state, timestep=timestep), infos, losses


def pre_split_rec_update(cfg, env, state):
    """One recurrent update as the learner made it before its split."""
    sys_cfg, gen = cfg.system, state.key
    num_envs, rollout, chunk = cfg.arch.num_envs, sys_cfg.rollout_length, \
        sys_cfg.recurrent_chunk_size
    num_chunks = rollout // chunk
    actor, critic = state.params
    env_state, timestep, last_done = state.env_state, state.timestep, state.dones
    policy_h, critic_h0 = state.hstates
    sample_noise = make_rollout_noise_fn(cfg.network.action_head)(
        (rollout, num_envs, sys_cfg.num_agents, env.action_dim), gen, gen.device)
    steps = []
    with torch.no_grad():
        for t in range(rollout):
            obs = timestep.observation
            new_policy_h, pi = actor(policy_h, (pytree.tree_map(lambda x: x[None], obs),
                                                last_done[None]))
            action = pi.sample_from_noise(sample_noise[t][None]).squeeze(0)
            logits = pytree.tree_map(lambda x: x.squeeze(0), pi.raw_params())
            env_state, timestep = env.step(env_state, action, env.step_noise(num_envs, gen))
            done = timestep.last()[:, None].expand(-1, sys_cfg.num_agents)
            steps.append((last_done, action, timestep.reward, logits, obs, policy_h,
                          timestep.extras["episode_metrics"]))
            policy_h, last_done = new_policy_h, done
        dones, actions, rewards, logits, obs_seq, policy_hs, infos = stack_trees(steps)
        log_probs = make_log_prob_from_params(cfg.network.action_head)(logits, actions)
        critic_h_after, (carries, values) = critic(critic_h0, (obs_seq, dones),
                                                   collect_carries=True)
        _, last_val = critic(critic_h_after, (
            pytree.tree_map(lambda x: x[None], timestep.observation), last_done[None]))
        traj = RNNPPOTransition(dones, actions, values, rewards, log_probs, obs_seq,
                                HiddenStates(policy_hs, carries), infos)
        advantages, targets = calculate_gae_with_next_done(
            rewards, values, dones.float(), last_done.float(), last_val.squeeze(0),
            sys_cfg.gamma, sys_cfg.gae_lambda)
        batch = pytree.tree_map(lambda x: rec_ippo._chunk(x, "contiguous", chunk, num_chunks),
                                (traj._replace(info={}), advantages, targets))
        batch = (batch[0]._replace(hstates=pytree.tree_map(lambda h: h[0:1], batch[0].hstates)),
                 batch[1], batch[2])
        batch = pytree.tree_map(lambda x: x.swapaxes(0, 1), batch)

    def pass_fn(actor, critic, mb):
        _, pi = actor(mb.hstates.policy_hidden_state[0], (mb.obs, mb.done))
        _, value = critic(mb.hstates.critic_hidden_state[0], (mb.obs, mb.done))
        return pi, value

    losses = minibatch_steps(cfg, state, batch, num_chunks * num_envs, pass_fn,
                             time_major=True)
    new = state._replace(env_state=env_state, timestep=timestep, dones=last_done,
                         hstates=HiddenStates(policy_h, critic_h_after))
    return new, infos, losses


def leaves(state, metrics, losses) -> dict:
    """Every tensor of an update's result, by name."""
    out = {f"param {i}": p.detach() for i, p in
           enumerate(p for net in state.params for p in net.parameters())}
    for name, opt in zip(("actor", "critic"), state.opt_states):
        out.update({f"{name} adam {i}": t for i, t in enumerate([*opt.mu, *opt.nu,
                                                                 opt.device_count])})
    carry = [state.env_state, state.timestep, getattr(state, "dones", None),
             getattr(state, "hstates", None)]
    out.update({f"carry {i}": x for i, x in enumerate(pytree.tree_leaves(carry))
                if isinstance(x, torch.Tensor)})
    out.update({f"metric {k}": v for k, v in metrics.items()})
    out.update({f"loss {k}": v for k, v in losses.items()})
    return out


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("schedules", [False, True], ids=["constant", "schedules"])
@pytest.mark.parametrize("system,env_name", CASES, ids=[f"{s}-{e}" for s, e in CASES])
def test_updates_are_the_pre_split_loop(system, env_name, schedules):
    overrides = SCHEDULES if schedules else []
    cfg, env, learn, state = stock(system, env_name, overrides=overrides)
    _, _, _, old = stock(system, env_name, overrides=overrides)
    pre_split = pre_split_rec_update if system.startswith("rec") else pre_split_ff_update
    ended = 0
    for _ in range(UPDATES):
        out = learn(state)
        old, metrics, losses = pre_split(cfg, env, old)
        state = out.learner_state
        assert_same(leaves(state, out.episode_metrics, out.train_metrics),
                    leaves(old, pytree.tree_map(lambda x: x[None], metrics),
                           pytree.tree_map(lambda x: x[None], losses)))
        assert [opt.count for opt in state.opt_states] == [opt.count for opt in old.opt_states]
        assert torch.equal(state.key.get_state(), old.key.get_state())
        ended += int(out.episode_metrics["is_terminal_step"].sum())
    assert ended > 0  # through at least one episode's end and auto-reset
    assert learn.update.graph is None and learn.update.captures == 0  # a CPU learner


def test_device_schedules_are_the_host_schedules():
    """The learning rate, the entropy coefficient and a swept optimizer's
    decayed rates formed from a float64 device count equal the host forms
    bitwise at every count from 0 to past the run's total."""
    cfg = load_config("default_ff_ippo", ["system.num_updates=7", "system.ppo_epochs=3",
                                          "system.num_minibatches=5",
                                          "system.ent_coef_final=0.0003",
                                          "system.decay_learning_rates=True"])
    total = 7 * 3 * 5
    lr = make_learning_rate_schedule(2.5e-4, cfg)
    swept = make_swept_optimizer([torch.zeros(3, 2)], cfg, 0.5, [1e-4, 3e-4, 7e-3])
    for count in range(total + 12):
        device = torch.tensor(float(count), dtype=torch.float64)
        assert lr(device).dtype == torch.float64 and lr(device).item() == lr(count)
        assert entropy_schedule(cfg, device).item() == entropy_schedule(cfg, count)
        swept.count = count
        host = (swept.peak_lr * max(0.0, 1.0 - count / total)).to(torch.float32)
        assert torch.equal(swept.learning_rates(), host)
    assert lr(total + 3) == 0.0 and entropy_schedule(cfg, total + 3) == pytest.approx(0.0003)


def test_handed_in_draws_are_taken_as_they_are():
    """Handed-in draws go into the inputs untouched and nothing is drawn from
    the generator in their place."""
    cfg, env, learn, state = stock("ff_ippo", "maswarm")
    sys_cfg = cfg.system
    gen = torch.Generator().manual_seed(3)
    handed = Draws(
        noise=torch.randn((4, 2, sys_cfg.num_agents, env.action_dim), generator=gen),
        env_noise=[env.step_noise(2, gen) for _ in range(4)],
        permutations=epoch_permutations(2, 8, gen, "cpu"),
        entropy_noise=torch.randn((2, 2, 4, sys_cfg.num_agents, env.action_dim), generator=gen))
    before = state.key.get_state()
    inputs = learn.update.draw(state, handed)
    assert torch.equal(state.key.get_state(), before)
    assert inputs.noise is handed.noise and inputs.permutations is handed.permutations
    assert inputs.entropy_noise is handed.entropy_noise and inputs.env_noise == handed.env_noise
    assert inputs.carry.env_state is state.env_state and inputs.carry.dones is None
    drawn = learn.update.draw(state, Draws())
    assert drawn.entropy_noise.shape == handed.entropy_noise.shape


# ------------------------------------------------------------------ no host read
class OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


BODY_CASES = [("ff_ippo", "rware"), ("rec_mappo", "smax"), ("ff_ippo", "maswarm")]


@pytest.mark.parametrize("system,env_name", BODY_CASES, ids=[f"{s}-{e}" for s, e in BODY_CASES])
def test_body_reads_nothing_back_and_repeats_its_ops(system, env_name):
    _, _, learn, state = stock(system, env_name, overrides=SCHEDULES)
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


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the update is captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


WIDE = ["network.hidden_state_dim=64", "network.actor_network.post_torso.layer_sizes=[64]",
        "network.critic_network.post_torso.layer_sizes=[64]",
        "network.gru_impl=pallas"]  # the resident route, K2p included
GPU_CASES = [("ff_ippo", "rware"), ("rec_ippo", "rware"), ("rec_mappo", "smax")]


def per_update(cfg) -> dict:
    """The GRU kernels one recurrent update launches: the critic pass and two
    forwards (actor, critic) a minibatch step; two backwards a step."""
    steps = cfg.system.ppo_epochs * cfg.system.num_minibatches
    return {"fwd": 1 + 2 * steps, **dict.fromkeys(
        ("bwd_gates", "bwd_recurrence", "bwd_reduce", "bwd_reduce_sum"), 2 * steps)}


@pytest.mark.gpu
@pytest.mark.parametrize("system,env_name", GPU_CASES, ids=[f"{s}-{e}" for s, e in GPU_CASES])
def test_replayed_update_is_the_eager_one(cuda, system, env_name):
    """Three updates replayed (the first runs the body and captures it)
    against three op by op: bitwise, the generator and counts alike; exactly
    the GRU launches of `per_update` on the recurrent path, none on the
    feed-forward one; one graph, no re-capture."""
    wide = WIDE if system.startswith("rec") else []
    cfg, _, learn, state = stock(system, env_name, cuda, wide + SCHEDULES)
    _, _, learn_eager, state_eager = stock(system, env_name, cuda, wide + SCHEDULES)
    learn_eager.update = learn_eager.update.eager
    reduces = mesh_module.all_reduces
    want = per_update(cfg) if system.startswith("rec") else {}
    for _ in range(UPDATES):
        launches = []
        for run, st in ((learn, state), (learn_eager, state_eager)):
            gru.reset_launch_counts()
            out = run(st)
            launches.append({k: v for k, v in gru.kernel_launches.items() if v})
            if run is learn:
                graph = out
            else:
                eager = out
        assert launches == [want, want]
        assert_same(leaves(graph.learner_state, graph.episode_metrics, graph.train_metrics),
                    leaves(eager.learner_state, eager.episode_metrics, eager.train_metrics))
        state, state_eager = graph.learner_state, eager.learner_state
        assert torch.equal(state.key.get_state(), state_eager.key.get_state())
        assert [o.count for o in state.opt_states] == [o.count for o in state_eager.opt_states]
    assert mesh_module.all_reduces == reduces  # no data group: no collective
    assert learn.update.captures == 1 and learn.update.recaptures == 0


@pytest.mark.gpu
def test_a_flop_counter_sees_the_update_of_a_replaying_learner(cuda):
    """Under `FlopCounterMode` (what `scripts/bench_mfu.py` counts with) the
    captured update runs op by op and its products are counted."""
    from torch.utils.flop_counter import FlopCounterMode

    _, _, learn, state = stock("ff_ippo", "rware", cuda)
    _, _, learn_eager, state_eager = stock("ff_ippo", "rware", cuda)
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
    assert learn.update.captures == 1 and learn.update.recaptures == 0


@pytest.mark.gpu
def test_a_restore_replays_and_a_state_elsewhere_is_captured_again(cuda):
    """A checkpoint restored into the learner state (in place: the parameters,
    Adam's moments and counts keep their addresses) replays the captured
    update, bitwise an op-by-op learner restored the same way; a state at
    other addresses (another learner's) is captured again, once, and goes on
    as that learner op by op."""
    _, _, learn, state = stock("rec_mappo", "smax", cuda, WIDE)
    _, _, learn_eager, state_eager = stock("rec_mappo", "smax", cuda, WIDE)
    learn_eager.update = learn_eager.update.eager
    state = learn(state).learner_state
    state_eager = learn_eager(state_eager).learner_state
    saved = to_host(state)
    state = learn(learn(state).learner_state).learner_state
    state_eager = learn_eager(learn_eager(state_eager).learner_state).learner_state
    state = restore_into(state, saved)
    state_eager = restore_into(state_eager, saved)
    for _ in range(2):
        out, out_eager = learn(state), learn_eager(state_eager)
        state, state_eager = out.learner_state, out_eager.learner_state
        assert_same(leaves(state, out.episode_metrics, out.train_metrics),
                    leaves(state_eager, out_eager.episode_metrics, out_eager.train_metrics))
    assert learn.update.captures == 1 and learn.update.recaptures == 0
    _, _, _, other = stock("rec_mappo", "smax", cuda, WIDE)
    _, _, learn_other, other_eager = stock("rec_mappo", "smax", cuda, WIDE)
    learn_other.update = learn_other.update.eager
    for _ in range(2):
        out, out_eager = learn(other), learn_other(other_eager)
        other, other_eager = out.learner_state, out_eager.learner_state
        assert_same(leaves(other, out.episode_metrics, out.train_metrics),
                    leaves(other_eager, out_eager.episode_metrics, out_eager.train_metrics))
    assert learn.update.captures == 2 and learn.update.recaptures == 1
