"""Feed-forward Independent Soft Actor-Critic on one device (port of
`mava_tpu/systems/sac/ff_isac.py`); with `centralised_critic` the twin critics
read the global state and the joint action, and the system is ff-MASAC
(`ff_masac.py`).

A tanh-Normal actor, twin Q-networks with polyak-averaged targets, an
auto-tuned temperature alpha and TD3-style delayed, compensated actor updates.
First an explore phase of `explore_steps // num_envs` steps of Uniform[-1, 1]
actions fills the item replay buffer; then each update is `rollout_length` act
steps (samples of the actor), each written into the buffer, then `epochs`
train steps on `batch_size` items sampled from it. A train step is a Q step
(targets from the target critics and a fresh sample of the actor, a clipped
Adam step over both critics as one, the soft target update); on every
`policy_update_delay`-th epoch it is followed by `policy_update_delay` actor
and alpha steps. The global state is stored once per item
(`compress_stored_obs`).

The reference's own departures from upstream Mava are kept, each pinned by a
test: exploration draws Uniform[-1, 1], not Uniform[0, 1); the targets start
as copies of the online critics, not from fresh keys; the actor delay is gated
on the epoch index, not on the env-step count; and each optimizer is
clip-then-Adam at optax's default eps 1e-8 (the Q optimizer clips by the global
norm of both critics' gradients together).

Every random draw of an update, and of the explore phase, can be handed in
(`Draws`); by default they come from the learner state's generator.

The train phase is the reference's compiled scan of `train` (:391-422, scanned
at :469-471) in two parts: its draws (`TrainDraws`: the rows, then the Q
step's normals, then on an actor epoch the actor's and alpha's, epoch by
epoch, as the loop drew them), then a body that reads only device tensors and
updates the parameters, the Adam moments and counts, `log_alpha` and the
targets in place. On CUDA the body of all `epochs` train steps is one CUDA
graph (`learner_fn.train`, a `utils.cuda_graphs.CapturedPhase`): the first
update runs it for real and captures it, every later update copies its draws
in and replays it; a state at other addresses (a restored checkpoint) is
captured again. CPU tensors run it op by op. The act steps run op by op: a
ring write moves the buffer's host index.

Data-parallel over ranks (`parallel/`): each rank explores and acts on its own
`arch.num_envs` envs into its own ring and samples its own items; the Q step,
each actor step and each alpha step average their gradients and loss over
the ranks in one all-reduce each (reference :328, :360, :378) before the clip
and Adam. `state.t` counts this rank's env-steps; the logged counts are global
(times `n_devices`), as the reference's.

CLI: python -m mava_tpu_torch.systems.sac.ff_isac [overrides]. The port runs on
`arch.device` (default "cuda"; add `+arch.device=cpu` to run on the CPU).
`arch.rollout_unroll` and `arch.donate_buffers` are accepted and do nothing
here (they tune the reference's compiled scans).
"""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.distributions import normal
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.networks import FeedForwardActor, FeedForwardQNet
from mava_tpu_torch.networks.factory import make_action_head, make_torso
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    put_replicated,
    sharded_env_reset,
    tile_for_shards,
)
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.parallel.distributed import gather_metrics, rank_generator
from mava_tpu_torch.replay import ItemBuffer, StackedItemBuffer
from mava_tpu_torch.systems.anakin import (
    restore_full_state,
    stack_trees,
    start_experiment,
    train_and_evaluate,
)
from mava_tpu_torch.systems.sac.types import (
    Draws,
    LearnerState,
    OptStates,
    QVals,
    QValsAndTarget,
    SacParams,
    TrainDraws,
    Transition,
)
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.centralised_training import get_joint_action, get_updated_joint_actions
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.cuda_graphs import CapturedPhase
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.timestep_checker import check_total_timesteps
from mava_tpu_torch.utils.training import ClippedAdam, soft_update, warn_q_divergence

# optax.adam's default, which the reference's three optimizers keep (PPO and
# IQL use 1e-5).
ADAM_EPS = 1e-8


def compress_stored_obs(obs: Any) -> Any:
    """The observation as the buffer stores it: a global state, which
    `GlobalStateWrapper` repeats for every agent, is kept once, (..., 1, G)
    (reference :197-221). Only a per-agent (..., A, G) vector global state can
    be compressed so."""
    if not hasattr(obs, "global_state"):
        return obs
    gs = obs.global_state
    if gs.dim() != obs.agents_view.dim() or gs.shape[-2] != obs.agents_view.shape[-2]:
        raise ValueError(
            "compress_stored_obs expects a per-agent-duplicated (…, A, G) "
            f"vector global state; got global_state {tuple(gs.shape)} vs "
            f"agents_view {tuple(obs.agents_view.shape)}. Grid global states are "
            "not supported by the replay dedup."
        )
    return obs._replace(global_state=gs[..., :1, :])


def expand_sampled_obs(obs: Any, n_agents: int) -> Any:
    """The inverse of `compress_stored_obs` on sampled items: the stored
    global-state row broadcast back to (..., n_agents, G)."""
    if not hasattr(obs, "global_state"):
        return obs
    gs = obs.global_state
    return obs._replace(global_state=gs.expand(*gs.shape[:-2], n_agents, gs.shape[-1]))


def make_networks(
    env: Any, config: Config, device: torch.device, seed: int, centralised_critic: bool = False,
) -> Tuple[FeedForwardActor, FeedForwardQNet, FeedForwardQNet]:
    """The actor (its log-std a Dense of the embedding, as the reference builds
    it for SAC, :91-96) and the two online Q-networks, initialised from `seed`
    as the reference's flax initialisers draw (in distribution), on `device`.
    A Q-network's torso reads [obs features, action]: the global state and
    the joint action when centralised."""
    net = config.network
    act = env.action_dim
    q_features = (
        env.num_global_state_features + env.num_agents * act
        if centralised_critic else env.num_obs_features + act
    )
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        torso = make_torso(net.actor_network.pre_torso, env.num_obs_features)
        head = make_action_head(dict(net.action_head, independent_std=False), torso.out_features, act)
        actor = FeedForwardActor(torso, head)
        q1, q2 = (
            FeedForwardQNet(make_torso(net.critic_network.pre_torso, q_features), centralised_critic)
            for _ in range(2)
        )
    return actor.to(device), q1.to(device), q2.to(device)


def target_entropy(config: Config, num_agents: int, action_dim: int, device) -> torch.Tensor:
    """-target_entropy_scale * action_dim for every agent, (1, A) (reference :112-113)."""
    value = -config.system.target_entropy_scale * action_dim
    return torch.full((1, num_agents), value, dtype=torch.float32, device=device)


def make_buffer(config: Config, entries: Optional[int] = None) -> ItemBuffer:
    """The item buffer; with `entries`, one ring an entry of a stacked program
    (`StackedItemBuffer`)."""
    sys_cfg = config.system
    kwargs = dict(
        max_length=int(sys_cfg.buffer_size),
        min_length=int(sys_cfg.explore_steps),
        sample_batch_size=int(sys_cfg.batch_size),
        add_batch_size=config.arch.num_envs,
    )
    return ItemBuffer(**kwargs) if entries is None else StackedItemBuffer(entries, **kwargs)


def initial_log_alpha(config: Config, entropy_target: torch.Tensor) -> torch.Tensor:
    """log(alpha) at the start, shaped as the entropy target: 0 with
    `autotune`, else log(init_alpha) (reference :112-118)."""
    alpha0 = 0.0 if config.system.autotune else math.log(config.system.init_alpha)
    return torch.full_like(entropy_target, alpha0).requires_grad_(True)


def dummy_transition(obs: Any, num_agents: int, act: int, device) -> Transition:
    """One item shaped as the buffer stores it, from a batch of observations."""
    one = compress_stored_obs(pytree.tree_map(lambda x: x[0], obs))
    return Transition(
        obs=one,
        action=torch.zeros((num_agents, act), dtype=torch.float32, device=device),
        reward=torch.zeros(num_agents, dtype=torch.float32, device=device),
        done=torch.zeros(num_agents, dtype=torch.bool, device=device),
        next_obs=one,
    )


def get_learner_fns(
    env: Any,
    config: Config,
    buffer: ItemBuffer,
    entropy_target: torch.Tensor,
    centralised_critic: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable]:
    """(explore_fn, learner_fn). `explore_fn(state, draws=None)` runs the
    explore phase and returns (state, episode metrics (steps, E)).
    `learner_fn(state, draws=None)` runs `system.scan_steps` updates,
    data-parallel over `mesh` (by default the process group's, if any);
    `draws[u]` replaces what update u would draw (see `Draws`).
    `learner_fn.train` is the train phase (`CapturedPhase`: captured on CUDA;
    `learner_fn.train.eager` runs it op by op)."""
    mesh = mesh or make_mesh()
    sys_cfg = config.system
    num_envs, num_agents, act = config.arch.num_envs, env.num_agents, env.action_dim
    rollout, epochs, delay = sys_cfg.rollout_length, sys_cfg.epochs, sys_cfg.policy_update_delay
    batch = sys_cfg.batch_size
    if delay <= 0:
        raise ValueError("system.policy_update_delay must be positive.")

    def critic_action(action: torch.Tensor) -> torch.Tensor:
        return get_joint_action(action) if centralised_critic else action

    def env_step(state: LearnerState, action: torch.Tensor, env_noise) -> Tuple[LearnerState, Dict]:
        """One env step; its transition goes into the buffer, with the terminal
        observation of an auto-reset as `next_obs` (reference :254-269)."""
        if env_noise is None:
            env_noise = env.step_noise(num_envs, state.key)
        env_state, timestep = env.step(state.env_state, action, env_noise)
        transition = Transition(
            compress_stored_obs(state.obs),
            action,
            timestep.reward,
            ~timestep.discount.to(torch.bool),
            compress_stored_obs(timestep.extras["real_next_obs"]),
        )
        buffer_state = buffer.add(state.buffer_state, transition)
        state = state._replace(obs=timestep.observation, env_state=env_state,
                               buffer_state=buffer_state, t=state.t + num_envs)
        return state, timestep.extras["episode_metrics"]

    def drawn_or_new(values: Optional[torch.Tensor], index: int, shape, gen, device):
        """values[index], or standard normals of `shape` from `gen`."""
        return normal(shape, gen, device) if values is None else values[index]

    def update_q(params: SacParams, opt_states: OptStates, data: Transition, noise: torch.Tensor):
        """One Q step, then the soft target update (reference :305-341)."""
        online, targets = params.q
        with torch.no_grad():
            pi = params.actor(data.next_obs)
            next_action, next_log_prob = pi.sample_and_log_prob(noise=noise)
            next_q_action = critic_action(next_action)
            next_q = torch.minimum(targets.q1(data.next_obs, next_q_action),
                                   targets.q2(data.next_obs, next_q_action))
            next_q = next_q - torch.exp(params.log_alpha) * next_log_prob
            target = (sys_cfg.reward_scale * data.reward
                      + (1.0 - data.done.to(torch.float32)) * sys_cfg.gamma * next_q)
        q_action = critic_action(data.action)
        q1_values = online.q1(data.obs, q_action)
        q2_values = online.q2(data.obs, q_action)
        q1_loss = torch.mean(torch.square(q1_values - target))
        q2_loss = torch.mean(torch.square(q2_values - target))
        loss = q1_loss + q2_loss
        grads = torch.autograd.grad(loss, opt_states.q.params)
        info = {
            "loss": loss.detach(),
            "q1_loss": q1_loss.detach(),
            "q2_loss": q2_loss.detach(),
            "q1_a_vals": q1_values.detach().mean(),
            "q2_a_vals": q2_values.detach().mean(),
        }
        grads, info = all_reduce_mean((grads, info), mesh)
        opt_states.q.step(grads)
        soft_update(targets.q1, online.q1, sys_cfg.tau)
        soft_update(targets.q2, online.q2, sys_cfg.tau)
        return info

    def update_actor_and_alpha(params: SacParams, opt_states: OptStates, data: Transition,
                               actor_noise: torch.Tensor, alpha_noise: torch.Tensor):
        """`policy_update_delay` actor steps, each followed by an alpha step on a
        fresh sample of the updated actor (reference :343-388). The actor's
        gradient reaches the actor alone."""
        online = params.q.online
        actor_params = opt_states.actor.params
        for d in range(delay):
            alpha = torch.exp(params.log_alpha).detach()
            pi = params.actor(data.obs)
            action, log_prob = pi.sample_and_log_prob(noise=actor_noise[d])
            q_action = (get_updated_joint_actions(data.action, action)
                        if centralised_critic else action)
            min_q = torch.minimum(online.q1(data.obs, q_action), online.q2(data.obs, q_action))
            actor_loss = ((alpha * log_prob) - min_q).mean()
            grads = torch.autograd.grad(actor_loss, actor_params)
            grads, actor_loss = all_reduce_mean((grads, actor_loss.detach()), mesh)
            opt_states.actor.step(grads)

            alpha_loss = torch.zeros((), device=actor_loss.device)
            if sys_cfg.autotune:
                with torch.no_grad():
                    _, log_prob = params.actor(data.obs).sample_and_log_prob(noise=alpha_noise[d])
                alpha_loss = torch.mean(-torch.exp(params.log_alpha) * (log_prob + entropy_target))
                grads = torch.autograd.grad(alpha_loss, [params.log_alpha])
                grads, alpha_loss = all_reduce_mean((grads, alpha_loss.detach()), mesh)
                opt_states.alpha.step(grads)
        return {"actor_loss": actor_loss.detach(), "alpha_loss": alpha_loss.detach()}

    def draw_train(state: LearnerState, drawn: Draws) -> TrainDraws:
        """Every draw of the train phase, epoch by epoch as the train steps
        take them: the rows, the Q step's normals, and on an actor epoch the
        actor's then alpha's; a handed-in field is read in its place."""
        gen, device = state.key, state.params.log_alpha.device
        sample_shape = (batch, num_agents, act)
        rows, q_noise, actor_noise, alpha_noise = [], [], [], []
        for epoch in range(epochs):
            rows.append(buffer.sample_indices(state.buffer_state, gen) if drawn.rows is None
                        else drawn.rows[epoch])
            q_noise.append(drawn_or_new(drawn.q_noise, epoch, sample_shape, gen, device))
            if epoch % delay == 0:
                shape = (delay, *sample_shape)
                actor_noise.append(drawn_or_new(drawn.actor_noise, epoch, shape, gen, device))
                alpha_noise.append(drawn_or_new(drawn.alpha_noise, epoch, shape, gen, device))
        return TrainDraws(*(torch.stack(x) for x in (rows, q_noise, actor_noise, alpha_noise)))

    def train_body(state: LearnerState, draws: TrainDraws) -> Dict[str, torch.Tensor]:
        """The `epochs` train steps on device tensors only: the losses of each
        epoch, stacked (reference :391-422)."""
        params, opt_states = state.params, state.opt_states
        losses = []
        for epoch in range(epochs):
            data = buffer.sample(state.buffer_state, draws.rows[epoch])
            data = data._replace(obs=expand_sampled_obs(data.obs, num_agents),
                                 next_obs=expand_sampled_obs(data.next_obs, num_agents))
            info = update_q(params, opt_states, data, draws.q_noise[epoch])
            # The delay is gated on the epoch index, as the reference does
            # (:401-407): upstream gates on the env-step count, which is the
            # same for every epoch of an update.
            if epoch % delay == 0:
                info.update(update_actor_and_alpha(params, opt_states, data,
                                                   draws.actor_noise[epoch // delay],
                                                   draws.alpha_noise[epoch // delay]))
            else:
                zero = torch.zeros((), device=params.log_alpha.device)
                info.update(actor_loss=zero, alpha_loss=zero)
            losses.append(info)
        return stack_trees(losses)

    def update_step(state: LearnerState, drawn: Draws) -> Tuple[LearnerState, Tuple]:
        act_noise = drawn.act_noise
        if act_noise is None:
            act_noise = normal((rollout, num_envs, num_agents, act), state.key,
                               state.params.log_alpha.device)
        metrics = []
        with torch.no_grad(), record_function("sac/act"):
            for step in range(rollout):
                action = state.params.actor(state.obs).sample_from_noise(act_noise[step])
                env_noise = None if drawn.env_noise is None else drawn.env_noise[step]
                state, info = env_step(state, action, env_noise)
                metrics.append(info)
        with record_function("sac/train"):
            losses = learner_fn.train(state, drawn)
        return state, (stack_trees(metrics), losses)

    def explore_fn(state: LearnerState, draws: Optional[Draws] = None) -> Tuple[LearnerState, Dict]:
        """`explore_steps // num_envs` steps of Uniform[-1, 1] actions (reference
        :434-450, :479-484). Upstream draws Uniform[0, 1)."""
        draws = draws or Draws()
        device = state.params.log_alpha.device
        metrics = []
        with torch.no_grad(), record_function("sac/explore"):
            for step in range(sys_cfg.explore_steps // num_envs):
                if draws.explore is None:
                    u = torch.rand((num_envs, num_agents, act), generator=state.key, device=device)
                    action = u * 2.0 - 1.0
                else:
                    action = draws.explore[step]
                env_noise = None if draws.env_noise is None else draws.env_noise[step]
                state, info = env_step(state, action, env_noise)
                metrics.append(info)
        return state, stack_trees(metrics)

    def learner_fn(state: LearnerState, draws: Optional[Sequence[Draws]] = None) -> ExperimentOutput:
        episode_info, train_info = [], []
        for u in range(sys_cfg.get("scan_steps", 1)):
            state, (info, losses) = update_step(state, Draws() if draws is None else draws[u])
            episode_info.append(info)
            train_info.append(losses)
        train_metrics = dict(stack_trees(train_info))
        train_metrics["log_alpha"] = state.params.log_alpha.detach().clone()
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees(episode_info),
            train_metrics=train_metrics,
        )

    learner_fn.train = CapturedPhase(draw_train, train_body, train_state_tensors(entropy_target),
                                     train_counters, "the SAC train phase")
    return explore_fn, learner_fn


def train_state_tensors(entropy_target: torch.Tensor) -> Callable[[LearnerState], List]:
    """The tensors the train phase reads or writes in place, beside its draws:
    every network's parameters, `log_alpha`, the entropy target, the three
    optimizers' state and the ring's storage (stock or stacked)."""
    def tensors(state: LearnerState) -> List[torch.Tensor]:
        params = state.params
        nets = (params.actor, *params.q.online, *params.q.targets)
        return [*(p for net in nets for p in net.parameters()), params.log_alpha, entropy_target,
                *(t for opt in state.opt_states for t in opt.state_tensors()),
                *pytree.tree_leaves(state.buffer_state.experience)]
    return tensors


def train_counters(state: LearnerState) -> List:
    """The host counters a train phase advances: the three optimizers' counts
    and the all-reduces of a data group."""
    return [*((opt, "count") for opt in state.opt_states), (mesh_module, "all_reduces")]


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    centralised_critic: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable, torch.nn.Module, LearnerState]:
    """Networks (targets as copies of the online critics), temperature, the
    three optimizers, the buffer, the env reset; returns (explore_fn,
    learner_fn, actor, state). On `mesh` (by default the process group's)
    this rank resets its rows of the global batch from `generator`, holds its
    own ring and draws from its own stream (`rank_generator`); the params are
    checked equal on every rank."""
    reject_stagger(config, "ff-ISAC/ff-MASAC")
    sys_cfg = config.system
    num_agents, act = env.num_agents, env.action_dim
    sys_cfg.num_agents = num_agents
    actor, q1, q2 = make_networks(env, config, device, sys_cfg.seed, centralised_critic)
    # The targets start as copies of the online critics (reference :105-110).
    online, targets = QVals(q1, q2), QVals(copy.deepcopy(q1), copy.deepcopy(q2))

    entropy_target = target_entropy(config, num_agents, act, device)
    log_alpha = initial_log_alpha(config, entropy_target)
    params = SacParams(actor, QValsAndTarget(online, targets), log_alpha)

    clip = sys_cfg.max_grad_norm
    opt_states = OptStates(
        actor=ClippedAdam(actor.parameters(), sys_cfg.policy_lr, clip, eps=ADAM_EPS),
        q=ClippedAdam([*q1.parameters(), *q2.parameters()], sys_cfg.q_lr, clip, eps=ADAM_EPS),
        alpha=ClippedAdam([log_alpha], sys_cfg.alpha_lr, clip, eps=ADAM_EPS),
    )

    mesh = mesh or make_mesh()
    num_envs = config.arch.num_envs
    env_state, timestep = sharded_env_reset(env, generator, mesh.data_size * num_envs, mesh)
    obs = timestep.observation
    buffer = make_buffer(config)
    buffer_state = tile_for_shards(buffer.init(dummy_transition(obs, num_agents, act, device)),
                                   mesh)
    state = LearnerState(obs, env_state, buffer_state, put_replicated(params, mesh), opt_states,
                         0, rank_generator(generator, mesh))
    explore_fn, learner_fn = get_learner_fns(env, config, buffer, entropy_target,
                                             centralised_critic, mesh)
    return explore_fn, learner_fn, actor, state


def build_bench_learners(
    config: Config, device: torch.device, centralised_critic: bool = False,
) -> Tuple[Callable, Callable, LearnerState]:
    """(explore, update, initial state) of ff-ISAC (ff-MASAC when
    `centralised_critic`) on `device`, the env made from `config` and the
    generator seeded with `system.seed`: the programs that timing and
    profiling tools call (reference :513-536; here `chip_smoke.py`). `update`
    runs `system.scan_steps` updates a call (one unless set)."""
    env, _ = environments.make(config, device, add_global_state=centralised_critic)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    explore, update, _, state = learner_setup(env, generator, config, device, centralised_critic)
    return explore, update, state


def run_experiment(_config: Config, centralised_critic: bool = False) -> Tuple[float, ExperimentOutput]:
    """Train ff-ISAC (ff-MASAC when `centralised_critic`); returns (evaluation
    performance, last learner output). As the reference (:539-685): a round is
    `total_timesteps // num_evaluation` env-steps, `scan_steps` updates; the
    explore phase is logged first, and the rounds run from the env-step count
    after it to `total_timesteps`."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)
    config = check_total_timesteps(config)
    steps_per_rollout = int(config.system.total_timesteps // config.arch.num_evaluation)
    act_steps = config.arch.n_devices * config.arch.num_envs * config.system.rollout_length
    config.system.scan_steps = max(1, steps_per_rollout // act_steps)

    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    explore, learner, actor, state = learner_setup(env, generator, config, device,
                                                   centralised_critic)
    # A resume restores the whole state, the env-step count included: it
    # trains what is left of total_timesteps and skips the explore phase
    # (reference :574-625).
    state, resumed = restore_full_state(config, state)
    logger = MavaLogger(config)

    if resumed is None:
        start_time = time.perf_counter()
        state, metrics = explore(state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t = state.t * config.arch.n_devices
        logger.log({"step": t}, t, 0, LogEvent.MISC)
        final_metrics, ep_completed = get_final_step_metrics(gather_metrics(metrics))
        final_metrics["steps_per_second"] = t / (time.perf_counter() - start_time)
        if ep_completed:  # a long time limit may end no episode while exploring
            logger.log(final_metrics, t, 0, LogEvent.ACT)
    else:
        t = state.t * config.arch.n_devices
        logger.log({"step": t}, t, 0, LogEvent.MISC)

    rounds = range(t, int(config.system.total_timesteps) + 1, steps_per_rollout)
    if not len(rounds):
        raise ValueError(f"Training starts at env-step {t}: nothing is left of "
                         f"total_timesteps={config.system.total_timesteps}; raise "
                         "system.total_timesteps to extend the run.")
    bound = float(config.system.get("q_divergence_warn_bound", 1e3))

    def learn(learner_state: LearnerState) -> ExperimentOutput:
        output = learner(learner_state)
        warn_q_divergence(output.train_metrics, bound, config.logger.system_name)
        return output

    # A feed-forward actor carries no state through an episode.
    return train_and_evaluate(
        config, device, learn, actor, state, eval_env, make_ff_eval_act_fn(config),
        lambda absolute_metric: {}, rounds=rounds, logger=logger,
    )


def main() -> float:
    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("ISAC experiment completed.")
    return performance


if __name__ == "__main__":
    main()
