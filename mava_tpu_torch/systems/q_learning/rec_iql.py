"""Recurrent Independent Q-Learning (rec-IQL / IDQN) on one device (port of
`mava_tpu/systems/q_learning/rec_iql.py`).

One update: `rollout_length` epsilon-greedy act steps of the recurrent Q-network
(T = 1, the plain GRU path), each written into the trajectory replay buffer
with the terminal observation of an auto-reset (`real_next_obs`); then
`epochs` double-DQN updates, each on `sample_batch_size` sequences of
`sample_sequence_length + 1` steps sampled from the buffer. The next-step
targets come from the fused target pass, where the online network picks the
greedy action and the target network values it over the same sequences in one
pass (`RecQNetwork.stacked_q_values`: the stacked GRU kernel, S = 2), or, with
`system.fused_target_pass=False`, from the two networks one after the other.
The loss pass and its gradient run the GRU kernels of rec-IPPO. After the
clipped Adam step the target follows the online network softly (`tau`) or, with
`hard_update`, is replaced every `update_period` updates.

Every random draw of an update can be handed in (`Draws`): the Gumbel noise of
the epsilon-greedy samples, the env's step noise and the buffer's
(rows, starts); by default they come from the learner state's generator.

Data-parallel over ranks (`parallel/`): each rank acts on its own
`arch.num_envs` envs into its own ring (its counters move in lockstep with
every other rank's), samples its own sequences, and every Q step averages the
gradients and the loss info over the ranks in one all-reduce (reference :217)
before the clip and Adam; epsilon follows the global env-step count.

CLI: python -m mava_tpu_torch.systems.q_learning.rec_iql [overrides]. The port
runs on `arch.device` (default "cuda"; add `+arch.device=cpu` to run on the
CPU). `arch.rollout_unroll` and `arch.donate_buffers` are accepted and do
nothing here (they tune the reference's compiled scans).
"""

from __future__ import annotations

import copy
import functools
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.distributions import gumbel, masked_greedy
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.envs.wrappers import obs_shape
from mava_tpu_torch.evaluator import get_num_eval_envs
from mava_tpu_torch.networks import RecQNetwork, ScannedRNN
from mava_tpu_torch.networks.factory import make_torso
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    put_replicated,
    sharded_env_reset,
    tile_for_shards,
)
from mava_tpu_torch.parallel.distributed import rank_generator
from mava_tpu_torch.replay import StackedTrajectoryBuffer, TrajectoryBuffer
from mava_tpu_torch.systems.anakin import (
    restore_full_state,
    schedule_updates,
    stack_trees,
    start_experiment,
    steps_per_round,
    train_and_evaluate,
)
from mava_tpu_torch.systems.q_learning.types import (
    Draws,
    LearnerState,
    QNetParams,
    Transition,
)
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import (
    make_optimizer,
    periodic_update,
    select_along_last,
    soft_update,
    switch_leading_axes,
    warn_q_divergence,
)


def epsilon_schedule(config: Config, t) -> torch.Tensor:
    """Exploration epsilon at global env-step count `t`: linear from 1 to
    `eps_min` over the first `eps_decay` steps, flat after (float32, as the
    reference computes it, :61-75)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    eps_min = config.system.eps_min
    return torch.clamp(1 - (t / config.system.eps_decay) * (1 - eps_min), min=eps_min)


def _first(tree: Any) -> Any:
    return pytree.tree_map(lambda x: x[None], tree)


@torch.no_grad()
def q_targets(params: QNetParams, data: Transition, gamma: float, fused: bool) -> torch.Tensor:
    """Double-DQN targets (B, T, A) of sampled sequences `data` (B, T + 1, ...):
    the online network's greedy action valued by the target network on the
    next observations, from zero carries (reference :160-200). The `next_obs`
    stored at step t pairs with the flags stored at t + 1; the bootstrap is cut
    by `terminal`, not by `term_or_trunc`. `fused` runs both networks as one
    stacked pass, else one after the other."""
    data_first = pytree.tree_map(lambda x: x[:, :-1], data)
    data_next = pytree.tree_map(lambda x: x[:, 1:], data)
    next_obs = switch_leading_axes(data_first.next_obs)
    next_resets = switch_leading_axes(data_next.term_or_trunc)
    hidden = ScannedRNN.initialize_carry(
        next_obs.agents_view.shape[1:3], params.online.rnn.hidden_state_dim, next_resets.device)
    if fused:
        q_both = RecQNetwork.stacked_q_values(
            params.online, params.target, hidden, (next_obs, next_resets))
        next_action = masked_greedy(q_both[0], next_obs.action_mask)
        next_q_target = q_both[1]
    else:
        _, greedy = params.online(hidden, (next_obs, next_resets))
        _, next_q_target = params.target.get_q_values(hidden, (next_obs, next_resets))
        next_action = greedy.mode()
    next_q = switch_leading_axes(select_along_last(next_q_target, next_action))
    not_terminal = 1.0 - data_next.terminal.to(torch.float32)
    return data_first.reward + not_terminal * gamma * next_q


def q_loss_pass(params: QNetParams, data: Transition, gamma: float, fused: bool):
    """(q_loss, Q of the taken actions (B, T, agents), targets): the online
    network over the sampled sequences from zero carries, against `q_targets`
    (reference :145-158). The loss is differentiable in the online parameters."""
    target = q_targets(params, data, gamma, fused)
    data_first = pytree.tree_map(lambda x: x[:, :-1], data)
    obs = switch_leading_axes(data_first.obs)
    resets = switch_leading_axes(data_first.term_or_trunc)
    hidden = ScannedRNN.initialize_carry(
        obs.agents_view.shape[1:3], params.online.rnn.hidden_state_dim, resets.device)
    _, q_online = params.online.get_q_values(hidden, (obs, resets))
    q_online = select_along_last(switch_leading_axes(q_online), data_first.action)
    return torch.mean(torch.square(q_online - target)), q_online, target


def get_learner_fn(
    env: Any,
    config: Config,
    buffer: TrajectoryBuffer,
    draws: Optional[Sequence[Draws]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[LearnerState], ExperimentOutput]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates,
    data-parallel over `mesh` (by default the process group's, if any).
    `draws[u]` replaces what update u would draw (see `Draws`)."""
    mesh = mesh or make_mesh()
    sys_cfg = config.system
    num_envs = config.arch.num_envs
    rollout, epochs = sys_cfg.rollout_length, sys_cfg.epochs
    fused = sys_cfg.get("fused_target_pass", True)

    def update_q(params: QNetParams, opt, data: Transition, t_train: int) -> Dict[str, torch.Tensor]:
        q_loss, q_online, target = q_loss_pass(params, data, sys_cfg.gamma, fused)
        online_params = list(params.online.parameters())
        grads = torch.autograd.grad(q_loss, online_params)
        info = (q_loss.detach(), q_online.detach().mean(), target.mean())
        grads, (q_loss, mean_q, mean_target) = all_reduce_mean((grads, info), mesh)
        opt.step(grads)
        if sys_cfg.hard_update:
            periodic_update(params.target, params.online, t_train, sys_cfg.update_period)
        else:
            soft_update(params.target, params.online, sys_cfg.tau)
        return {"q_loss": q_loss, "mean_q": mean_q, "mean_target": mean_target}

    def update_step(state: LearnerState, drawn: Draws) -> Tuple[LearnerState, Tuple]:
        gen = state.key
        online, _ = state.params
        obs, terminal, term_or_trunc = state.obs, state.terminal, state.term_or_trunc
        hidden, env_state, buffer_state = state.hidden_state, state.env_state, state.buffer_state
        t = state.time_steps
        device = terminal.device
        action_noise = drawn.action_noise
        if action_noise is None:
            shape = (rollout, num_envs, sys_cfg.num_agents, env.action_dim)
            action_noise = gumbel(shape, gen, device)

        metrics: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad(), record_function("rec_iql/rollout"):
            for step in range(rollout):
                eps = epsilon_schedule(config, t).to(device)
                hidden, greedy = online(hidden, (_first(obs), term_or_trunc[None]), eps)
                action = greedy.sample_from_noise(action_noise[step][None])[0]
                t += num_envs * config.arch.n_devices  # global env steps
                env_noise = (env.step_noise(num_envs, gen) if drawn.env_noise is None
                             else drawn.env_noise[step])
                env_state, timestep = env.step(env_state, action, env_noise)
                transition = Transition(
                    obs, action, timestep.reward, terminal, term_or_trunc,
                    timestep.extras["real_next_obs"],
                )
                buffer_state = buffer.add(buffer_state, pytree.tree_map(lambda x: x[:, None], transition))
                obs = timestep.observation
                terminal = (1 - timestep.discount[:, :1]) != 0
                term_or_trunc = timestep.last()[:, None]
                metrics.append(timestep.extras["episode_metrics"])

        losses = []
        with record_function("rec_iql/train"):
            for epoch in range(epochs):
                if drawn.rows is None:
                    rows, starts = buffer.sample_indices(buffer_state, gen)
                else:
                    rows, starts = drawn.rows[epoch], drawn.starts[epoch]
                data = buffer.sample(buffer_state, rows, starts)
                losses.append(update_q(state.params, state.opt_state, data,
                                       state.train_steps + epoch))

        new_state = state._replace(
            obs=obs, terminal=terminal, term_or_trunc=term_or_trunc, hidden_state=hidden,
            env_state=env_state, time_steps=t, train_steps=state.train_steps + epochs,
            buffer_state=buffer_state,
        )
        return new_state, (stack_trees(metrics), stack_trees(losses))

    def learner_fn(state: LearnerState) -> ExperimentOutput:
        episode_info, train_info = [], []
        for u in range(sys_cfg.num_updates_per_eval):
            state, (info, losses) = update_step(state, Draws() if draws is None else draws[u])
            episode_info.append(info)
            train_info.append(losses)
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees(episode_info),
            train_metrics=stack_trees(train_info),
        )

    return learner_fn


def make_q_network(env: Any, config: Config, device: torch.device, seed: int) -> RecQNetwork:
    """The online Q-network, initialised from `seed` as the reference's flax
    initialisers draw (in distribution), on `device`."""
    net = config.network
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        pre = make_torso(net.q_network.pre_torso, obs_shape(env))
        post = make_torso(net.q_network.post_torso, net.hidden_state_dim)
        q_net = RecQNetwork(pre, post, env.action_dim, net.hidden_state_dim,
                            net.get("gru_impl", None))
    return q_net.to(device)


def make_buffer(config: Config, entries: Optional[int] = None) -> TrajectoryBuffer:
    """The trajectory buffer; with `entries`, one ring an entry of a stacked
    program (`StackedTrajectoryBuffer`)."""
    sys_cfg = config.system
    kind = TrajectoryBuffer if entries is None else functools.partial(
        StackedTrajectoryBuffer, entries)
    return kind(
        sample_sequence_length=sys_cfg.sample_sequence_length + 1,
        period=1,
        add_batch_size=config.arch.num_envs,
        sample_batch_size=sys_cfg.sample_batch_size,
        max_length_time_axis=sys_cfg.buffer_size,
        min_length_time_axis=sys_cfg.min_buffer_size,
    )


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    draws: Optional[Sequence[Draws]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, RecQNetwork, LearnerState]:
    """Networks, optimizer, buffer, env reset and the learner function. On
    `mesh` (by default the process group's) this rank resets its rows of the
    global batch from `generator`, holds its own ring and draws from its own
    stream (`rank_generator`); the params are checked equal on every rank."""
    reject_stagger(config, "rec-IQL")
    num_agents = env.num_agents
    config.system.num_agents = num_agents
    online = make_q_network(env, config, device, config.system.seed)
    target = copy.deepcopy(online)  # online and target start equal (reference :339-341)
    opt = make_optimizer(online.parameters(), config.system.q_lr, config.system.max_grad_norm)

    mesh = mesh or make_mesh()
    num_envs = config.arch.num_envs
    env_state, timestep = sharded_env_reset(env, generator, mesh.data_size * num_envs, mesh)
    obs = timestep.observation
    one = pytree.tree_map(lambda x: x[0], obs)
    buffer = make_buffer(config)
    buffer_state = buffer.init(Transition(
        obs=one,
        action=torch.zeros(num_agents, dtype=torch.int64, device=device),
        reward=torch.zeros(num_agents, dtype=torch.float32, device=device),
        terminal=torch.zeros(1, dtype=torch.bool, device=device),
        term_or_trunc=torch.zeros(1, dtype=torch.bool, device=device),
        next_obs=one,
    ))
    state = LearnerState(
        obs=obs,
        terminal=(1 - timestep.discount[:, :1]) != 0,
        term_or_trunc=timestep.last()[:, None],
        hidden_state=tile_for_shards(ScannedRNN.initialize_carry(
            (num_envs, num_agents), config.network.hidden_state_dim, device), mesh),
        env_state=env_state,
        time_steps=0,
        train_steps=0,
        opt_state=opt,
        buffer_state=tile_for_shards(buffer_state, mesh),
        params=put_replicated(QNetParams(online, target), mesh),
        key=rank_generator(generator, mesh),
    )
    return get_learner_fn(env, config, buffer, draws, mesh), online, state


def make_eval_act_fn():
    """The evaluator's act fn: an epsilon = 0 sample of the epsilon-greedy
    distribution, one time step (reference :523-532). `params` is the online
    Q-network."""

    def eval_act_fn(params, timestep, generator, actor_state):
        net_input = (_first(timestep.observation), timestep.last()[None, :, None])
        hidden_state, greedy = params(actor_state["hidden_state"], net_input, 0.0)
        return greedy.sample(generator).squeeze(0), {"hidden_state": hidden_state}

    return eval_act_fn


def run_experiment(_config: Config) -> Tuple[float, ExperimentOutput]:
    """Train rec-IQL; returns (evaluation performance, last learner output)."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)
    env, eval_env = environments.make(config, device)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learner, q_net, learner_state = learner_setup(env, generator, config, device)
    # A resume trains what is left of total_timesteps from the saved step
    # (reference :465-479, :521-530).
    learner_state, resumed = restore_full_state(config, learner_state)
    rounds = None
    if resumed is not None:
        step = steps_per_round(config)
        rounds = range(resumed, int(config.system.total_timesteps) - step + 1, step)
        if not len(rounds):
            raise ValueError(
                f"Resumed at env-step {resumed} with total_timesteps="
                f"{int(config.system.total_timesteps)}: nothing is left to train; raise "
                "system.total_timesteps to extend the run.")
    bound = float(config.system.get("q_divergence_warn_bound", 1e3))

    def learn(state: LearnerState) -> ExperimentOutput:
        output = learner(state)
        warn_q_divergence(output.train_metrics, bound, config.logger.system_name)
        return output

    def eval_hidden(absolute_metric: bool) -> Dict[str, torch.Tensor]:
        return {
            "hidden_state": ScannedRNN.initialize_carry(
                (get_num_eval_envs(config, absolute_metric), config.system.num_agents),
                config.network.hidden_state_dim,
                device,
            )
        }

    return train_and_evaluate(
        config, device, learn, q_net, learner_state, eval_env, make_eval_act_fn(), eval_hidden,
        misc_metrics=lambda t: {"epsilon": float(epsilon_schedule(config, t))}, rounds=rounds,
    )


def main() -> float:
    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("IDQN experiment completed.")
    return performance


if __name__ == "__main__":
    main()
