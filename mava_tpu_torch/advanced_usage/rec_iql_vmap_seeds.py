"""rec-IQL over a stack of S entries in one program (port of
`mava_tpu/advanced_usage/rec_iql_vmap_seeds.py`, which `jax.vmap`s the stock
fused act-and-train update over a leading seed axis, `:116-118`).

Entry s is the stock rec-IQL learner (`systems/q_learning/rec_iql.py`) on its
own slice of every tensor: its online and target Q-networks (`StackedNetwork`),
its Adam moments and learning rate (`make_swept_adam`, eps 1e-5, each entry
clipped by its own norm), its E envs (rows [s * E, (s + 1) * E) of one batch of
S * E), its ring of the trajectory buffer (`StackedTrajectoryBuffer`: one host
counter for all, since the entries write in lockstep) and its draws. The
epsilon schedule reads the one step counter, which every entry advances alike.

The GRU runs as it does in the stock learner, with the stack on top. The T = 1
act steps take the plain recurrence, vmapped. Each epoch's fused double-DQN
target pass (online and target of every entry over the entry's next
observations, already a stack of two in the stock learner) is one stacked K1
launch over 2S entries, the resets of each pair its entry's; the loss pass is
one stacked K1 over S and its gradient one launch of each stacked backward
kernel. So a stacked update makes as many GRU launches as one stock update,
whatever S is: at `epochs = 2`, 4 stacked K1 and 2 of each stacked backward
kernel, and no unstacked GRU launch. `system.fused_target_pass=False` runs the
target pass as two stacked launches over S (online, then target).

With `sweep_lrs` the entries share their init, resets and draws and differ by
`q_lr` alone (`rec_iql_vmap_sweep.py`). Each entry is evaluated at epsilon = 0
from a fresh carry with the stock evaluator.

CLI: python -m mava_tpu_torch.advanced_usage.rec_iql_vmap_seeds \
    env=smax env/scenario=3s5z +system.num_seeds=4
(on the card; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.advanced_usage.common import (
    Draws,
    entry_reset,
    entry_seeds,
    local_entries,
    per_entry_mean,
    print_entries,
    schedule_rounds,
    seed_placement,
    train_entries,
)
from mava_tpu_torch.advanced_usage.rec_ippo_vmap_seeds import eval_hidden, one_step
from mava_tpu_torch.distributions import gumbel, masked_greedy
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.networks import ScannedRNN, StackedNetwork, stack_observation
from mava_tpu_torch.parallel import Mesh, all_reduce_mean, make_mesh, put_replicated
from mava_tpu_torch.parallel.distributed import rank_generator
from mava_tpu_torch.replay import StackedTrajectoryBuffer
from mava_tpu_torch.systems.anakin import stack_trees, start_experiment
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.q_learning.types import Draws as IqlDraws
from mava_tpu_torch.systems.q_learning.types import LearnerState, QNetParams, Transition
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import (
    make_swept_adam,
    periodic_update,
    select_along_last,
    soft_update,
)


def entry_time_major(tree: Any) -> Any:
    """(S, B, T, ...) <-> (S, T, B, ...) for every leaf."""
    return pytree.tree_map(lambda x: x.swapaxes(1, 2), tree)


def _carry(params: QNetParams, obs: Any) -> torch.Tensor:
    """Zero carries (S, B, A, H) for time-major (S, T, B, A, ...) sequences."""
    hidden = params.online.module.rnn.hidden_state_dim
    return ScannedRNN.initialize_carry((*obs.agents_view.shape[:1], *obs.agents_view.shape[2:4]),
                                       hidden, obs.agents_view.device)


@torch.no_grad()
def q_targets(params: QNetParams, data: Transition, gamma: float, fused: bool) -> torch.Tensor:
    """`rec_iql.q_targets` of every entry on its own sampled sequences `data`
    (S, B, T + 1, ...): targets (S, B, T, A). `fused` runs the online and target
    networks of all entries as one stacked pass over 2S."""
    data_first = pytree.tree_map(lambda x: x[:, :, :-1], data)
    data_next = pytree.tree_map(lambda x: x[:, :, 1:], data)
    next_obs = entry_time_major(data_first.next_obs)
    next_resets = entry_time_major(data_next.term_or_trunc)
    hidden = _carry(params, next_obs)
    if fused:
        q_both = StackedNetwork.stacked_q_values(
            params.online, params.target, hidden, (next_obs, next_resets))
        next_action = masked_greedy(q_both[0], next_obs.action_mask)
        next_q_target = q_both[1]
    else:
        _, greedy = params.online(hidden, (next_obs, next_resets))
        _, next_q_target = params.target.get_q_values(hidden, (next_obs, next_resets))
        next_action = greedy.mode()
    next_q = entry_time_major(select_along_last(next_q_target, next_action))
    not_terminal = 1.0 - data_next.terminal.to(torch.float32)
    return data_first.reward + not_terminal * gamma * next_q


def q_loss_pass(params: QNetParams, data: Transition, gamma: float, fused: bool):
    """(q_loss (S,), Q of the taken actions (S, B, T, A), targets): each entry's
    `rec_iql.q_loss_pass`, the online networks as one stacked pass. The sum of
    the losses differentiates into each entry's own gradient."""
    target = q_targets(params, data, gamma, fused)
    data_first = pytree.tree_map(lambda x: x[:, :, :-1], data)
    obs = entry_time_major(data_first.obs)
    resets = entry_time_major(data_first.term_or_trunc)
    _, q_online = params.online.get_q_values(_carry(params, obs), (obs, resets))
    q_online = select_along_last(entry_time_major(q_online), data_first.action)
    return per_entry_mean(torch.square(q_online - target)), q_online, target


def get_learner_fn(
    env: Any,
    config: Config,
    buffer: StackedTrajectoryBuffer,
    num: int,
    shared: bool,
    draws: Optional[Sequence[IqlDraws]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[LearnerState], ExperimentOutput]:
    """Build `learner_fn(state)`, which runs `system.scan_steps` updates of all
    `num` entries. `draws[u]` replaces what update u would draw: the fields of
    `q_learning.types.Draws` with the entry axis in front (action_noise (S,
    rollout, E, A, actions); rows and starts (S, epochs, B)) and env_noise one
    `env.step_noise` of the S * E rows a step. By default every entry draws its
    own from the state's generator, or one entry's for all when `shared`.
    Every Q step averages the gradients and the losses over `mesh`'s data
    group (by default the process group's ranks), each entry's over its own."""
    mesh = mesh or make_mesh()
    sys_cfg = config.system
    num_envs, agents = config.arch.num_envs, sys_cfg.num_agents
    rollout, epochs = sys_cfg.rollout_length, sys_cfg.epochs
    fused = sys_cfg.get("fused_target_pass", True)

    def update_q(params: QNetParams, opt, data: Transition, t_train: int) -> Dict[str, torch.Tensor]:
        q_loss, q_online, target = q_loss_pass(params, data, sys_cfg.gamma, fused)
        grads = torch.autograd.grad(q_loss.sum(), params.online.parameters())
        info = {
            "q_loss": q_loss.detach(),
            "mean_q": per_entry_mean(q_online.detach()),
            "mean_target": per_entry_mean(target),
        }
        grads, info = all_reduce_mean((grads, info), mesh)
        opt.step(grads)
        if sys_cfg.hard_update:
            periodic_update(params.target, params.online, t_train, sys_cfg.update_period)
        else:
            soft_update(params.target, params.online, sys_cfg.tau)
        return info

    def update_step(state: LearnerState, drawn: IqlDraws) -> Tuple[LearnerState, Tuple]:
        online, _ = state.params
        obs, terminal, term_or_trunc = state.obs, state.terminal, state.term_or_trunc
        hidden, env_state, buffer_state = state.hidden_state, state.env_state, state.buffer_state
        t = state.time_steps
        device = terminal.device
        draw = Draws(num, shared, state.key, device)
        action_noise = drawn.action_noise
        if action_noise is None:
            action_noise = draw(gumbel, (rollout, num_envs, agents, env.action_dim))

        metrics: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad(), record_function("rec_iql_vmap/rollout"):
            for step in range(rollout):
                eps = rec_iql.epsilon_schedule(config, t).to(device)
                entry_obs = stack_observation(obs, num)
                resets = term_or_trunc.reshape(num, 1, num_envs, 1)
                hidden, greedy = online(hidden, (one_step(entry_obs), resets), eps)
                action = greedy.sample_from_noise(action_noise[:, step][:, None])[:, 0]
                t += num_envs * config.arch.n_devices  # one entry's env steps
                env_noise = (draw.env(env, num_envs) if drawn.env_noise is None
                             else drawn.env_noise[step])
                env_state, timestep = env.step(env_state, action.flatten(0, 1), env_noise)
                transition = Transition(
                    entry_obs, action, timestep.reward.reshape(num, num_envs, agents),
                    terminal.reshape(num, num_envs, 1), term_or_trunc.reshape(num, num_envs, 1),
                    stack_observation(timestep.extras["real_next_obs"], num),
                )
                buffer_state = buffer.add(buffer_state,
                                          pytree.tree_map(lambda x: x[:, :, None], transition))
                obs = timestep.observation
                terminal = (1 - timestep.discount[:, :1]) != 0
                term_or_trunc = timestep.last()[:, None]
                metrics.append(timestep.extras["episode_metrics"])

        losses = []
        with record_function("rec_iql_vmap/train"):
            for epoch in range(epochs):
                if drawn.rows is None:
                    rows, starts = buffer.sample_indices(buffer_state, draw)
                else:
                    rows, starts = drawn.rows[:, epoch], drawn.starts[:, epoch]
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
        for u in range(sys_cfg.get("scan_steps", 1)):
            state, (info, losses) = update_step(state, IqlDraws() if draws is None else draws[u])
            episode_info.append(info)
            train_info.append(losses)
        train = stack_trees(train_info)  # (updates, epochs, S)
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees(episode_info),
            train_metrics={k: v.movedim(-1, 0) for k, v in train.items()},
        )

    return learner_fn


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    num: int,
    sweep_lrs: Optional[Sequence[float]] = None,
    draws: Optional[Sequence[IqlDraws]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, StackedNetwork, LearnerState]:
    """The stacked online and target Q-networks (entry s from `entry_seeds`; the
    targets start equal), the swept optimizer (`q_lr`, or each entry's sweep
    lr), the S * E envs' reset, the stacked buffer and the learner function.
    On a seed-sharded `mesh` (by default the process group's data mesh) the
    learner holds this rank's entries of the `num` (`local_entries`): their
    networks and rings, on its rows of each entry's envs."""
    reject_stagger(config, "rec-IQL vmap-seeds/sweep")
    num_agents = env.num_agents
    config.system.num_agents = num_agents
    shared = sweep_lrs is not None
    if shared and len(sweep_lrs) != num:
        raise ValueError(f"one lr per sweep entry: {len(sweep_lrs)} lrs for {num} entries")
    mesh = mesh or make_mesh()
    entries = local_entries(mesh, num)
    nets = [rec_iql.make_q_network(env, config, device, seed)
            for seed in entry_seeds(config, num, shared)[entries.start:entries.stop]]
    online, target = StackedNetwork(nets), StackedNetwork(nets)
    lrs = sweep_lrs[entries.start:entries.stop] if shared else config.system.q_lr
    opt = make_swept_adam(online.parameters(), lrs, config.system.max_grad_norm, eps=1e-5)

    num_envs = config.arch.num_envs
    env_state, timestep = entry_reset(env, generator, num, shared, num_envs, mesh, device)
    num = len(entries)
    obs = timestep.observation
    one = pytree.tree_map(lambda x: x[0], obs)
    buffer = rec_iql.make_buffer(config, entries=num)
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
        hidden_state=ScannedRNN.initialize_carry(
            (num, num_envs, num_agents), config.network.hidden_state_dim, device),
        env_state=env_state,
        time_steps=0,
        train_steps=0,
        opt_state=opt,
        buffer_state=buffer_state,
        params=put_replicated(QNetParams(online, target), mesh),
        key=rank_generator(generator, mesh, shared_over_seed_groups=shared),
    )
    return get_learner_fn(env, config, buffer, num, shared, draws, mesh), online, state


def run_experiment(_config: Config, sweep_lrs: Optional[Sequence[float]] = None) -> float:
    """Train `system.num_seeds` seeds (default 4), or one entry per lr of
    `sweep_lrs`, of rec-IQL; returns the mean over the entries of the last
    evaluation's return."""
    config = copy.deepcopy(_config)
    num = len(sweep_lrs) if sweep_lrs is not None else int(config.system.get("num_seeds", 4))
    device = start_experiment(config)
    mesh, _ = seed_placement(config, num)
    config, steps_per_rollout = schedule_rounds(config)
    env, eval_env = environments.make(config, device)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, _, learner_state = learner_setup(env, generator, config, device, num, sweep_lrs,
                                            mesh=mesh)
    total = int(config.system.total_timesteps)
    returns, _, _ = train_entries(
        config, device, learn, learner_state, eval_env, rec_iql.make_eval_act_fn(),
        eval_hidden(config, device), num, policy=lambda state: state.params.online,
        rounds=range(steps_per_rollout, total + 1, steps_per_rollout),
        steps_per_round=steps_per_rollout, mesh=mesh)
    print_entries("", returns, None, sweep_lrs)
    return float(returns.mean())


def main() -> float:
    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IQL vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
