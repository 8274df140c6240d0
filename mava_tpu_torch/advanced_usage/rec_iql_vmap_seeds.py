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

The reference compiles the vmapped update into one program. Here, as in the
stock learner, an update is two parts: its inputs (`types.UpdateInputs` with
the entry axis in front: the draws in the order the act steps and epochs take
them; each act step's epsilon and ring position and each epoch's hard-update
flag from the host counters, one for all entries; the sequences' starts as
ring positions; the carry by value), then a body on device tensors only, which
runs the act steps with their ring writes and the epochs' Q steps and updates
the parameters, Adam's moments and the rings in place. On CUDA the body is one
CUDA graph (`learner_fn.update`, a `utils.cuda_graphs.CapturedPhase`), the
stacked GRU kernels and a world-1 all-reduce inside it; CPU tensors, and so a
gloo group's ranks, run it op by op. The rings' counters, the env-step and
train-step counts stay on the host and advance after the body.

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
from mava_tpu_torch.systems.q_learning.types import (
    Carry,
    LearnerState,
    QNetParams,
    Transition,
    UpdateInputs,
)
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.cuda_graphs import CapturedPhase
from mava_tpu_torch.utils.training import (
    make_swept_adam,
    replace_where,
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
    group (by default the process group's ranks), each entry's over its own.
    `learner_fn.update` is the update's `CapturedPhase`."""
    mesh = mesh or make_mesh()
    sys_cfg = config.system
    num_envs, agents = config.arch.num_envs, sys_cfg.num_agents
    rollout, epochs = sys_cfg.rollout_length, sys_cfg.epochs
    step_envs = num_envs * config.arch.n_devices  # one entry's env steps an act step
    fused = sys_cfg.get("fused_target_pass", True)

    def update_q(params: QNetParams, opt, data: Transition,
                 replace: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        q_loss, q_online, target = q_loss_pass(params, data, sys_cfg.gamma, fused)
        grads = torch.autograd.grad(q_loss.sum(), params.online.parameters())
        info = {
            "q_loss": q_loss.detach(),
            "mean_q": per_entry_mean(q_online.detach()),
            "mean_target": per_entry_mean(target),
        }
        grads, info = all_reduce_mean((grads, info), mesh)
        opt.step(grads)
        if sys_cfg.hard_update:  # the entries' train steps move in lockstep: one flag
            replace_where(params.target, params.online, replace)
        else:
            soft_update(params.target, params.online, sys_cfg.tau)
        return info

    def draw_update(state: LearnerState, drawn: IqlDraws) -> UpdateInputs:
        """The update's inputs for every entry, drawn in the order the act steps
        and the epochs take them (the Gumbel noise of every act step, each act
        step's env noise, then each epoch's sequences) or handed in; the
        epsilons, ring positions and hard-update flags from the host counters.
        The sequences are drawn from the rings as they stand after the act
        steps' writes: rows and starts (S, epochs, B), the starts as ring
        positions."""
        device = state.terminal.device
        draw = Draws(num, shared, state.key, device)
        action_noise = drawn.action_noise
        if action_noise is None:
            action_noise = draw(gumbel, (rollout, num_envs, agents, env.action_dim))
        env_noise = [draw.env(env, num_envs) if drawn.env_noise is None
                     else drawn.env_noise[step] for step in range(rollout)]
        epsilon, positions, after, replace = rec_iql.host_inputs(config, buffer, state, step_envs)
        if drawn.rows is None:
            rows, starts = zip(*(buffer.sample_indices(after, draw) for _ in range(epochs)))
            rows, starts = torch.stack(rows, 1), torch.stack(starts, 1)
        else:
            rows, starts = drawn.rows, drawn.starts
        return UpdateInputs(rec_iql.carry_of(state), action_noise, env_noise, epsilon, positions,
                            rows, buffer.physical_starts(after, starts), replace)

    def update_body(state: LearnerState, inputs: UpdateInputs) -> Tuple[Carry, Dict, Dict]:
        """Every entry's act steps, each written into its ring, then the epochs'
        Q steps, on device tensors only: (the new carry, the act steps' episode
        metrics and the epochs' losses (epochs, S), each stacked)."""
        online = state.params.online
        obs, terminal, term_or_trunc, hidden, env_state = inputs.carry
        metrics: List[Dict[str, torch.Tensor]] = []
        with torch.no_grad(), record_function("rec_iql_vmap/rollout"):
            for step in range(rollout):
                entry_obs = stack_observation(obs, num)
                resets = term_or_trunc.reshape(num, 1, num_envs, 1)
                hidden, greedy = online(hidden, (one_step(entry_obs), resets),
                                        inputs.epsilon[step])
                action = greedy.sample_from_noise(inputs.action_noise[:, step][:, None])[:, 0]
                env_state, timestep = env.step(env_state, action.flatten(0, 1),
                                               inputs.env_noise[step])
                transition = Transition(
                    entry_obs, action, timestep.reward.reshape(num, num_envs, agents),
                    terminal.reshape(num, num_envs, 1), term_or_trunc.reshape(num, num_envs, 1),
                    stack_observation(timestep.extras["real_next_obs"], num),
                )
                buffer.write(state.buffer_state, pytree.tree_map(lambda x: x[:, :, None], transition),
                             inputs.positions[step:step + 1])
                obs = timestep.observation
                terminal = (1 - timestep.discount[:, :1]) != 0
                term_or_trunc = timestep.last()[:, None]
                metrics.append(timestep.extras["episode_metrics"])

        losses = []
        with record_function("rec_iql_vmap/train"):
            for epoch in range(epochs):
                data = buffer.gather(state.buffer_state, inputs.rows[:, epoch],
                                     inputs.starts[:, epoch])
                losses.append(update_q(state.params, state.opt_state, data,
                                       None if inputs.replace is None else inputs.replace[epoch]))
        carry = Carry(obs, terminal, term_or_trunc, hidden, env_state)
        return carry, stack_trees(metrics), stack_trees(losses)

    def update_step(state: LearnerState, drawn: IqlDraws) -> Tuple[LearnerState, Tuple]:
        with record_function("rec_iql_vmap/update"):
            carry, metrics, losses = learner_fn.update(state, drawn)
        new_state = state._replace(
            **carry._asdict(), time_steps=state.time_steps + rollout * step_envs,
            train_steps=state.train_steps + epochs,
            buffer_state=buffer.advance(state.buffer_state, rollout),
        )
        return new_state, (metrics, losses)

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

    learner_fn.update = CapturedPhase(draw_update, update_body, rec_iql.update_state_tensors,
                                      rec_iql.update_counters, "the stacked rec-IQL update")
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
