"""ff-ISAC (ff-MASAC with `centralised_critic`) over a stack of S entries in
one program (port of `mava_tpu/advanced_usage/ff_isac_vmap_seeds.py`, which
`jax.vmap`s the stock explore and update programs over a leading seed axis,
`:235-257`).

Entry s is the stock SAC learner (`systems/sac/ff_isac.py`) on its own slice
of every tensor: its actor, twin critics and their targets (`StackedNetwork`),
its `log_alpha` and entropy target (S, 1, A), its three optimizers
(`make_swept_adam`, eps 1e-8, each entry clipped by its own norm: the actor's,
one joint norm over both critics, alpha's), its E envs (rows [s * E, (s + 1)
* E) of one batch of S * E), its ring of the item buffer (`StackedItemBuffer`:
one host counter and one in-place write for all) and its draws. A train step
is the stock one over the stack: one pass of each network for all S entries
and the sum of the entries' mean losses, so that each entry's gradient is its
own; the actor delay follows the epoch index, the same for every entry. So an
update makes the launches of one stock update whatever S is.

The explore phase runs first, then rounds of `total_timesteps //
num_evaluation` env-steps from the count after it, as the reference's loop
(`:274-321`). With `sweep_lrs` the entries share their init, resets and draws
and differ by `policy_lr = q_lr = sweep_lrs[i]` alone; alpha keeps
`alpha_lr` (`ff_isac_vmap_sweep.py`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_isac_vmap_seeds \
    env=maswarm system.total_timesteps=200000 +system.num_seeds=4
(on the card; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

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
from mava_tpu_torch.distributions import normal
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.networks import StackedNetwork, stack_observation
from mava_tpu_torch.parallel import Mesh, all_reduce_mean, make_mesh, put_replicated
from mava_tpu_torch.parallel.distributed import rank_generator
from mava_tpu_torch.replay import StackedItemBuffer
from mava_tpu_torch.systems.anakin import stack_trees, start_experiment
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.systems.sac.ff_isac import compress_stored_obs, expand_sampled_obs
from mava_tpu_torch.systems.sac.types import (
    Draws as SacDraws,
    LearnerState,
    OptStates,
    QVals,
    QValsAndTarget,
    SacParams,
    Transition,
)
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.centralised_training import get_joint_action, get_updated_joint_actions
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import make_swept_adam, soft_update

ADAM_EPS = ff_isac.ADAM_EPS


def uniform_action(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The explore phase's Uniform[-1, 1] actions."""
    return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0


def get_learner_fns(
    env: Any,
    config: Config,
    buffer: StackedItemBuffer,
    entropy_target: torch.Tensor,
    num: int,
    shared: bool,
    centralised_critic: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable]:
    """(explore_fn, learner_fn) over all `num` entries, as `ff_isac.get_learner_fns`.
    A handed-in `Draws` holds the stock fields with the entry axis in front
    (act_noise (S, rollout, E, A, act), explore (S, steps, E, A, act), rows (S,
    epochs, B), q_noise (S, epochs, B, A, act), actor_noise and alpha_noise (S,
    epochs, delay, B, A, act)) and env_noise one `env.step_noise` of the S * E
    rows a step; by default every entry draws its own from the state's
    generator, or one entry's for all when `shared`. The Q, actor and alpha
    steps average their gradients and losses over `mesh`'s data group (by
    default the process group's ranks), each entry's over its own."""
    mesh = mesh or make_mesh()
    sys_cfg = config.system
    num_envs, num_agents, act = config.arch.num_envs, env.num_agents, env.action_dim
    rollout, epochs, delay = sys_cfg.rollout_length, sys_cfg.epochs, sys_cfg.policy_update_delay
    batch = sys_cfg.batch_size
    if delay <= 0:
        raise ValueError("system.policy_update_delay must be positive.")

    def critic_action(action: torch.Tensor) -> torch.Tensor:
        return get_joint_action(action) if centralised_critic else action

    def per_entry(x: torch.Tensor) -> torch.Tensor:
        """(S * E, ...) -> (S, E, ...)."""
        return x.reshape(num, num_envs, *x.shape[1:])

    def env_step(state: LearnerState, action: torch.Tensor, env_noise, draw: Draws):
        """One step of the S * E envs; every entry's transition goes into its ring."""
        if env_noise is None:
            env_noise = draw.env(env, num_envs)
        env_state, timestep = env.step(state.env_state, action.flatten(0, 1), env_noise)
        transition = Transition(
            stack_observation(compress_stored_obs(state.obs), num),
            action,
            per_entry(timestep.reward),
            per_entry(~timestep.discount.to(torch.bool)),
            stack_observation(compress_stored_obs(timestep.extras["real_next_obs"]), num),
        )
        with record_function("sac_vmap/ring_write"):
            buffer_state = buffer.add(state.buffer_state, transition)
        state = state._replace(obs=timestep.observation, env_state=env_state,
                               buffer_state=buffer_state, t=state.t + num_envs)
        return state, timestep.extras["episode_metrics"]

    def drawn_or_new(values: Optional[torch.Tensor], index: int, shape, draw: Draws):
        """values[:, index], or standard normals of `shape` an entry."""
        return draw(normal, shape) if values is None else values[:, index]

    def update_q(params: SacParams, opt_states: OptStates, data: Transition, noise: torch.Tensor):
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
        q1_loss = per_entry_mean(torch.square(q1_values - target))
        q2_loss = per_entry_mean(torch.square(q2_values - target))
        loss = q1_loss + q2_loss
        grads = torch.autograd.grad(loss.sum(), opt_states.q.params)
        info = {
            "loss": loss.detach(),
            "q1_loss": q1_loss.detach(),
            "q2_loss": q2_loss.detach(),
            "q1_a_vals": per_entry_mean(q1_values.detach()),
            "q2_a_vals": per_entry_mean(q2_values.detach()),
        }
        grads, info = all_reduce_mean((grads, info), mesh)
        opt_states.q.step(grads)
        soft_update(targets.q1, online.q1, sys_cfg.tau)
        soft_update(targets.q2, online.q2, sys_cfg.tau)
        return info

    def update_actor_and_alpha(params: SacParams, opt_states: OptStates, data: Transition,
                               actor_noise: torch.Tensor, alpha_noise: torch.Tensor):
        online = params.q.online
        actor_params = opt_states.actor.params
        for d in range(delay):
            alpha = torch.exp(params.log_alpha).detach()
            pi = params.actor(data.obs)
            action, log_prob = pi.sample_and_log_prob(noise=actor_noise[:, d])
            q_action = (get_updated_joint_actions(data.action, action)
                        if centralised_critic else action)
            min_q = torch.minimum(online.q1(data.obs, q_action), online.q2(data.obs, q_action))
            actor_loss = per_entry_mean((alpha * log_prob) - min_q)
            grads = torch.autograd.grad(actor_loss.sum(), actor_params)
            grads, actor_loss = all_reduce_mean((grads, actor_loss.detach()), mesh)
            opt_states.actor.step(grads)

            alpha_loss = torch.zeros(num, device=actor_loss.device)
            if sys_cfg.autotune:
                with torch.no_grad():
                    _, log_prob = params.actor(data.obs).sample_and_log_prob(
                        noise=alpha_noise[:, d])
                alpha_loss = per_entry_mean(
                    -torch.exp(params.log_alpha) * (log_prob + entropy_target))
                grads = torch.autograd.grad(alpha_loss.sum(), [params.log_alpha])
                grads, alpha_loss = all_reduce_mean((grads, alpha_loss.detach()), mesh)
                opt_states.alpha.step(grads)
        return {"actor_loss": actor_loss.detach(), "alpha_loss": alpha_loss.detach()}

    def train(state: LearnerState, drawn: SacDraws, draw: Draws) -> List[Dict[str, torch.Tensor]]:
        params, opt_states = state.params, state.opt_states
        sample_shape = (batch, num_agents, act)
        losses = []
        for epoch in range(epochs):
            rows = (buffer.sample_indices(state.buffer_state, draw) if drawn.rows is None
                    else drawn.rows[:, epoch])
            data = buffer.sample(state.buffer_state, rows)
            data = data._replace(obs=expand_sampled_obs(data.obs, num_agents),
                                 next_obs=expand_sampled_obs(data.next_obs, num_agents))
            q_noise = drawn_or_new(drawn.q_noise, epoch, sample_shape, draw)
            info = update_q(params, opt_states, data, q_noise)
            if epoch % delay == 0:  # on the epoch index, as the stock learner
                shape = (delay, *sample_shape)
                actor_noise = drawn_or_new(drawn.actor_noise, epoch, shape, draw)
                alpha_noise = drawn_or_new(drawn.alpha_noise, epoch, shape, draw)
                info.update(update_actor_and_alpha(params, opt_states, data, actor_noise,
                                                   alpha_noise))
            else:
                zero = torch.zeros(num, device=params.log_alpha.device)
                info.update(actor_loss=zero, alpha_loss=zero)
            losses.append(info)
        return losses

    def update_step(state: LearnerState, drawn: SacDraws) -> Tuple[LearnerState, Tuple]:
        draw = Draws(num, shared, state.key, state.params.log_alpha.device)
        act_noise = drawn.act_noise
        if act_noise is None:
            act_noise = draw(normal, (rollout, num_envs, num_agents, act))
        metrics = []
        with torch.no_grad(), record_function("sac_vmap/act"):
            for step in range(rollout):
                obs = stack_observation(state.obs, num)
                action = state.params.actor(obs).sample_from_noise(act_noise[:, step])
                env_noise = None if drawn.env_noise is None else drawn.env_noise[step]
                state, info = env_step(state, action, env_noise, draw)
                metrics.append(info)
        with record_function("sac_vmap/train"):
            losses = train(state, drawn, draw)
        return state, (stack_trees(metrics), stack_trees(losses))

    def explore_fn(state: LearnerState, draws: Optional[SacDraws] = None):
        """`explore_steps // num_envs` steps of Uniform[-1, 1] actions for every
        entry; returns (state, episode metrics (steps, S * E))."""
        draws = draws or SacDraws()
        draw = Draws(num, shared, state.key, state.params.log_alpha.device)
        metrics = []
        with torch.no_grad(), record_function("sac_vmap/explore"):
            for step in range(sys_cfg.explore_steps // num_envs):
                action = (draw(uniform_action, (num_envs, num_agents, act))
                          if draws.explore is None else draws.explore[:, step])
                env_noise = None if draws.env_noise is None else draws.env_noise[step]
                state, info = env_step(state, action, env_noise, draw)
                metrics.append(info)
        return state, stack_trees(metrics)

    def learner_fn(state: LearnerState, draws: Optional[Sequence[SacDraws]] = None):
        episode_info, train_info = [], []
        for u in range(sys_cfg.get("scan_steps", 1)):
            state, (info, losses) = update_step(state, SacDraws() if draws is None else draws[u])
            episode_info.append(info)
            train_info.append(losses)
        train_metrics = {k: v.movedim(-1, 0) for k, v in stack_trees(train_info).items()}
        train_metrics["log_alpha"] = state.params.log_alpha.detach().clone()
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees(episode_info),
            train_metrics=train_metrics,
        )

    return explore_fn, learner_fn


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    num: int,
    centralised_critic: bool = False,
    sweep_lrs: Optional[Sequence[float]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable, StackedNetwork, LearnerState]:
    """The stacked networks (entry s from `entry_seeds`; the targets start as
    copies of the online critics), `log_alpha` and the entropy target (S, 1,
    A), the three swept optimizers, the S * E envs' reset and the stacked
    buffer; returns (explore_fn, learner_fn, actor, state). On a seed-sharded
    `mesh` (by default the process group's data mesh) the learner holds this
    rank's entries of the `num` (`local_entries`): their networks and rings,
    on its rows of each entry's envs."""
    reject_stagger(config, "ff-ISAC/ff-MASAC vmap-seeds/sweep")
    sys_cfg = config.system
    num_agents, act = env.num_agents, env.action_dim
    sys_cfg.num_agents = num_agents
    shared = sweep_lrs is not None
    if shared and len(sweep_lrs) != num:
        raise ValueError(f"one lr per sweep entry: {len(sweep_lrs)} lrs for {num} entries")
    mesh = mesh or make_mesh()
    entries = local_entries(mesh, num)
    env_state, timestep = entry_reset(env, generator, num, shared, config.arch.num_envs, mesh,
                                      device)
    if shared:
        sweep_lrs = sweep_lrs[entries.start:entries.stop]
    seeds = entry_seeds(config, num, shared)[entries.start:entries.stop]
    num = len(entries)
    nets = [ff_isac.make_networks(env, config, device, seed, centralised_critic)
            for seed in seeds]
    actor, q1, q2 = (StackedNetwork([n[i] for n in nets]) for i in range(3))
    targets = QVals(*(StackedNetwork([n[i] for n in nets]) for i in (1, 2)))

    entropy_target = ff_isac.target_entropy(config, num_agents, act, device).expand(
        num, 1, num_agents).contiguous()
    log_alpha = ff_isac.initial_log_alpha(config, entropy_target)
    params = SacParams(actor, QValsAndTarget(QVals(q1, q2), targets), log_alpha)

    clip = sys_cfg.max_grad_norm
    opt_states = OptStates(
        actor=make_swept_adam(actor.parameters(), sweep_lrs if shared else sys_cfg.policy_lr,
                              clip, eps=ADAM_EPS),
        q=make_swept_adam([*q1.parameters(), *q2.parameters()],
                          sweep_lrs if shared else sys_cfg.q_lr, clip, eps=ADAM_EPS),
        alpha=make_swept_adam([log_alpha], sys_cfg.alpha_lr, clip, eps=ADAM_EPS),
    )

    obs = timestep.observation
    buffer = ff_isac.make_buffer(config, entries=num)
    buffer_state = buffer.init(ff_isac.dummy_transition(obs, num_agents, act, device))
    state = LearnerState(obs, env_state, buffer_state, put_replicated(params, mesh), opt_states,
                         0, rank_generator(generator, mesh, shared_over_seed_groups=shared))
    explore_fn, learner_fn = get_learner_fns(env, config, buffer, entropy_target, num, shared,
                                             centralised_critic, mesh)
    return explore_fn, learner_fn, actor, state


def run_experiment(_config: Config, centralised_critic: bool = False,
                   sweep_lrs: Optional[Sequence[float]] = None) -> float:
    """Train `system.num_seeds` seeds (default 4), or one entry per lr of
    `sweep_lrs`, of ff-ISAC (ff-MASAC when `centralised_critic`); returns the
    mean over the entries of the last evaluation's return."""
    config = copy.deepcopy(_config)
    num = len(sweep_lrs) if sweep_lrs is not None else int(config.system.get("num_seeds", 4))
    device = start_experiment(config)
    mesh, _ = seed_placement(config, num)
    config, steps_per_rollout = schedule_rounds(config)
    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    explore, learn, _, learner_state = learner_setup(
        env, generator, config, device, num, centralised_critic, sweep_lrs, mesh=mesh)
    # An entry's env-steps over the ranks of its group (`state.t` counts one rank's).
    ranks = config.arch.n_devices
    start = config.system.explore_steps // config.arch.num_envs * config.arch.num_envs * ranks

    def explore_phase(state: LearnerState):
        state, metrics = explore(state)
        return state, metrics, state.t * ranks

    # The reference's range(t, total + 1, steps_per_rollout), each logged at its end.
    rounds = [t + steps_per_rollout for t in
              range(start, int(config.system.total_timesteps) + 1, steps_per_rollout)]
    returns, _, _ = train_entries(
        config, device, learn, learner_state, eval_env, make_ff_eval_act_fn(config),
        lambda: {}, num, policy=lambda state: state.params.actor, explore=explore_phase,
        rounds=rounds, steps_per_round=steps_per_rollout, mesh=mesh)
    print_entries("", returns, None, sweep_lrs)
    return float(returns.mean())


def main() -> float:
    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-ISAC vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
