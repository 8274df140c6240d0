"""ff-IPPO over a stack of S entries in one program (port of
`mava_tpu/advanced_usage/ff_ippo_vmap_seeds.py`, which `jax.vmap`s the stock
learner over a leading seed axis, `:171`).

Entry s is the stock ff-IPPO learner (`systems/ppo/ff_ippo.py`) on its own
slice of every tensor: its parameters, its optimizers' moments and peak
learning rates (`SweptClippedAdam`), its E envs (rows [s * E, (s + 1) * E) of
one batch of S * E), its draws. One update makes the launches of one stock
update whatever S is: the actor and critic run over the stack at once
(`StackedNetwork`), the envs step as one batch, GAE runs over the entry axis,
each epoch gathers every entry's rows in its own order with one index (S, N),
and the loss of a minibatch is the sum of the entries' mean losses, so that
each entry's gradient is its own. With `sweep_lrs` the entries share their
init, resets and draws and differ by their learning rate alone (the sweeps and
PBT). `system.gae_impl` is accepted and ignored, as everywhere in the port.

CLI: python -m mava_tpu_torch.advanced_usage.ff_ippo_vmap_seeds \
    env=rware env/scenario=tiny-2ag arch.num_envs=128 +system.num_seeds=4
(on the card; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.advanced_usage.common import (
    Draws,
    entry_seeds,
    gather_rows,
    per_entry_mean,
    print_entries,
    refuse_seed_shards,
    tile,
    train_entries,
)
from mava_tpu_torch.distributions import normal
from mava_tpu_torch.envs.stagger import stagger_env_states, stagger_generator
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.networks import StackedNetwork, stack_observation
from mava_tpu_torch.networks.factory import make_log_prob_from_params, make_rollout_noise_fn
from mava_tpu_torch.ops import clipped_ppo_policy_loss, clipped_value_loss
from mava_tpu_torch.ops.gae import calculate_gae
from mava_tpu_torch.systems.anakin import schedule_updates, stack_trees, start_experiment
from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.systems.ppo.types import LearnerState, OptStates, Params
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import entropy_coefficient, make_swept_optimizer

# The reference's per-minibatch losses, each entry's on its own rows: (S, ...) -> (S,).
policy_losses = torch.func.vmap(clipped_ppo_policy_loss, in_dims=(0, 0, 0, None))
value_losses = torch.func.vmap(clipped_value_loss, in_dims=(0, 0, 0, None))


def time_major(x: torch.Tensor) -> torch.Tensor:
    """(S, T, ...) <-> (T, S, ...)."""
    return x.movedim(1, 0)


def loss_info_of(losses: List[dict], config: Config) -> dict:
    """Per-minibatch (S,) losses -> {name: (S, epochs, minibatches)}."""
    sys_cfg = config.system
    return {
        k: torch.stack([m[k] for m in losses]).reshape(
            sys_cfg.ppo_epochs, sys_cfg.num_minibatches, -1).movedim(-1, 0)
        for k in losses[0]
    }


def learner_output(updates: List[Tuple[Any, Any, dict]]) -> ExperimentOutput:
    """The learner's output from its updates' (state, episode info, losses):
    train metrics (S, updates, epochs, minibatches), as the reference's."""
    state = updates[-1][0]
    train = stack_trees([u[2] for u in updates])
    return ExperimentOutput(
        learner_state=state,
        episode_metrics=stack_trees([u[1] for u in updates]),
        train_metrics={k: v.movedim(0, 1) for k, v in train.items()},
    )


def get_learner_fn(
    env: Any,
    config: Config,
    num: int,
    shared: bool,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
) -> Callable[[LearnerState], ExperimentOutput]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates of
    all `num` entries.

    The stock learner's draws with the entry axis after the update's:
    `noise` (updates, S, T, E, A, actions), `permutations` (updates, S, epochs,
    T * E), `entropy_noise` (updates, S, epochs, minibatches, *loc), and
    `env_noise[u][t]` what the envs' `step_noise` would draw for the S * E rows
    at step t of update u; by default all come from the state's generator,
    each entry its own unless `shared`.
    """
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)
    sys_cfg = config.system
    num_envs, rollout = config.arch.num_envs, sys_cfg.rollout_length
    batch_size = rollout * num_envs
    mb_size = batch_size // sys_cfg.num_minibatches
    agents = sys_cfg.num_agents

    def _update_step(state: LearnerState, sample_noise, epoch_perms, ent_noise, step_noise):
        actor, critic = state.params
        actor_opt, critic_opt = state.opt_states
        env_state, timestep = state.env_state, state.timestep
        device = timestep.step_type.device
        draws = Draws(num, shared, state.key, device)
        if sample_noise is None:
            sample_noise = draws(noise_fn, (rollout, num_envs, agents, env.action_dim))

        # ---- rollout: the actor of every entry on its envs, one batch.
        steps: List[Tuple] = []
        with torch.no_grad(), record_function("ff_ippo_vmap/rollout"):
            for t in range(rollout):
                obs = stack_observation(timestep.observation, num)
                pi = actor(obs)
                action = pi.sample_from_noise(sample_noise[:, t])
                logits = pi.raw_params()
                env_state, timestep = env.step(
                    env_state, action.flatten(0, 1),
                    draws.env(env, num_envs) if step_noise is None else step_noise[t],
                )
                done = timestep.last()[:, None].expand(-1, agents).float()
                info = timestep.extras["episode_metrics"]
                steps.append((done.reshape(num, num_envs, agents), action,
                              timestep.reward.reshape(num, num_envs, agents), logits, obs, info))
            dones, actions, rewards, logits, obs_seq, infos = stack_trees(steps)
        with torch.no_grad(), record_function("ff_ippo_vmap/critic_gae"):
            # Entry-major from here: (S, T, E, ...).
            dones, actions, rewards, logits, obs_seq = pytree.tree_map(
                time_major, (dones, actions, rewards, logits, obs_seq))
            log_probs = log_prob_from_params(logits, actions)
            values = critic(obs_seq)
            last_val = critic(stack_observation(timestep.observation, num))
            advantages, targets = calculate_gae(
                time_major(rewards), time_major(values), time_major(dones), last_val,
                sys_cfg.gamma, sys_cfg.gae_lambda,
            )
            advantages, targets = time_major(advantages), time_major(targets)
            # Each entry's rows of its T x E batch: (S, T * E, ...).
            flat_batch = pytree.tree_map(
                lambda x: x.flatten(1, 2),
                (obs_seq, actions, values, log_probs, advantages, targets),
            )
            if epoch_perms is None:
                epoch_perms = draws.permutations(sys_cfg.ppo_epochs, batch_size)

        actor_params, critic_params = actor.parameters(), critic.parameters()
        losses = []
        with record_function("ff_ippo_vmap/epochs"):
            for epoch in range(sys_cfg.ppo_epochs):
                shuffled = pytree.tree_map(
                    lambda x: gather_rows(x, epoch_perms[:, epoch]), flat_batch)
                for i in range(sys_cfg.num_minibatches):
                    mb_obs, mb_action, mb_value, mb_log_prob, mb_adv, mb_targets = pytree.tree_map(
                        lambda x: x[:, i * mb_size : (i + 1) * mb_size], shuffled
                    )
                    ent_coef = entropy_coefficient(config, actor_opt)

                    pi = actor(mb_obs)
                    log_prob = pi.log_prob(mb_action)
                    actor_loss = policy_losses(log_prob, mb_log_prob, mb_adv, sys_cfg.clip_eps)
                    if ent_noise is not None:
                        entropy_draw = ent_noise[:, epoch, i]
                    elif isinstance(pi.raw_params(), tuple):  # a tanh-Normal's one-sample estimate
                        entropy_draw = draws(normal, pi.raw_params()[0].shape[1:])
                    else:
                        entropy_draw = None
                    entropy = per_entry_mean(pi.entropy(None, entropy_draw))
                    actor_total = actor_loss - ent_coef * entropy
                    actor_grads = torch.autograd.grad(actor_total.sum(), actor_params)

                    value = critic(mb_obs)
                    value_loss = value_losses(value, mb_value, mb_targets, sys_cfg.clip_eps)
                    critic_total = sys_cfg.vf_coef * value_loss
                    critic_grads = torch.autograd.grad(critic_total.sum(), critic_params)

                    actor_opt.step(actor_grads)
                    critic_opt.step(critic_grads)
                    losses.append({
                        "total_loss": (actor_total + critic_total).detach(),
                        "value_loss": value_loss.detach(),
                        "actor_loss": actor_loss.detach(),
                        "entropy": entropy.detach(),
                    })

        new_state = state._replace(env_state=env_state, timestep=timestep)
        return new_state, infos, loss_info_of(losses, config)

    def learner_fn(state: LearnerState) -> ExperimentOutput:
        updates = []
        for u in range(sys_cfg.num_updates_per_eval):
            state, info, losses = _update_step(
                state,
                None if noise is None else noise[u],
                None if permutations is None else permutations[u],
                None if entropy_noise is None else entropy_noise[u],
                None if env_noise is None else env_noise[u],
            )
            updates.append((state, info, losses))
        return learner_output(updates)

    return learner_fn


def make_stacked_optimizers(actor: StackedNetwork, critic: StackedNetwork, config: Config,
                            sweep_lrs: Optional[Sequence[float]]) -> OptStates:
    """Each entry's clipped Adam at `system.actor_lr` / `critic_lr`, or at its
    sweep lr for both (the reference's `make_swept_optimizer` + `set_peak_lr`)."""
    num = actor.size
    actor_lrs = sweep_lrs if sweep_lrs is not None else [config.system.actor_lr] * num
    critic_lrs = sweep_lrs if sweep_lrs is not None else [config.system.critic_lr] * num
    if len(actor_lrs) != num:
        raise ValueError(f"one lr per sweep entry: {len(actor_lrs)} lrs for {num} entries")
    max_norm = config.system.max_grad_norm
    return OptStates(
        make_swept_optimizer(actor.parameters(), config, max_norm, actor_lrs),
        make_swept_optimizer(critic.parameters(), config, max_norm, critic_lrs),
    )


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    num: int,
    centralised_critic: bool = False,
    sweep_lrs: Optional[Sequence[float]] = None,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
) -> Tuple[Callable, StackedNetwork, LearnerState]:
    """The stacked networks (entry s from `entry_seeds`), their optimizers, the
    S * E envs' reset and the learner function (reference `learner_setup`)."""
    config.system.num_agents = env.num_agents
    shared = sweep_lrs is not None
    nets = [ff_ippo.make_networks(env, config, device, seed, centralised_critic)
            for seed in entry_seeds(config, num, shared)]
    actor = StackedNetwork([n[0] for n in nets])
    critic = StackedNetwork([n[1] for n in nets])
    opt_states = make_stacked_optimizers(actor, critic, config, sweep_lrs)

    num_envs = config.arch.num_envs
    draws = Draws(num, shared, generator, device)
    if config.arch.get("stagger_resets", False):
        # Desynchronised episode boundaries (envs/stagger.py): each entry its own
        # offsets, or one entry's offsets for every entry of a sweep.
        stagger = stagger_generator(config.system.seed, device)
        env_state, timestep = env.reset(env.reset_noise(num_envs if shared else num * num_envs,
                                                        generator))
        env_state, timestep = stagger_env_states(env, env_state, timestep, stagger)
        if shared:
            env_state, timestep = tile((env_state, timestep), num)
    else:
        env_state, timestep = env.reset(draws.reset(env, num_envs))
    state = LearnerState(
        params=Params(actor, critic),
        opt_states=opt_states,
        key=generator,
        env_state=env_state,
        timestep=timestep,
    )
    learner = get_learner_fn(env, config, num, shared, noise=noise, permutations=permutations,
                             entropy_noise=entropy_noise, env_noise=env_noise)
    return learner, actor, state


def run_experiment(_config: Config, centralised_critic: bool = False,
                   sweep_lrs: Optional[Sequence[float]] = None) -> float:
    """Train `system.num_seeds` seeds (default 4), or one entry per lr of
    `sweep_lrs`, of ff-IPPO (ff-MAPPO when `centralised_critic`); returns the
    mean over the entries of the last evaluation's return."""
    config = copy.deepcopy(_config)
    program = "the ff vmap-seeds/sweep programs"
    refuse_seed_shards(config, program)
    num = len(sweep_lrs) if sweep_lrs is not None else int(config.system.get("num_seeds", 4))
    device = start_experiment(config)
    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, _, learner_state = learner_setup(
        env, generator, config, device, num, centralised_critic, sweep_lrs=sweep_lrs)
    returns, wins, _ = train_entries(
        config, device, learn, learner_state, eval_env, make_ff_eval_act_fn(config),
        lambda: {}, num)
    print_entries("", returns, wins, sweep_lrs)
    return float(returns.mean())


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
