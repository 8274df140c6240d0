"""rec-IPPO over a stack of S entries in one program (port of
`mava_tpu/advanced_usage/rec_ippo_vmap_seeds.py`, which `jax.vmap`s the stock
recurrent learner over a leading seed axis, `:181`).

Built as `ff_ippo_vmap_seeds` is, with the entry axis on the GRU hidden states
and the last dones too. The critic pass over the rollout and the 2 x
`ppo_epochs` x `num_minibatches` BPTT passes go through the stacked GRU kernels:
one launch of the stacked K1 a pass and one of each stacked backward kernel
(K2p, K2a, K2b) a gradient, for all S entries, each with its own resets. So an
update makes exactly the kernel launches of one stock update (17 stacked K1
and 16 of each stacked backward kernel at 4 epochs x 2 minibatches), whatever
S is. The actor's T = 1 rollout steps and the bootstrap value take the plain
recurrence, vmapped, as the stock learner's do.

CLI: python -m mava_tpu_torch.advanced_usage.rec_ippo_vmap_seeds \
    env=smax env/scenario=3s5z arch.num_envs=64 +system.num_seeds=3
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
    train_entries,
)
from mava_tpu_torch.advanced_usage.ff_ippo_vmap_seeds import (
    learner_output,
    loss_info_of,
    make_stacked_optimizers,
    policy_losses,
    time_major,
    value_losses,
)
from mava_tpu_torch.distributions import normal
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.evaluator import get_num_eval_envs, make_rec_eval_act_fn
from mava_tpu_torch.networks import ScannedRNN, StackedNetwork, stack_observation
from mava_tpu_torch.networks.factory import make_log_prob_from_params, make_rollout_noise_fn
from mava_tpu_torch.ops.gae import calculate_gae_with_next_done
from mava_tpu_torch.systems.anakin import schedule_updates, stack_trees, start_experiment
from mava_tpu_torch.systems.ppo import rec_ippo
from mava_tpu_torch.systems.ppo.types import HiddenStates, Params, RNNLearnerState
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import entropy_coefficient


def one_step(tree: Any) -> Any:
    """(S, ...) -> (S, 1, ...): a time axis of one step after the entry axis."""
    return pytree.tree_map(lambda x: x[:, None], tree)


def get_learner_fn(
    env: Any,
    config: Config,
    num: int,
    shared: bool,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
) -> Callable[[RNNLearnerState], ExperimentOutput]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates of
    all `num` entries. The draws are the stock rec-IPPO learner's with the
    entry axis after the update's (`permutations` (updates, S, epochs,
    sequences)), as in `ff_ippo_vmap_seeds.get_learner_fn`."""
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)
    sys_cfg = config.system
    num_envs, rollout = config.arch.num_envs, sys_cfg.rollout_length
    chunk = sys_cfg.recurrent_chunk_size
    num_chunks = rollout // chunk
    num_sequences = num_chunks * num_envs
    layout = sys_cfg.get("chunk_layout", "contiguous")
    mb_size = num_sequences // sys_cfg.num_minibatches
    agents = sys_cfg.num_agents
    to_chunks = torch.func.vmap(lambda x: rec_ippo._chunk(x, layout, chunk, num_chunks))

    def _update_step(state: RNNLearnerState, sample_noise, epoch_perms, ent_noise, step_noise):
        actor, critic = state.params
        actor_opt, critic_opt = state.opt_states
        env_state, timestep, last_done = state.env_state, state.timestep, state.dones
        policy_h = state.hstates.policy_hidden_state
        critic_h0 = state.hstates.critic_hidden_state
        device = last_done.device
        draws = Draws(num, shared, state.key, device)
        if sample_noise is None:
            sample_noise = draws(noise_fn, (rollout, num_envs, agents, env.action_dim))

        # ---- rollout: every entry's actor one step at a time; the critic after.
        steps: List[Tuple] = []
        with torch.no_grad(), record_function("rec_ippo_vmap/rollout"):
            for t in range(rollout):
                obs = stack_observation(timestep.observation, num)
                new_policy_h, pi = actor(policy_h, (one_step(obs), last_done[:, None]))
                action = pi.sample_from_noise(sample_noise[:, t][:, None]).squeeze(1)
                logits = pytree.tree_map(lambda x: x.squeeze(1), pi.raw_params())
                env_state, timestep = env.step(
                    env_state, action.flatten(0, 1),
                    draws.env(env, num_envs) if step_noise is None else step_noise[t],
                )
                done = timestep.last()[:, None].expand(-1, agents).reshape(num, num_envs, agents)
                info = timestep.extras["episode_metrics"]
                steps.append((last_done, action, timestep.reward.reshape(num, num_envs, agents),
                              logits, obs, policy_h, info))
                policy_h, last_done = new_policy_h, done
            dones, actions, rewards, logits, obs_seq, policy_hstates, infos = stack_trees(steps)
        with torch.no_grad(), record_function("rec_ippo_vmap/critic_gae"):
            dones, actions, rewards, logits, obs_seq, policy_hstates = pytree.tree_map(
                time_major, (dones, actions, rewards, logits, obs_seq, policy_hstates))
            log_probs = log_prob_from_params(logits, actions)

            # ---- one stacked critic pass: values, per-step carries, next carry.
            critic_h_after, (critic_carries, values) = critic(
                critic_h0, (obs_seq, dones), collect_carries=True
            )
            _, last_val = critic(
                critic_h_after,
                (one_step(stack_observation(timestep.observation, num)), last_done[:, None]),
            )
            last_val = last_val.squeeze(1)
            advantages, targets = calculate_gae_with_next_done(
                time_major(rewards), time_major(values), time_major(dones).float(),
                last_done.float(), last_val, sys_cfg.gamma, sys_cfg.gae_lambda,
            )
            advantages, targets = time_major(advantages), time_major(targets)

            # ---- each entry's chunked BPTT layout, chunk-initial hidden states
            # only, sequence-major rows for the shuffle: (S, sequences, chunk, ...).
            batch = pytree.tree_map(to_chunks, (
                obs_seq, dones, actions, values, log_probs, advantages, targets,
                HiddenStates(policy_hstates, critic_carries),
            ))
            hstates = pytree.tree_map(lambda h: h[:, 0:1], batch[-1])
            seq_major = pytree.tree_map(lambda x: x.swapaxes(1, 2), (*batch[:-1], hstates))
            if epoch_perms is None:
                epoch_perms = draws.permutations(sys_cfg.ppo_epochs, num_sequences)

        actor_params, critic_params = actor.parameters(), critic.parameters()
        losses = []
        with record_function("rec_ippo_vmap/epochs"):
            for epoch in range(sys_cfg.ppo_epochs):
                shuffled = pytree.tree_map(
                    lambda x: gather_rows(x, epoch_perms[:, epoch]), seq_major)
                for i in range(sys_cfg.num_minibatches):
                    (mb_obs, mb_done, mb_action, mb_value, mb_log_prob, mb_adv, mb_targets,
                     mb_h) = pytree.tree_map(
                        lambda x: x[:, i * mb_size : (i + 1) * mb_size].swapaxes(1, 2), shuffled
                    )
                    ent_coef = entropy_coefficient(config, actor_opt)
                    obs_and_done = (mb_obs, mb_done)

                    _, pi = actor(mb_h.policy_hidden_state[:, 0], obs_and_done)
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

                    _, value = critic(mb_h.critic_hidden_state[:, 0], obs_and_done)
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

        new_state = state._replace(
            env_state=env_state,
            timestep=timestep,
            dones=last_done,
            hstates=HiddenStates(policy_h, critic_h_after),
        )
        return new_state, infos, loss_info_of(losses, config)

    def learner_fn(state: RNNLearnerState) -> ExperimentOutput:
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
) -> Tuple[Callable, StackedNetwork, RNNLearnerState]:
    """The stacked networks, their optimizers, the S * E envs' reset, zero hidden
    states (S, E, A, H) and the learner function (reference `learner_setup`)."""
    reject_stagger(config, "rec-IPPO vmap-seeds/sweep/PBT")
    num_agents = env.num_agents
    config.system.num_agents = num_agents
    shared = sweep_lrs is not None
    nets = [rec_ippo.make_networks(env, config, device, seed, centralised_critic)
            for seed in entry_seeds(config, num, shared)]
    actor = StackedNetwork([n[0] for n in nets])
    critic = StackedNetwork([n[1] for n in nets])
    opt_states = make_stacked_optimizers(actor, critic, config, sweep_lrs)

    num_envs = config.arch.num_envs
    env_state, timestep = env.reset(Draws(num, shared, generator, device).reset(env, num_envs))
    hidden = config.network.hidden_state_dim
    state = RNNLearnerState(
        params=Params(actor, critic),
        opt_states=opt_states,
        key=generator,
        env_state=env_state,
        timestep=timestep,
        dones=torch.zeros((num, num_envs, num_agents), dtype=torch.bool, device=device),
        hstates=HiddenStates(
            ScannedRNN.initialize_carry((num, num_envs, num_agents), hidden, device),
            ScannedRNN.initialize_carry((num, num_envs, num_agents), hidden, device),
        ),
    )
    learner = get_learner_fn(env, config, num, shared, noise=noise, permutations=permutations,
                             entropy_noise=entropy_noise, env_noise=env_noise)
    return learner, actor, state


def prepare(config: Config) -> Config:
    """The recurrent programs' chunk size: the whole rollout unless set."""
    if config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length
    elif config.system.rollout_length % config.system.recurrent_chunk_size != 0:
        raise ValueError("Rollout length must be divisible by recurrent chunk size.")
    return config


def eval_hidden(config: Config, device: torch.device) -> Callable[[], dict]:
    """The evaluator's initial actor state: zero hidden states."""
    def init():
        return {"hidden_state": ScannedRNN.initialize_carry(
            (get_num_eval_envs(config, False), config.system.num_agents),
            config.network.hidden_state_dim, device)}
    return init


def run_experiment(_config: Config, centralised_critic: bool = False,
                   sweep_lrs: Optional[Sequence[float]] = None) -> float:
    """Train `system.num_seeds` seeds (default 4), or one entry per lr of
    `sweep_lrs`, of rec-IPPO (rec-MAPPO when `centralised_critic`); returns the
    mean over the entries of the last evaluation's return."""
    config = prepare(copy.deepcopy(_config))
    refuse_seed_shards(config, "the rec vmap-seeds/sweep programs")
    num = len(sweep_lrs) if sweep_lrs is not None else int(config.system.get("num_seeds", 4))
    device = start_experiment(config)
    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, _, learner_state = learner_setup(
        env, generator, config, device, num, centralised_critic, sweep_lrs=sweep_lrs)
    returns, wins, _ = train_entries(
        config, device, learn, learner_state, eval_env, make_rec_eval_act_fn(config),
        eval_hidden(config, device), num)
    print_entries("rec ", returns, wins, sweep_lrs)
    return float(returns.mean())


def main() -> float:
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
