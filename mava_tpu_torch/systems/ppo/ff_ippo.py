"""Feed-forward Independent PPO on one device (port of
`mava_tpu/systems/ppo/ff_ippo.py`); with `centralised_critic` the critic reads
the global state and the system is ff-MAPPO (`ff_mappo.py`).

One update: a `rollout_length`-step rollout that runs only the actor, with all
action noise drawn up front and the distribution's raw parameters stored (the
log-probabilities are taken once, after the rollout); one critic pass over the
stored (T, E) observations plus the bootstrap value; GAE; then `ppo_epochs` x
`num_minibatches` clipped-PPO updates on shuffled rows of the T x E batch.

The reference packs the shuffle payload into one wide int32 matrix (a TPU
gather workaround); here each tensor is gathered with the permutation.
`system.gae_impl` and `system.rollout_unroll` are accepted and ignored.

Data-parallel over ranks (`parallel/`): each rank steps its own `arch.num_envs`
envs with its own draws, and every minibatch step averages the actor's and the
critic's gradients and the loss info over the ranks in one all-reduce
(reference :214) before the clip and Adam; without a process group there is
none.

CLI: python -m mava_tpu_torch.systems.ppo.ff_ippo [overrides]. The port runs on
`arch.device` (default "cuda"; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.envs.stagger import stagger_env_states, stagger_generator
from mava_tpu_torch.envs.wrappers import obs_shape
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.networks import FeedForwardActor, FeedForwardValueNet
from mava_tpu_torch.networks.factory import (
    make_action_head,
    make_log_prob_from_params,
    make_rollout_noise_fn,
    make_torso,
)
from mava_tpu_torch.ops import clipped_ppo_policy_loss, clipped_value_loss
from mava_tpu_torch.ops.gae import calculate_gae
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    put_replicated,
    sharded_env_reset,
)
from mava_tpu_torch.parallel.distributed import rank_generator
from mava_tpu_torch.systems.anakin import (
    restore_full_state,
    restore_params,
    schedule_updates,
    stack_trees,
    start_experiment,
    train_and_evaluate,
)
from mava_tpu_torch.systems.ppo.types import LearnerState, OptStates, Params, PPOTransition
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import (
    entropy_coefficient,
    epoch_permutations,
    make_learning_rate,
    make_optimizer,
)


def get_learner_fn(
    env: Any,
    config: Config,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    return_trajectories: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[[LearnerState], Any]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates.

    `noise` (updates, T, E, A, actions) and `permutations` (updates, epochs,
    T * E) replace the rollout's sampling noise (Gumbel or normal) and the epoch
    shuffles, and `entropy_noise` (updates, epochs, minibatches, *loc) the
    standard normals of a tanh-Normal's entropy estimate, so a test can hand in
    the reference's draws; by default all come from the learner state's
    generator (a discrete head's entropy draws nothing).

    With `return_trajectories` it returns (output, trajectories): the raw
    `PPOTransition` batch of every update, leaves (updates, T, E, ...), as
    the experience-recording program stores it (reference :69-75, :279-295).
    """
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)
    sys_cfg = config.system
    num_envs, rollout = config.arch.num_envs, sys_cfg.rollout_length
    batch_size = rollout * num_envs
    mb_size = batch_size // sys_cfg.num_minibatches
    mesh = mesh or make_mesh()

    def _update_step(state: LearnerState, sample_noise, epoch_perms, ent_noise):
        actor, critic = state.params
        actor_opt, critic_opt = state.opt_states
        gen = state.key
        env_state, timestep = state.env_state, state.timestep
        device = timestep.step_type.device
        if sample_noise is None:
            shape = (rollout, num_envs, sys_cfg.num_agents, env.action_dim)
            sample_noise = noise_fn(shape, gen, device)

        # ---- rollout: only what steering the envs needs, the actor forward.
        # The record_function spans name the update's phases in a profile.
        steps: List[Tuple] = []
        with torch.no_grad(), record_function("ff_ippo/rollout"):
            for t in range(rollout):
                obs = timestep.observation
                pi = actor(obs)
                action = pi.sample_from_noise(sample_noise[t])
                logits = pi.raw_params()
                env_state, timestep = env.step(
                    env_state, action, env.step_noise(num_envs, gen)
                )
                done = timestep.last()[:, None].expand(-1, sys_cfg.num_agents).float()
                info = timestep.extras["episode_metrics"]
                steps.append((done, action, timestep.reward, logits, obs, info))
            dones, actions, rewards, logits, obs_seq, infos = stack_trees(steps)
        with torch.no_grad(), record_function("ff_ippo/critic_gae"):
            log_probs = log_prob_from_params(logits, actions)
            # The critic's parameters are constant during the rollout: one pass
            # over the stored observations, and the bootstrap value.
            values = critic(obs_seq)
            last_val = critic(timestep.observation)
            traj = PPOTransition(dones, actions, values, rewards, log_probs, obs_seq, infos)
            advantages, targets = calculate_gae(
                rewards, values, dones, last_val, sys_cfg.gamma, sys_cfg.gae_lambda
            )
            # Rows of the T x E batch; the losses never read `info`.
            flat_batch = pytree.tree_map(
                lambda x: x.flatten(0, 1), (traj._replace(info={}), advantages, targets)
            )
            if epoch_perms is None:
                epoch_perms = epoch_permutations(sys_cfg.ppo_epochs, batch_size, gen, device)

        actor_params = list(actor.parameters())
        critic_params = list(critic.parameters())
        loss_info = []
        with record_function("ff_ippo/epochs"):
            for epoch in range(sys_cfg.ppo_epochs):
                shuffled = pytree.tree_map(lambda x: x[epoch_perms[epoch]], flat_batch)
                for i in range(sys_cfg.num_minibatches):
                    mb_traj, mb_adv, mb_targets = pytree.tree_map(
                        lambda x: x[i * mb_size : (i + 1) * mb_size], shuffled
                    )
                    ent_coef = entropy_coefficient(config, actor_opt)

                    pi = actor(mb_traj.obs)
                    log_prob = pi.log_prob(mb_traj.action)
                    actor_loss = clipped_ppo_policy_loss(
                        log_prob, mb_traj.log_prob, mb_adv, sys_cfg.clip_eps
                    )
                    # A tanh-Normal's entropy is a one-sample estimate: one
                    # standard normal of loc's shape a minibatch, from `gen`.
                    entropy = pi.entropy(
                        gen, None if ent_noise is None else ent_noise[epoch, i]
                    ).mean()
                    actor_total = actor_loss - ent_coef * entropy
                    actor_grads = torch.autograd.grad(actor_total, actor_params)

                    value = critic(mb_traj.obs)
                    value_loss = clipped_value_loss(
                        value, mb_traj.value, mb_targets, sys_cfg.clip_eps
                    )
                    critic_total = sys_cfg.vf_coef * value_loss
                    critic_grads = torch.autograd.grad(critic_total, critic_params)

                    losses = (actor_total, actor_loss, entropy, critic_total, value_loss)
                    actor_grads, critic_grads, losses = all_reduce_mean(
                        (actor_grads, critic_grads, losses), mesh)
                    actor_total, actor_loss, entropy, critic_total, value_loss = losses
                    actor_opt.step(actor_grads)
                    critic_opt.step(critic_grads)
                    loss_info.append({
                        "total_loss": (actor_total + critic_total).detach(),
                        "value_loss": value_loss.detach(),
                        "actor_loss": actor_loss.detach(),
                        "entropy": entropy.detach(),
                    })

        loss_info = {
            k: torch.stack([m[k] for m in loss_info]).reshape(
                sys_cfg.ppo_epochs, sys_cfg.num_minibatches
            )
            for k in loss_info[0]
        }
        new_state = state._replace(env_state=env_state, timestep=timestep)
        return new_state, (traj, loss_info)

    def learner_fn(state: LearnerState) -> Any:
        trajectories, train_info = [], []
        for u in range(sys_cfg.num_updates_per_eval):
            state, (traj, losses) = _update_step(
                state,
                None if noise is None else noise[u],
                None if permutations is None else permutations[u],
                None if entropy_noise is None else entropy_noise[u],
            )
            trajectories.append(traj)
            train_info.append(losses)
        output = ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees([traj.info for traj in trajectories]),
            train_metrics=stack_trees(train_info),
        )
        if return_trajectories:
            # Actions in the env's action dtype, as the reference records them.
            trajectories = stack_trees(trajectories)
            return output, trajectories._replace(
                action=trajectories.action.to(env.action_spec().dtype))
        return output

    return learner_fn


def make_networks(
    env: Any, config: Config, device: torch.device, seed: int,
    centralised_critic: bool = False,
):
    """The actor and critic, initialised from `seed` as the reference's flax
    initialisers draw (in distribution), then moved to `device`. Each torso
    is sized from the shape of what it reads: an agent's view, or for a
    centralised critic the global state (a vector, or a grid for `CNNTorso`)."""
    net = config.network
    in_shape = obs_shape(env)
    critic_shape = env.global_state_shape if centralised_critic else in_shape
    # nn.init draws from the CPU default generator: seed it inside a fork so
    # the caller's generator state is left as it was.
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        actor_torso = make_torso(net.actor_network.pre_torso, in_shape)
        actor = FeedForwardActor(
            actor_torso,
            make_action_head(net.action_head, actor_torso.out_features, env.action_dim),
        )
        critic = FeedForwardValueNet(
            make_torso(net.critic_network.pre_torso, critic_shape), centralised_critic
        )
    return actor.to(device), critic.to(device)


def learner_setup(
    env: Any,
    generator: torch.Generator,
    config: Config,
    device: torch.device,
    centralised_critic: bool = False,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    return_trajectories: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, torch.nn.Module, LearnerState]:
    """Networks, optimizers, env reset and the learner function
    (`get_learner_fn`'s `return_trajectories` passed on). On `mesh` (by
    default the process group's) this rank resets its rows of the global
    batch from `generator` and draws its steps from its own stream
    (`rank_generator`); the params are checked equal on every rank."""
    config.system.num_agents = env.num_agents
    actor, critic = make_networks(env, config, device, config.system.seed, centralised_critic)

    actor_opt = make_optimizer(
        actor.parameters(), make_learning_rate(config.system.actor_lr, config),
        config.system.max_grad_norm,
    )
    critic_opt = make_optimizer(
        critic.parameters(), make_learning_rate(config.system.critic_lr, config),
        config.system.max_grad_norm,
    )

    mesh = mesh or make_mesh()
    env_state, timestep = sharded_env_reset(
        env, generator, mesh.data_size * config.arch.num_envs, mesh)
    if config.arch.get("stagger_resets", False):
        # Desynchronise the episode boundaries across the batch (envs/stagger.py),
        # each rank's rows with its own offsets.
        env_state, timestep = stagger_env_states(
            env, env_state, timestep,
            rank_generator(stagger_generator(config.system.seed, device), mesh)
        )
    restore_params(config, Params(actor, critic))
    state = LearnerState(
        params=put_replicated(Params(actor, critic), mesh),
        opt_states=OptStates(actor_opt, critic_opt),
        key=rank_generator(generator, mesh),
        env_state=env_state,
        timestep=timestep,
    )
    learner = get_learner_fn(
        env, config, noise=noise, permutations=permutations, entropy_noise=entropy_noise,
        return_trajectories=return_trajectories, mesh=mesh,
    )
    return learner, actor, state


def run_experiment(
    _config: Config, centralised_critic: bool = False
) -> Tuple[float, ExperimentOutput]:
    """Train ff-IPPO (ff-MAPPO when `centralised_critic`: the critic then reads
    the global state that the env factory attaches); returns (evaluation
    performance, last learner output)."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)
    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, actor, learner_state = learner_setup(
        env, generator, config, device, centralised_critic
    )
    # A PPO resume trains a fresh budget on top of the saved state.
    learner_state, start = restore_full_state(config, learner_state)
    # A feed-forward actor carries no state through an episode.
    return train_and_evaluate(
        config, device, learn, actor, learner_state, eval_env,
        make_ff_eval_act_fn(config), lambda absolute_metric: {}, start_step=start or 0,
    )


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("ff-IPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
