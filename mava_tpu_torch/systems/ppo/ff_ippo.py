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

The reference compiles an update into one program (the rollout a `lax.scan`,
:128, the epochs and minibatches two more, :251 and :273). Here an update is
its inputs (`UpdateInputs`: the carry, the env state and timestep, by value,
and every draw, made in the order the update takes them), then a body on
device tensors only: the rollout, the critic pass, GAE and the epochs, which
update the parameters and Adam's moments in place. On CUDA the body is one
CUDA graph (`learner_fn.update`, a `utils.cuda_graphs.CapturedPhase`): the
first update runs it for real and captures it, every later update copies its
inputs in, replays, and takes copies of the new carry, the episode metrics
and the losses; a state at other addresses (a restored checkpoint) is
captured again. The entropy coefficient and a decayed learning rate are
formed on the device from Adam's count. CPU tensors run the body op by op;
`learner_fn.update.eager` runs it op by op on any device.

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
import math
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.distributions import normal
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
from mava_tpu_torch.ops import gru as gru_ops
from mava_tpu_torch.ops import solve as solve_ops
from mava_tpu_torch.ops.gae import calculate_gae
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    put_replicated,
    sharded_env_reset,
)
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.parallel.distributed import rank_generator
from mava_tpu_torch.systems.anakin import (
    restore_full_state,
    restore_params,
    schedule_updates,
    stack_trees,
    start_experiment,
    train_and_evaluate,
)
from mava_tpu_torch.systems.ppo.types import (
    Carry,
    Draws,
    LearnerState,
    OptStates,
    Params,
    PPOTransition,
    UpdateInputs,
)
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.cuda_graphs import CapturedPhase
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
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
) -> Callable[[LearnerState], Any]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates.

    `noise` (updates, T, E, A, actions) and `permutations` (updates, epochs,
    T * E) replace the rollout's sampling noise (Gumbel or normal) and the epoch
    shuffles, `entropy_noise` (updates, epochs, minibatches, *loc) the
    standard normals of a tanh-Normal's entropy estimate, and `env_noise[u][t]`
    what `env.step_noise` would draw at step t of update u, so a test can hand
    in the reference's draws; by default all come from the learner state's
    generator (a discrete head's entropy draws nothing).

    With `return_trajectories` it returns (output, trajectories): the raw
    `PPOTransition` batch of every update, leaves (updates, T, E, ...), as
    the experience-recording program stores it (reference :69-75, :279-295).

    `learner_fn.update` is the update's `CapturedPhase`: `draw_update`, then
    `update_body` (one CUDA graph on the card).
    """
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)
    sys_cfg = config.system
    num_envs, rollout = config.arch.num_envs, sys_cfg.rollout_length
    epochs, minibatches = sys_cfg.ppo_epochs, sys_cfg.num_minibatches
    batch_size = rollout * num_envs
    mb_size = batch_size // minibatches
    mesh = mesh or make_mesh()

    def draw_update(state: LearnerState, drawn: Draws) -> UpdateInputs:
        """The update's inputs: its draws from the generator in the order the
        update takes them (the sampling noise, each step's env noise, the
        epochs' shuffles, a tanh-Normal's entropy normals), or handed in."""
        gen, device = state.key, state.timestep.step_type.device
        sample_noise = drawn.noise
        if sample_noise is None:
            shape = (rollout, num_envs, sys_cfg.num_agents, env.action_dim)
            sample_noise = noise_fn(shape, gen, device)
        step_noise = [env.step_noise(num_envs, gen) if drawn.env_noise is None
                      else drawn.env_noise[t] for t in range(rollout)]
        perms = drawn.permutations
        if perms is None:
            perms = epoch_permutations(epochs, batch_size, gen, device)
        ent_noise = entropy_normals(
            noise_fn, drawn.entropy_noise, (epochs, minibatches),
            (mb_size, sys_cfg.num_agents, env.action_dim), gen, device)
        return UpdateInputs(Carry(state.env_state, state.timestep), sample_noise, step_noise,
                            perms, ent_noise)

    def update_body(state: LearnerState, inputs: UpdateInputs) -> Tuple[Carry, Any, dict]:
        """The rollout, the critic pass, GAE and the epochs, on device tensors
        only: (the new carry, the trajectory batch or, without
        `return_trajectories`, its episode metrics, the losses)."""
        actor, critic = state.params
        actor_opt, critic_opt = state.opt_states
        env_state, timestep = inputs.carry.env_state, inputs.carry.timestep

        # ---- rollout: only what steering the envs needs, the actor forward.
        # The record_function spans name the update's phases in a profile.
        steps: List[Tuple] = []
        with torch.no_grad(), record_function("ff_ippo/rollout"):
            for t in range(rollout):
                obs = timestep.observation
                pi = actor(obs)
                action = pi.sample_from_noise(inputs.noise[t])
                logits = pi.raw_params()
                env_state, timestep = env.step(env_state, action, inputs.env_noise[t])
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

        actor_params = list(actor.parameters())
        critic_params = list(critic.parameters())
        loss_info = []
        with record_function("ff_ippo/epochs"):
            for epoch in range(epochs):
                shuffled = pytree.tree_map(lambda x: x[inputs.permutations[epoch]], flat_batch)
                for i in range(minibatches):
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
                    # standard normal of loc's shape a minibatch, drawn ahead.
                    entropy = pi.entropy(
                        None, None if inputs.entropy_noise is None
                        else inputs.entropy_noise[epoch, i]
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
            k: torch.stack([m[k] for m in loss_info]).reshape(epochs, minibatches)
            for k in loss_info[0]
        }
        return Carry(env_state, timestep), traj if return_trajectories else infos, loss_info

    def learner_fn(state: LearnerState) -> Any:
        trajectories, train_info = [], []
        for u in range(sys_cfg.num_updates_per_eval):
            drawn = Draws(*(None if x is None else x[u]
                            for x in (noise, env_noise, permutations, entropy_noise)))
            with record_function("ff_ippo/update"):
                carry, traj, losses = learner_fn.update(state, drawn)
            state = state._replace(env_state=carry.env_state, timestep=carry.timestep)
            trajectories.append(traj)
            train_info.append(losses)
        output = ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees([traj.info for traj in trajectories]
                                        if return_trajectories else trajectories),
            train_metrics=stack_trees(train_info),
        )
        if return_trajectories:
            # Actions in the env's action dtype, as the reference records them.
            trajectories = stack_trees(trajectories)
            return output, trajectories._replace(
                action=trajectories.action.to(env.action_spec().dtype))
        return output

    learner_fn.update = CapturedPhase(draw_update, update_body, update_state_tensors,
                                      update_counters, "the ff-IPPO update")
    return learner_fn


def entropy_normals(noise_fn: Callable, handed: Optional[torch.Tensor], minibatches: Tuple,
                    loc_shape: Tuple, gen: torch.Generator,
                    device: torch.device) -> Optional[torch.Tensor]:
    """A tanh-Normal's entropy normals (*minibatches, *loc_shape), one draw a
    minibatch in the epochs' order, as its `entropy` draws them; or the
    handed-in ones; None for a discrete head (its entropy draws nothing)."""
    if handed is not None or noise_fn is not normal:
        return handed
    count = math.prod(minibatches)
    return torch.stack([normal(loc_shape, gen, device) for _ in range(count)]).reshape(
        *minibatches, *loc_shape)


def update_state_tensors(state: Any) -> List[torch.Tensor]:
    """The tensors a PPO update reads or writes in place, beside its inputs:
    both networks' parameters and both optimizers' state."""
    return [*(p for net in state.params for p in net.parameters()),
            *(t for opt in state.opt_states for t in opt.state_tensors())]


def update_counters(state: Any) -> List:
    """The host counters a PPO update advances: both optimizers' counts, the
    all-reduces of a data group, the GRU op's launch counts and the
    articulated envs' solve kernel's."""
    return [*((opt, "count") for opt in state.opt_states), (mesh_module, "all_reduces"),
            (gru_ops, "fwd_launches"), (gru_ops, "bwd_launches"), gru_ops.kernel_launches,
            gru_ops.launch_shapes, (solve_ops, "launches")]


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
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
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
        return_trajectories=return_trajectories, mesh=mesh, env_noise=env_noise,
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
