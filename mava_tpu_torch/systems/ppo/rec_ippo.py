"""Recurrent (GRU) Independent PPO on one device (port of
`mava_tpu/systems/ppo/rec_ippo.py`); with `centralised_critic` the critic reads
the global state and the system is rec-MAPPO (`rec_mappo.py`).

One update: a `rollout_length`-step rollout where the actor runs one step at a
time (T = 1, the plain GRU path) with all action noise drawn up front; one
batched critic pass over the stored rollout (the GRU kernel, T = rollout) that
yields values, per-step critic carries and the carry for the next update; a
bootstrap value; GAE with `next_done`; then `ppo_epochs` x `num_minibatches`
updates on shuffled whole sequences, each re-running both GRUs from the
chunk-initial hidden state (BPTT through the kernel's backward).

Data-parallel over ranks (`parallel/`): each rank steps its own `arch.num_envs`
envs with its own draws, and every minibatch step averages the actor's and the
critic's gradients and the loss info over the ranks in one all-reduce
(reference :298) before the clip and Adam; without a process group there is
none.

The reference packs the shuffle payload into one wide int32 matrix (a TPU
gather workaround); here each tensor is gathered with the permutation.

As in ff-IPPO (`ff_ippo.py`), an update is its inputs (`UpdateInputs`: the
carry, the env state, timestep, done flags and both hidden states, by value,
and the draws) then a body on device tensors only, which on CUDA is one CUDA
graph (`learner_fn.update`) with the GRU kernels inside it: the critic pass
at T = rollout and each minibatch's BPTT forward and backward; the actor's
T = 1 steps take the plain path. The reference compiles the same update
(:149, :335, :352, :367).

CLI: python -m mava_tpu_torch.systems.ppo.rec_ippo [overrides]. The port runs on
`arch.device` (default "cuda"; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.envs.stagger import reject_stagger
from mava_tpu_torch.envs.wrappers import obs_shape
from mava_tpu_torch.evaluator import get_num_eval_envs, make_rec_eval_act_fn
from mava_tpu_torch.networks import RecurrentActor, RecurrentValueNet, ScannedRNN
from mava_tpu_torch.networks.factory import (
    make_action_head,
    make_log_prob_from_params,
    make_rollout_noise_fn,
    make_torso,
)
from mava_tpu_torch.ops import clipped_ppo_policy_loss, clipped_value_loss
from mava_tpu_torch.ops.gae import calculate_gae_with_next_done
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    put_replicated,
    sharded_env_reset,
    tile_for_shards,
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
from mava_tpu_torch.systems.ppo.ff_ippo import (
    entropy_normals,
    update_counters,
    update_state_tensors,
)
from mava_tpu_torch.systems.ppo.types import (
    Carry,
    Draws,
    HiddenStates,
    OptStates,
    Params,
    RNNLearnerState,
    RNNPPOTransition,
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


def _chunk(x: torch.Tensor, layout: str, chunk: int, num_chunks: int) -> torch.Tensor:
    """(T, E, ...) -> (chunk, num_chunks * E, ...) (reference :210-237)."""
    if layout == "contiguous":
        x = x.reshape(num_chunks, chunk, *x.shape[1:]).swapaxes(0, 1)
        return x.reshape(chunk, num_chunks * x.shape[2], *x.shape[3:])
    if layout == "strided":
        return x.reshape(chunk, num_chunks * x.shape[1], *x.shape[2:])
    raise ValueError(
        f"Unknown chunk_layout '{layout}' (expected 'contiguous' or 'strided')."
    )


def get_learner_fn(
    env: Any,
    config: Config,
    noise: Optional[torch.Tensor] = None,
    permutations: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[RNNLearnerState], ExperimentOutput]:
    """Build `learner_fn(state)`, which runs `num_updates_per_eval` updates,
    data-parallel over `mesh` (by default the process group's, if any).

    `noise` (updates, T, E, A, actions) and `permutations` (updates, epochs,
    sequences) replace the rollout's sampling noise (Gumbel or normal) and the epoch
    shuffles, `entropy_noise` (updates, epochs, minibatches, *loc) the
    standard normals of a tanh-Normal's entropy estimate, and `env_noise[u][t]`
    what `env.step_noise` would draw at step t of update u (the auto-reset's
    draws included), so a test can hand in the reference's draws; by default
    all come from the learner state's generator (a discrete head's entropy
    draws nothing).

    `learner_fn.update` is the update's `CapturedPhase`: `draw_update`, then
    `update_body` (one CUDA graph on the card, the GRU kernels inside it).
    """
    noise_fn = make_rollout_noise_fn(config.network.action_head)
    log_prob_from_params = make_log_prob_from_params(config.network.action_head)
    sys_cfg = config.system
    num_envs, rollout = config.arch.num_envs, sys_cfg.rollout_length
    epochs, minibatches = sys_cfg.ppo_epochs, sys_cfg.num_minibatches
    chunk = sys_cfg.recurrent_chunk_size
    num_chunks = rollout // chunk
    num_sequences = num_chunks * num_envs
    layout = sys_cfg.get("chunk_layout", "contiguous")
    mb_size = num_sequences // minibatches
    mesh = mesh or make_mesh()

    def draw_update(state: RNNLearnerState, drawn: Draws) -> UpdateInputs:
        """The update's inputs: its draws from the generator in the order the
        update takes them (the sampling noise, each step's env noise, the
        epochs' shuffles, a tanh-Normal's entropy normals), or handed in."""
        gen, device = state.key, state.dones.device
        sample_noise = drawn.noise
        if sample_noise is None:
            shape = (rollout, num_envs, sys_cfg.num_agents, env.action_dim)
            sample_noise = noise_fn(shape, gen, device)
        step_noise = [env.step_noise(num_envs, gen) if drawn.env_noise is None
                      else drawn.env_noise[t] for t in range(rollout)]
        perms = drawn.permutations
        if perms is None:
            perms = epoch_permutations(epochs, num_sequences, gen, device)
        ent_noise = entropy_normals(
            noise_fn, drawn.entropy_noise, (epochs, minibatches),
            (chunk, mb_size, sys_cfg.num_agents, env.action_dim), gen, device)
        carry = Carry(state.env_state, state.timestep, state.dones, state.hstates)
        return UpdateInputs(carry, sample_noise, step_noise, perms, ent_noise)

    def update_body(state: RNNLearnerState, inputs: UpdateInputs) -> Tuple[Carry, Dict, Dict]:
        """The rollout, the critic pass, GAE and the epochs' BPTT, on device
        tensors only: (the new carry, the episode metrics, the losses)."""
        actor, critic = state.params
        actor_opt, critic_opt = state.opt_states
        env_state, timestep, last_done, hstates = inputs.carry
        policy_h = hstates.policy_hidden_state
        critic_h0 = hstates.critic_hidden_state

        # ---- rollout: the actor one step at a time; the critic runs after.
        # The record_function spans name the update's phases in a profile.
        steps: List[Tuple] = []
        with torch.no_grad(), record_function("rec_ippo/rollout"):
            for t in range(rollout):
                obs = timestep.observation
                new_policy_h, pi = actor(
                    policy_h, (pytree.tree_map(lambda x: x[None], obs), last_done[None])
                )
                action = pi.sample_from_noise(inputs.noise[t][None]).squeeze(0)
                # A tuple (loc, scale) for a continuous head.
                logits = pytree.tree_map(lambda x: x.squeeze(0), pi.raw_params())
                env_state, timestep = env.step(env_state, action, inputs.env_noise[t])
                done = timestep.last()[:, None].expand(-1, sys_cfg.num_agents)
                info = timestep.extras["episode_metrics"]
                steps.append(
                    (last_done, action, timestep.reward, logits, obs, policy_h, info)
                )
                policy_h, last_done = new_policy_h, done
            (dones, actions, rewards, logits, obs_seq, policy_hstates, infos) = stack_trees(steps)
        with torch.no_grad(), record_function("rec_ippo/critic_gae"):
            log_probs = log_prob_from_params(logits, actions)

            # ---- one batched critic pass: values, per-step carries, next carry.
            critic_h_after, (critic_carries, values) = critic(
                critic_h0, (obs_seq, dones), collect_carries=True
            )
            _, last_val = critic(
                critic_h_after,
                (pytree.tree_map(lambda x: x[None], timestep.observation), last_done[None]),
            )
            last_val = last_val.squeeze(0)
            traj = RNNPPOTransition(
                dones, actions, values, rewards, log_probs, obs_seq,
                HiddenStates(policy_hstates, critic_carries), infos,
            )
            advantages, targets = calculate_gae_with_next_done(
                rewards, values, dones.float(), last_done.float(), last_val,
                sys_cfg.gamma, sys_cfg.gae_lambda,
            )

            # ---- chunked BPTT layout, chunk-initial hidden states only,
            # sequence-major rows for the shuffle.
            batch = (traj._replace(info={}), advantages, targets)
            batch = pytree.tree_map(lambda x: _chunk(x, layout, chunk, num_chunks), batch)
            batch = (
                batch[0]._replace(hstates=pytree.tree_map(lambda h: h[0:1], batch[0].hstates)),
                batch[1],
                batch[2],
            )
            seq_major = pytree.tree_map(lambda x: x.swapaxes(0, 1), batch)

        actor_params = list(actor.parameters())
        critic_params = list(critic.parameters())
        loss_info = []
        with record_function("rec_ippo/epochs"):
            for epoch in range(epochs):
                shuffled = pytree.tree_map(lambda x: x[inputs.permutations[epoch]], seq_major)
                for i in range(minibatches):
                    mb_traj, mb_adv, mb_targets = pytree.tree_map(
                        lambda x: x[i * mb_size : (i + 1) * mb_size].swapaxes(0, 1), shuffled
                    )
                    ent_coef = entropy_coefficient(config, actor_opt)
                    obs_and_done = (mb_traj.obs, mb_traj.done)

                    _, pi = actor(mb_traj.hstates.policy_hidden_state[0], obs_and_done)
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

                    _, value = critic(mb_traj.hstates.critic_hidden_state[0], obs_and_done)
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
        carry = Carry(env_state, timestep, last_done, HiddenStates(policy_h, critic_h_after))
        return carry, infos, loss_info

    def learner_fn(state: RNNLearnerState) -> ExperimentOutput:
        episode_info, train_info = [], []
        for u in range(sys_cfg.num_updates_per_eval):
            drawn = Draws(*(None if x is None else x[u]
                            for x in (noise, env_noise, permutations, entropy_noise)))
            with record_function("rec_ippo/update"):
                carry, info, losses = learner_fn.update(state, drawn)
            state = state._replace(env_state=carry.env_state, timestep=carry.timestep,
                                   dones=carry.dones, hstates=carry.hstates)
            episode_info.append(info)
            train_info.append(losses)
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=stack_trees(episode_info),
            train_metrics=stack_trees(train_info),
        )

    learner_fn.update = CapturedPhase(draw_update, update_body, update_state_tensors,
                                      update_counters, "the rec-IPPO update")
    return learner_fn


def make_networks(
    env: Any, config: Config, device: torch.device, seed: int,
    centralised_critic: bool = False,
):
    """The actor and critic, initialised from `seed` as the reference's flax
    initialisers draw (in distribution), then moved to `device`. Each
    pre-torso is sized from the shape of what it reads: an agent's view, or
    for a centralised critic the global state (a vector, or a grid for
    `CNNTorso`)."""
    net = config.network
    gru_impl = net.get("gru_impl", None)
    in_shape = obs_shape(env)
    critic_shape = env.global_state_shape if centralised_critic else in_shape
    # nn.init draws from the CPU default generator: seed it inside a fork so
    # the caller's generator state is left as it was.
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        actor_pre = make_torso(net.actor_network.pre_torso, in_shape)
        actor_post = make_torso(net.actor_network.post_torso, net.hidden_state_dim)
        actor = RecurrentActor(
            actor_pre,
            actor_post,
            make_action_head(net.action_head, actor_post.out_features, env.action_dim),
            net.hidden_state_dim,
            gru_impl,
        )
        critic_pre = make_torso(net.critic_network.pre_torso, critic_shape)
        critic_post = make_torso(net.critic_network.post_torso, net.hidden_state_dim)
        critic = RecurrentValueNet(
            critic_pre, critic_post, net.hidden_state_dim, gru_impl, centralised_critic
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
    env_noise: Optional[Sequence[Sequence[Any]]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, torch.nn.Module, RNNLearnerState]:
    """Networks, optimizers, env reset and the learner function. On `mesh`
    (by default the process group's) this rank resets its rows of the
    global batch from `generator` and draws its steps from its own stream
    (`rank_generator`); the params are checked equal on every rank."""
    reject_stagger(config, "rec-IPPO/rec-MAPPO")
    num_agents = env.num_agents
    config.system.num_agents = num_agents
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
    num_envs = config.arch.num_envs
    env_state, timestep = sharded_env_reset(env, generator, mesh.data_size * num_envs, mesh)
    hidden = config.network.hidden_state_dim
    hstates = tile_for_shards(HiddenStates(
        ScannedRNN.initialize_carry((num_envs, num_agents), hidden, device),
        ScannedRNN.initialize_carry((num_envs, num_agents), hidden, device),
    ), mesh)
    hstates = restore_params(config, Params(actor, critic), hstates)
    state = RNNLearnerState(
        params=put_replicated(Params(actor, critic), mesh),
        opt_states=OptStates(actor_opt, critic_opt),
        key=rank_generator(generator, mesh),
        env_state=env_state,
        timestep=timestep,
        dones=tile_for_shards(
            torch.zeros((num_envs, num_agents), dtype=torch.bool, device=device), mesh),
        hstates=hstates,
    )
    learner = get_learner_fn(
        env, config, noise=noise, permutations=permutations, entropy_noise=entropy_noise,
        env_noise=env_noise, mesh=mesh,
    )
    return learner, actor, state


def run_experiment(
    _config: Config, centralised_critic: bool = False
) -> Tuple[float, ExperimentOutput]:
    """Train rec-IPPO (rec-MAPPO when `centralised_critic`); returns
    (evaluation performance, last learner output)."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)

    if config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length
    elif config.system.rollout_length % config.system.recurrent_chunk_size != 0:
        raise ValueError("Rollout length must be divisible by recurrent chunk size.")

    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, actor, learner_state = learner_setup(
        env, generator, config, device, centralised_critic
    )
    # A PPO resume trains a fresh budget on top of the saved state.
    learner_state, start = restore_full_state(config, learner_state)

    def eval_hidden(absolute_metric: bool) -> Dict[str, torch.Tensor]:
        return {
            "hidden_state": ScannedRNN.initialize_carry(
                (get_num_eval_envs(config, absolute_metric), config.system.num_agents),
                config.network.hidden_state_dim,
                device,
            )
        }

    return train_and_evaluate(
        config, device, learn, actor, learner_state, eval_env,
        make_rec_eval_act_fn(config), eval_hidden, start_step=start or 0,
    )


def main() -> float:
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("Recurrent IPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
