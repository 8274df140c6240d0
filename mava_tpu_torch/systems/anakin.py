"""What every system's `run_experiment` shares: the device, the schedule of
updates and evaluations, the checkpoint restores, and the learn-evaluate-log
loop with its checkpoint saves (reference `systems/ppo/ff_ippo.py:402-525`, which each
reference system repeats; rec-IQL's `:458-601` is the same loop with its
update count `scan_steps` equal to `num_updates_per_eval`; SAC's
`ff_isac.py:631-685` runs it from the env-step count after its explore phase).

Under a process group (`parallel/`) every rank runs this loop: the env-step
counts are global (`n_devices` ranks of `num_envs` envs), each rank evaluates
its share of the episodes with its own stream, and logging and checkpointing
are collectives that every rank calls, whose files rank 0 writes.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import EvalActFn, get_eval_fn
from mava_tpu_torch.parallel import initialize, make_mesh, num_learner_devices
from mava_tpu_torch.parallel.distributed import gather_metrics, rank_device, rank_generator
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.checkpointing import Checkpointer
from mava_tpu_torch.utils.config import Config
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.profiling import PhaseTimer, maybe_trace
from mava_tpu_torch.utils.timestep_checker import check_total_timesteps


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack a list of identically-structured pytrees along a new axis 0."""
    leaves, spec = zip(*(pytree.tree_flatten(t) for t in trees))
    return pytree.tree_unflatten([torch.stack(xs) for xs in zip(*leaves)], spec[0])


def start_experiment(config: Config) -> torch.device:
    """The device of the run: `arch.device`, "cuda" unless the caller asked
    for another. Launched by torchrun, the process group comes up here on the
    device's backend (NCCL on the cards, gloo on the CPU) and this rank's card
    is `cuda:LOCAL_RANK`; `arch.n_devices` is the number of ranks."""
    device = torch.device(config.arch.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "arch.device is cuda but CUDA is not available; "
            "pass +arch.device=cpu to run the port on the CPU."
        )
    initialize(device.type)
    device = rank_device(device)
    # Full fp32 everywhere on the card, as on the reference's path: cuBLAS
    # matmuls and cuDNN's convolutions (`CNNTorso`), which PyTorch would
    # otherwise run as TF32. `CNNTorso`'s bf16 mode is the one opt-in fast path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.arch.n_devices = num_learner_devices(make_mesh())
    return device


def schedule_updates(config: Config) -> Config:
    """`num_updates` from `total_timesteps` (before the learner is built: the
    lr-decay horizon is fixed at setup), then the updates per evaluation."""
    config = check_total_timesteps(config)
    if config.system.num_updates < config.arch.num_evaluation:
        raise ValueError("num_updates must be at least arch.num_evaluation.")
    config.system.num_updates_per_eval = (
        config.system.num_updates // config.arch.num_evaluation
    )
    return config


def steps_per_round(config: Config) -> int:
    """The global env-steps of `num_updates_per_eval` updates: `rollout_length`
    steps of `num_envs` envs on each of the `n_devices` ranks."""
    return (config.system.num_updates_per_eval * config.system.rollout_length
            * config.arch.num_envs * config.arch.n_devices)


def eval_generator(config: Config, device: torch.device) -> torch.Generator:
    """The evaluator's stream: seeded with `system.seed + 1`, and one of its
    own on each rank of a process group, so that the ranks evaluate different
    episodes."""
    generator = torch.Generator(device=device).manual_seed(config.system.seed + 1)
    return rank_generator(generator, make_mesh())


def restore_full_state(config: Config, learner_state: Any) -> Tuple[Any, Optional[int]]:
    """With `logger.checkpointing.load_full_state`, the learner state saved
    under `load_args` (its latest step) put back into `learner_state`, and
    that step; else (learner_state, None)."""
    ckpt = config.logger.checkpointing
    if not ckpt.get("load_full_state", False):
        return learner_state, None
    loader = Checkpointer(model_name=config.logger.system_name, **ckpt.load_args)
    step = loader.latest_step()
    return loader.restore_full_state(learner_state, step), step


def restore_params(config: Config, params: Any, hstates: Any = None) -> Any:
    """With `logger.checkpointing.load_model`, the saved parameters (and
    hidden states, when `hstates` is given) loaded into `params` (and
    `hstates`); returns the hidden states to start from (reference
    `rec_ippo.py:486-496`, `ff_ippo.py:381-387`)."""
    ckpt = config.logger.checkpointing
    if not ckpt.load_model:
        return hstates
    loader = Checkpointer(model_name=config.logger.system_name, **ckpt.load_args)
    _, restored = loader.restore_params(
        input_params=params, restore_hstates=hstates is not None, input_hstates=hstates
    )
    return restored if restored is not None else hstates


def train_and_evaluate(
    config: Config,
    device: torch.device,
    learn: Callable[[Any], ExperimentOutput],
    actor: torch.nn.Module,
    learner_state: Any,
    eval_env: Any,
    eval_act_fn: EvalActFn,
    init_actor_state: Callable[[bool], Dict[str, Any]],
    misc_metrics: Optional[Callable[[int], Dict[str, float]]] = None,
    rounds: Optional[range] = None,
    logger: Optional[MavaLogger] = None,
    start_step: int = 0,
) -> Tuple[float, ExperimentOutput]:
    """Rounds of learn, log, evaluate, then the absolute metric on the best
    actor; returns (evaluation performance, last learner output).
    `init_actor_state(absolute_metric)` gives the evaluator's initial actor
    state ({} for a feed-forward actor, the hidden state for a recurrent one);
    `misc_metrics(t)` adds a system's own entries to the MISC log line
    (rec-IQL's epsilon). `rounds` holds the env-step count at which each round
    starts, a round being `rounds.step` env-steps; by default
    `arch.num_evaluation` rounds of `num_updates_per_eval` updates from
    `start_step` (the step of a resumed checkpoint, else 0; SAC starts after
    its explore phase). `logger` is the run's logger, if the caller has already
    logged with it. With `logger.checkpointing.save_model` each round ends
    with a checkpoint of the learner state."""
    evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=False)
    generator = eval_generator(config, device)
    if rounds is None:
        steps_per_rollout = steps_per_round(config)
        rounds = range(start_step, start_step + steps_per_rollout * config.arch.num_evaluation,
                       steps_per_rollout)
    steps_per_rollout = rounds.step
    logger = logger or MavaLogger(config)
    ckpt = config.logger.checkpointing
    checkpointer = (
        Checkpointer(metadata=config.to_dict(), model_name=config.logger.system_name,
                     **ckpt.save_args)
        if ckpt.save_model else None
    )

    max_episode_return = -np.inf
    best_actor = None
    for eval_step, start in enumerate(rounds):
        timer = PhaseTimer(device)
        with maybe_trace(config, eval_step), timer.phase("learn"):
            learner_output = learn(learner_state)
        elapsed = timer.phases["learn"]
        t = int(start + steps_per_rollout)
        episode_metrics, ep_completed = get_final_step_metrics(
            gather_metrics(learner_output.episode_metrics)
        )
        episode_metrics["steps_per_second"] = steps_per_rollout / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        with timer.phase("eval"):
            eval_metrics = evaluator(actor, generator, init_actor_state(False))
        eval_metrics = logger.log(eval_metrics, t, eval_step, LogEvent.EVAL)
        misc = misc_metrics(t) if misc_metrics else {}
        logger.log({"timestep": t, **misc, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        episode_return = float(np.mean(eval_metrics["episode_return"]))
        if checkpointer is not None:
            checkpointer.save(
                timestep=t,
                unreplicated_learner_state=learner_output.learner_state,
                episode_return=episode_return,
                full_state=ckpt.get("save_full_state", False),
            )
        if config.arch.absolute_metric and max_episode_return <= episode_return:
            best_actor = copy.deepcopy(actor)
            max_episode_return = episode_return
        learner_state = learner_output.learner_state

    eval_performance = float(np.mean(eval_metrics[config.env.eval_metric]))

    if config.arch.absolute_metric:
        abs_evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=True)
        eval_metrics = abs_evaluator(best_actor, generator, init_actor_state(True))
        logger.log(eval_metrics, t, eval_step, LogEvent.ABSOLUTE)

    logger.stop()
    return eval_performance, learner_output
