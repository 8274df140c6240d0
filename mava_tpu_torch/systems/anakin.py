"""What every system's `run_experiment` shares: the device, the keys the port
does not take yet, the schedule of updates and evaluations, and the
learn-evaluate-log loop (reference `systems/ppo/ff_ippo.py:402-525`, which each
reference system repeats; rec-IQL's `:458-601` is the same loop with its
update count `scan_steps` equal to `num_updates_per_eval`; SAC's
`ff_isac.py:631-685` runs it from the env-step count after its explore phase).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import EvalActFn, get_eval_fn
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.profiling import PhaseTimer
from mava_tpu_torch.utils.timestep_checker import check_total_timesteps


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack a list of identically-structured pytrees along a new axis 0."""
    leaves, spec = zip(*(pytree.tree_flatten(t) for t in trees))
    return pytree.tree_unflatten([torch.stack(xs) for xs in zip(*leaves)], spec[0])


def start_experiment(config: Config) -> torch.device:
    """Rejects the keys the port does not take yet and returns the device of
    the run: `arch.device`, "cuda" unless the caller asked for another."""
    ckpt = config.logger.checkpointing
    for key in ("save_model", "load_model", "save_full_state", "load_full_state"):
        if ckpt.get(key, False):
            raise NotImplementedError(
                f"logger.checkpointing.{key}=True is not yet ported to mava_tpu_torch."
            )
    device = torch.device(config.arch.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "arch.device is cuda but CUDA is not available; "
            "pass +arch.device=cpu to run the port on the CPU."
        )
    # Full fp32 everywhere on the card, as on the reference's path: cuBLAS
    # matmuls and cuDNN's convolutions (`CNNTorso`), which PyTorch would
    # otherwise run as TF32. `CNNTorso`'s bf16 mode is the one opt-in fast path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.arch.n_devices = 1
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
) -> Tuple[float, ExperimentOutput]:
    """Rounds of learn, log, evaluate, then the absolute metric on the best
    actor; returns (evaluation performance, last learner output).
    `init_actor_state(absolute_metric)` gives the evaluator's initial actor
    state ({} for a feed-forward actor, the hidden state for a recurrent one);
    `misc_metrics(t)` adds a system's own entries to the MISC log line
    (rec-IQL's epsilon). `rounds` holds the env-step count at which each round
    starts, a round being `rounds.step` env-steps; by default
    `arch.num_evaluation` rounds of `num_updates_per_eval` updates from 0 (SAC
    starts after its explore phase). `logger` is the run's logger, if the
    caller has already logged with it."""
    evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=False)
    eval_generator = torch.Generator(device=device).manual_seed(config.system.seed + 1)
    if rounds is None:
        steps_per_rollout = (
            config.system.num_updates_per_eval * config.system.rollout_length * config.arch.num_envs
        )
        rounds = range(0, steps_per_rollout * config.arch.num_evaluation, steps_per_rollout)
    steps_per_rollout = rounds.step
    logger = logger or MavaLogger(config)

    max_episode_return = -np.inf
    best_actor = None
    for eval_step, start in enumerate(rounds):
        timer = PhaseTimer(device)
        with timer.phase("learn"):
            learner_output = learn(learner_state)
        elapsed = timer.phases["learn"]
        t = int(start + steps_per_rollout)
        episode_metrics, ep_completed = get_final_step_metrics(
            learner_output.episode_metrics
        )
        episode_metrics["steps_per_second"] = steps_per_rollout / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(learner_output.train_metrics, t, eval_step, LogEvent.TRAIN)

        with timer.phase("eval"):
            eval_metrics = evaluator(actor, eval_generator, init_actor_state(False))
        logger.log(eval_metrics, t, eval_step, LogEvent.EVAL)
        misc = misc_metrics(t) if misc_metrics else {}
        logger.log({"timestep": t, **misc, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        episode_return = float(np.mean(eval_metrics["episode_return"]))
        if config.arch.absolute_metric and max_episode_return <= episode_return:
            best_actor = copy.deepcopy(actor)
            max_episode_return = episode_return
        learner_state = learner_output.learner_state

    eval_performance = float(np.mean(eval_metrics[config.env.eval_metric]))

    if config.arch.absolute_metric:
        abs_evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=True)
        eval_metrics = abs_evaluator(best_actor, eval_generator, init_actor_state(True))
        logger.log(eval_metrics, t, eval_step, LogEvent.ABSOLUTE)

    logger.stop()
    return eval_performance, learner_output
