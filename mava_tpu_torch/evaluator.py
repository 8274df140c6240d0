"""Evaluator: fixed-length episode rollouts, metrics read at the first done step.

Port of `mava_tpu/evaluator.py`. Under a process group each rank runs
`get_num_eval_envs` envs (its share of the episodes) with its own generator,
and the logger gathers the metrics. Each episode loop resets every
eval env, runs `time_limit` steps, and reads each env's metrics at its first
done step. As in the reference (:95), an env whose episode never ends within
`time_limit` reports the metrics of step 0. With `env.log_win_rate` the metrics
also hold `won_episode` from the env's extras (reference :62, :91-92), which the
logger turns into `win_rate`.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Callable, Dict, Tuple

import torch

from mava_tpu_torch.types import TimeStep

ActorState = Dict[str, Any]
EvalActFn = Callable[[Any, TimeStep, torch.Generator, ActorState], Tuple[torch.Tensor, ActorState]]


def get_num_eval_envs(config, absolute_metric: bool) -> int:
    """Env batch per device during eval (reference :35-46)."""
    n_devices = config.arch.n_devices
    n_parallel_envs = config.arch.num_envs * n_devices
    eval_episodes = (
        config.arch.num_absolute_metric_eval_episodes
        if absolute_metric
        else config.arch.num_eval_episodes
    )
    if eval_episodes <= n_parallel_envs:
        return math.ceil(eval_episodes / n_devices)
    return config.arch.num_envs


def get_eval_fn(env: Any, act_fn: EvalActFn, config, absolute_metric: bool) -> Callable:
    """eval_fn(params, generator, init_act_state) -> metrics (one entry per episode)."""
    eval_episodes = (
        config.arch.num_absolute_metric_eval_episodes
        if absolute_metric
        else config.arch.num_eval_episodes
    )
    n_envs = get_num_eval_envs(config, absolute_metric)
    episode_loops = math.ceil(eval_episodes / n_envs)
    log_win_rate = config.env.get("log_win_rate", False)
    if eval_episodes % n_envs != 0:
        warnings.warn(
            f"num eval episodes ({eval_episodes}) not divisible by parallel envs "
            f"({n_envs}); running {episode_loops * n_envs} episodes.",
            stacklevel=2,
        )

    @torch.no_grad()
    def _episode(params: Any, generator: torch.Generator, init_act_state: ActorState):
        env_state, ts = env.reset(env.reset_noise(n_envs, generator))
        actor_state = init_act_state
        metrics, lasts = [], []
        for _ in range(env.time_limit):
            action, actor_state = act_fn(params, ts, generator, actor_state)
            env_state, ts = env.step(env_state, action, env.step_noise(n_envs, generator))
            step_metrics = dict(ts.extras["episode_metrics"])
            if log_win_rate:
                step_metrics["won_episode"] = ts.extras["won_episode"]
            metrics.append(step_metrics)
            lasts.append(ts.last())
        # First done step per env; step 0 where none ended (reference :95).
        done_idx = torch.argmax(torch.stack(lasts).to(torch.int32), dim=0)
        envs = torch.arange(n_envs, device=done_idx.device)
        return {
            k: torch.stack([m[k] for m in metrics])[done_idx, envs]
            for k in metrics[0]
            if k != "is_terminal_step"
        }

    def eval_fn(params: Any, generator: torch.Generator, init_act_state: ActorState):
        start = time.perf_counter()
        loops = [_episode(params, generator, init_act_state) for _ in range(episode_loops)]
        metrics = {k: torch.cat([m[k] for m in loops]).cpu().numpy() for k in loops[0]}
        elapsed = time.perf_counter() - start
        metrics["steps_per_second"] = metrics["episode_length"].sum() / elapsed
        return metrics

    return eval_fn


def make_ff_eval_act_fn(config) -> EvalActFn:
    """Feed-forward act fn: the greedy mode, or a sample from the evaluator's
    generator (reference :129-137). `params` is the actor module; `actor_state`
    passes through."""

    def eval_act_fn(params, timestep, generator, actor_state):
        pi = params(timestep.observation)
        action = pi.mode() if config.arch.evaluation_greedy else pi.sample(generator)
        return action, actor_state

    return eval_act_fn


def make_rec_eval_act_fn(config) -> EvalActFn:
    """Recurrent act fn: threads `hidden_state` through actor_state and feeds
    the actor one time step (reference :140-157). `params` is the actor module."""

    def eval_act_fn(params, timestep, generator, actor_state):
        hidden_state = actor_state["hidden_state"]
        n_agents = timestep.observation.agents_view.shape[1]
        last_done = timestep.last()[:, None].expand(-1, n_agents)
        obs = type(timestep.observation)(*(x[None] for x in timestep.observation))
        hidden_state, pi = params(hidden_state, (obs, last_done[None]))
        action = pi.mode() if config.arch.evaluation_greedy else pi.sample(generator)
        return action.squeeze(0), {"hidden_state": hidden_state}

    return eval_act_fn
