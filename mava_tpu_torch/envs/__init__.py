"""Environment factory and registry (port of `mava_tpu/envs/__init__.py`).

Same wrapper order as the reference: GlobalState? -> AgentID? -> AutoReset ->
RecordEpisodeMetrics on the train env; the same without AutoReset on the eval
env. The global state is therefore built from views without the one-hot ids.
RobotWarehouse, Matrax, SMAX, MaSwarm and MaReacher are ported so far; the
other environments are listed in ROADMAP.md. MaSwarm and MaReacher have no
global state of their own: the wrapper tiles their agents' views.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from mava_tpu_torch.envs.wrappers import (
    AgentIDWrapper,
    AutoResetWrapper,
    GlobalStateWrapper,
    RecordEpisodeMetrics,
)

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def _env_kwargs(config) -> Dict[str, Any]:
    """Merge scenario task_config + scenario env_kwargs + env-level kwargs."""
    kwargs = dict(config.env.scenario.get("task_config", {}))
    kwargs.update(config.env.scenario.get("env_kwargs", {}) or {})
    kwargs.update(config.env.get("kwargs", {}) or {})
    return kwargs


def register(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def _add_extra_wrappers(train_env, eval_env, config, add_global_state: bool):
    if add_global_state:
        train_env = GlobalStateWrapper(train_env)
        eval_env = GlobalStateWrapper(eval_env)
    if config.system.get("add_agent_id", False) and not config.env.get(
        "implicit_agent_id", False
    ):
        train_env = AgentIDWrapper(train_env)
        eval_env = AgentIDWrapper(eval_env)
    train_env = AutoResetWrapper(train_env)
    train_env = RecordEpisodeMetrics(train_env)
    eval_env = RecordEpisodeMetrics(eval_env)
    return train_env, eval_env


@register("RobotWarehouse")
def _make_rware(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.rware import RobotWarehouse

    kwargs = _env_kwargs(config)
    return (
        RobotWarehouse(**kwargs, device=device),
        RobotWarehouse(**kwargs, device=device),
    )


@register("Smax")
def _make_smax(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.smax import Smax

    # As the reference (`mava_tpu/envs/__init__.py:72-78`): the scenario from
    # `env.scenario.task_name`, the keyword arguments from `env.kwargs` alone.
    scenario = config.env.scenario.get("task_name", "3s5z")
    kwargs = dict(config.env.get("kwargs", {}) or {})
    return (
        Smax(scenario=scenario, **kwargs, device=device),
        Smax(scenario=scenario, **kwargs, device=device),
    )


@register("Matrax")
def _make_matrax(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.matrax import Matrax

    kwargs = _env_kwargs(config)
    # `env.scenario.task_name` selects the game. A scenario may pin its own
    # task_config.task_name (the Custom-payoff pattern); a task_name that
    # contradicts the pin fails: the engine would train the pinned game while
    # the logger labels the run with the other name.
    scenario_task = config.env.scenario.task_name
    if "task_name" in kwargs and kwargs["task_name"] != scenario_task:
        raise ValueError(
            f"Scenario pins task_config.task_name={kwargs['task_name']!r} but "
            f"env.scenario.task_name={scenario_task!r}. Pick a scenario without "
            "a task_config pin (e.g. env/scenario=matrax-climbing) to select "
            "tasks via env.scenario.task_name."
        )
    kwargs.setdefault("task_name", scenario_task)
    return Matrax(**kwargs, device=device), Matrax(**kwargs, device=device)


@register("MaSwarm")
def _make_maswarm(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.maswarm import MaSwarm

    kwargs = _env_kwargs(config)
    return MaSwarm(**kwargs, device=device), MaSwarm(**kwargs, device=device)


@register("MaReacher")
def _make_mareacher(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.mareacher import MaReacher

    kwargs = _env_kwargs(config)
    return MaReacher(**kwargs, device=device), MaReacher(**kwargs, device=device)


def make(
    config, device: torch.device | str, add_global_state: bool = False
) -> Tuple[Any, Any]:
    """Create (train_env, eval_env) on `device` from config."""
    env_name = config.env.env_name
    if env_name not in _REGISTRY:
        raise ValueError(
            f"Environment '{env_name}' is not yet ported to mava_tpu_torch "
            f"(ported: {sorted(_REGISTRY)}); see ROADMAP.md, Queue 1."
        )
    train_env, eval_env = _REGISTRY[env_name](config, torch.device(device))
    return _add_extra_wrappers(train_env, eval_env, config, add_global_state)
