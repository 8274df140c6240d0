"""Environment factory and registry (port of `mava_tpu/envs/__init__.py`).

Same wrapper order as the reference: GlobalState? -> AgentID? -> AutoReset ->
RecordEpisodeMetrics on the train env; the same without AutoReset on the eval
env. The global state is therefore built from views without the one-hot ids.
Every environment of the reference is ported: RobotWarehouse, Matrax, SMAX,
MaSwarm, MaReacher, LevelBasedForaging, Cleaner, MaConnector, Gigastep and the
articulated suite (MaSwimmer, MaHopper, MaCheetah, MaWalker, MaAnt,
MaHumanoid). Only SMAX, Cleaner and MaConnector have a global state of their
own; for the others the wrapper tiles their agents' views. Cleaner and
MaConnector give grid views (`obs_shape`: rows, cols, channels) and a grid
global state.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=32)
def _articulated(module: str, name: str, device: torch.device, kwargs: Tuple) -> Any:
    """One instance of an articulated env per (kwargs, device) in a process:
    the envs are stateless, and each instance traces its dynamics once per
    batch shape (seconds, up to a minute for MaHumanoid on a slow host), so
    the train and eval envs and later experiments share the traced graphs."""
    import importlib

    cls = getattr(importlib.import_module(f"mava_tpu_torch.envs.{module}"), name)
    return cls(**dict(kwargs), device=device)


def _make_articulated(module: str, name: str, config, device: torch.device) -> Tuple[Any, Any]:
    env = _articulated(module, name, device, tuple(sorted(_env_kwargs(config).items())))
    return env, env


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


@register("LevelBasedForaging")
def _make_lbf(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.lbf import LevelBasedForaging

    kwargs = _env_kwargs(config)
    kwargs["use_individual_rewards"] = config.env.get("use_individual_rewards", False)
    return (
        LevelBasedForaging(**kwargs, device=device),
        LevelBasedForaging(**kwargs, device=device),
    )


@register("Cleaner")
def _make_cleaner(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.cleaner import Cleaner

    kwargs = _env_kwargs(config)
    return Cleaner(**kwargs, device=device), Cleaner(**kwargs, device=device)


@register("MaConnector")
def _make_connector(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.connector import MaConnector

    kwargs = _env_kwargs(config)
    return MaConnector(**kwargs, device=device), MaConnector(**kwargs, device=device)


@register("Gigastep")
def _make_gigastep(config, device: torch.device) -> Tuple[Any, Any]:
    from mava_tpu_torch.envs.gigastep import Gigastep

    kwargs = _env_kwargs(config)
    return Gigastep(**kwargs, device=device), Gigastep(**kwargs, device=device)


@register("MaSwimmer")
def _make_maswimmer(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("maswimmer", "MaSwimmer", config, device)


@register("MaHopper")
def _make_mahopper(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("mahopper", "MaHopper", config, device)


@register("MaCheetah")
def _make_macheetah(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("macheetah", "MaCheetah", config, device)


@register("MaAnt")
def _make_maant(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("maant", "MaAnt", config, device)


@register("MaHumanoid")
def _make_mahumanoid(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("mahumanoid", "MaHumanoid", config, device)


@register("MaWalker")
def _make_mawalker(config, device: torch.device) -> Tuple[Any, Any]:
    return _make_articulated("mawalker", "MaWalker", config, device)


def make(
    config, device: torch.device | str, add_global_state: bool = False
) -> Tuple[Any, Any]:
    """Create (train_env, eval_env) on `device` from config."""
    env_name = config.env.env_name
    if env_name not in _REGISTRY:
        raise ValueError(
            f"Unknown environment '{env_name}'. Available: {sorted(_REGISTRY)}"
        )
    train_env, eval_env = _REGISTRY[env_name](config, torch.device(device))
    return _add_extra_wrappers(train_env, eval_env, config, add_global_state)
