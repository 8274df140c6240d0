"""Environment factory and registry (port of `mava_tpu/envs/__init__.py`).

Same wrapper order as the reference: AgentID? -> AutoReset ->
RecordEpisodeMetrics on the train env; RecordEpisodeMetrics on the eval env.
Only RobotWarehouse is ported so far; the other environments are listed in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from mava_tpu_torch.envs.wrappers import (
    AgentIDWrapper,
    AutoResetWrapper,
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


def _add_extra_wrappers(train_env, eval_env, config):
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


def make(config, device: torch.device | str) -> Tuple[Any, Any]:
    """Create (train_env, eval_env) on `device` from config."""
    env_name = config.env.env_name
    if env_name not in _REGISTRY:
        raise ValueError(
            f"Environment '{env_name}' is not yet ported to mava_tpu_torch "
            f"(ported: {sorted(_REGISTRY)}); see ROADMAP.md, Queue 1."
        )
    train_env, eval_env = _REGISTRY[env_name](config, torch.device(device))
    return _add_extra_wrappers(train_env, eval_env, config)
