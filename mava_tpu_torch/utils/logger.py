"""Metric logging facade (port of `mava_tpu/utils/logger.py`).

Console and marl-eval JSON backends, with the reference's file layout:
`<base_exp_path>/json/<system_name>/<timestamp>/metrics.json` holding
{env_name: {task_name: {algorithm: {run_<seed>: {step_<i>: {...},
absolute_metrics: {...}}}}}}. The TensorBoard and Neptune backends are not yet
ported and raise when enabled.
"""

from __future__ import annotations

import abc
import json
import logging
import os
from datetime import datetime
from enum import Enum
from typing import Any, Dict, List, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

# ANSI colours of the reference's console output (colorama's Fore.* values).
_MAGENTA, _GREEN, _BLUE, _CYAN, _YELLOW = (f"\033[{c}m" for c in (35, 32, 34, 36, 33))
_BRIGHT, _RESET = "\033[1m", "\033[0m"


class LogEvent(Enum):
    ACT = "actor"
    TRAIN = "trainer"
    EVAL = "evaluator"
    ABSOLUTE = "absolute"
    MISC = "misc"


def describe(x: Any) -> Union[Dict[str, Any], Any]:
    """mean/std/min/max summary of a metric array."""
    if not isinstance(x, np.ndarray) or np.size(x) <= 1:
        return x
    return {"mean": np.mean(x), "std": np.std(x), "min": np.min(x), "max": np.max(x)}


def _to_host(x: Any) -> Any:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _flatten(d: Dict, parent: str = "", sep: str = "/") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{parent}{sep}{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key, sep))
        else:
            out[key] = v
    return out


class BaseLogger(abc.ABC):
    @abc.abstractmethod
    def log_stat(self, key: str, value: float, step: int, eval_step: int,
                 event: LogEvent) -> None: ...

    def log_dict(self, data: Dict, step: int, eval_step: int, event: LogEvent) -> None:
        for key, value in _flatten(data).items():
            self.log_stat(key, value, step, eval_step, event)

    def stop(self) -> None:
        return None


class MultiLogger(BaseLogger):
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = loggers

    def log_stat(self, key, value, step, eval_step, event) -> None:
        for logger in self.loggers:
            logger.log_stat(key, value, step, eval_step, event)

    def log_dict(self, data, step, eval_step, event) -> None:
        for logger in self.loggers:
            logger.log_dict(data, step, eval_step, event)

    def stop(self) -> None:
        for logger in self.loggers:
            logger.stop()


class ConsoleLogger(BaseLogger):
    _EVENT_COLOURS = {
        LogEvent.TRAIN: _MAGENTA,
        LogEvent.EVAL: _GREEN,
        LogEvent.ABSOLUTE: _BLUE,
        LogEvent.ACT: _CYAN,
        LogEvent.MISC: _YELLOW,
    }

    def __init__(self, cfg, unique_token: str):
        self.logger = logging.getLogger("mava_tpu_torch")
        self.logger.handlers = []
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        self.logger.addHandler(handler)
        self.logger.setLevel("INFO")
        self.logger.propagate = False

    def log_stat(self, key, value, step, eval_step, event) -> None:
        colour = self._EVENT_COLOURS[event]
        key = key.replace("_", " ").capitalize()
        self.logger.info(
            f"{colour}{_BRIGHT}{event.value.upper()} - {key}: {value:.3f}"
            f"{_RESET}"
        )

    def log_dict(self, data, step, eval_step, event) -> None:
        flat = _flatten(data, sep=" ")
        colour = self._EVENT_COLOURS[event]
        parts = []
        for k, v in flat.items():
            v = v.item() if isinstance(v, (np.ndarray, np.generic)) else v
            text = f"{v:.3f}" if isinstance(v, float) else str(v)
            parts.append(f"{k.replace('_', ' ').capitalize()}: {text}")
        self.logger.info(
            f"{colour}{_BRIGHT}{event.value.upper()} - "
            f"{' | '.join(parts)}{_RESET}"
        )


class JsonLogger(BaseLogger):
    """marl-eval-format JSON (reference `logger.py:215-313`)."""

    _METRICS_TO_LOG = ["episode_return/mean", "win_rate", "steps_per_second"]

    def __init__(self, cfg, unique_token: str):
        json_path = cfg.logger.kwargs.get("json_path")
        if json_path:
            base = os.path.join(cfg.logger.base_exp_path, "json", json_path)
        else:
            base = os.path.join(
                cfg.logger.base_exp_path, "json", cfg.logger.system_name, unique_token
            )
        os.makedirs(base, exist_ok=True)
        self.file_path = os.path.join(base, "metrics.json")
        self.env_name = cfg.env.env_name
        self.task_name = cfg.env.scenario.get("task_name", "default")
        self.algorithm = cfg.logger.system_name
        self.run_key = f"run_{cfg.system.seed}"
        self._data: Dict = {}
        self._dirty = False
        if os.path.exists(self.file_path):
            with open(self.file_path) as f:
                self._data = json.load(f)

    def _entry(self, step_key: str) -> Dict:
        return (
            self._data.setdefault(self.env_name, {})
            .setdefault(self.task_name, {})
            .setdefault(self.algorithm, {})
            .setdefault(self.run_key, {})
            .setdefault(step_key, {})
        )

    def log_stat(self, key, value, step, eval_step, event) -> None:
        if key not in self._METRICS_TO_LOG or event not in (LogEvent.EVAL, LogEvent.ABSOLUTE):
            return
        if "/" in key:
            key = "_".join(reversed(key.split("/")))
        value = value.item() if isinstance(value, (np.ndarray, np.generic)) else value
        step_key = "absolute_metrics" if event == LogEvent.ABSOLUTE else f"step_{eval_step}"
        entry = self._entry(step_key)
        entry["step_count"] = int(step)
        entry.setdefault(key, []).append(value)
        self._dirty = True

    def log_dict(self, data, step, eval_step, event) -> None:
        super().log_dict(data, step, eval_step, event)
        if self._dirty:
            self._write()

    def _write(self) -> None:
        tmp_path = f"{self.file_path}.tmp"
        with open(tmp_path, "w") as f:
            json.dump(self._data, f, indent=2)
        os.replace(tmp_path, self.file_path)
        self._dirty = False

    def stop(self) -> None:
        if self._dirty:
            self._write()


class MavaLogger:
    """Facade: win rate + describe() aggregation + backend fan-out."""

    def __init__(self, config):
        self.cfg = config
        for key in ("use_tb", "use_neptune"):
            if config.logger.get(key):
                raise NotImplementedError(
                    f"logger.{key}=True is not yet ported to mava_tpu_torch."
                )
        loggers: List[BaseLogger] = []
        unique_token = datetime.now().strftime("%Y%m%d%H%M%S")
        if config.logger.get("use_json"):
            loggers.append(JsonLogger(config, unique_token))
        if config.logger.get("use_console", True):
            loggers.append(ConsoleLogger(config, unique_token))
        self.logger: BaseLogger = MultiLogger(loggers)

    def log(self, metrics: Dict, t: int, t_eval: int, event: LogEvent) -> None:
        metrics = pytree.tree_map(_to_host, metrics)
        if "won_episode" in metrics:
            metrics = self.calc_winrate(metrics, event)
        if event == LogEvent.TRAIN:
            metrics = pytree.tree_map(np.mean, metrics)
        else:
            metrics = pytree.tree_map(describe, metrics)
        self.logger.log_dict(metrics, t, t_eval, event)

    def calc_winrate(self, episode_metrics: Dict, event: LogEvent) -> Dict:
        won = episode_metrics.pop("won_episode")
        n_episodes = max(int(np.size(won)), 1)
        episode_metrics["win_rate"] = (np.sum(won) / n_episodes) * 100
        return episode_metrics

    def stop(self) -> None:
        self.logger.stop()
