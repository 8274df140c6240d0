"""Metric logging facade (port of `mava_tpu/utils/logger.py`).

Console, TensorBoard, marl-eval JSON and neptune.ai backends, as the
reference's. The JSON file is
`<base_exp_path>/json/<system_name>/<timestamp>/metrics.json` holding
{env_name: {task_name: {algorithm: {run_<seed>: {step_<i>: {...},
absolute_metrics: {...}}}}}}; the tfevents files go to
`<base_exp_path>/tensorboard/<system_name>/<timestamp>/` (`utils/tbwriter.py`,
no TensorBoard package needed). The neptune package is imported only when
`logger.use_neptune` is set, and its absence is then a clear error. Under a
process group only rank 0 has backends, and `MavaLogger.log` gathers every
rank's metrics first.
"""

from __future__ import annotations

import abc
import json
import logging
import os
import shutil
import tempfile
from datetime import datetime
from enum import Enum
from typing import Any, Dict, List, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.parallel.distributed import gather_metrics, is_main_process

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


def _sorted_keys(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


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


class TensorboardLogger(BaseLogger):
    """Scalars to a tfevents file (reference `logger.py:128-144`); an
    evaluation is logged at its evaluation index, every other event at its
    env-step."""

    def __init__(self, cfg, unique_token: str):
        from mava_tpu_torch.utils.tbwriter import TensorboardWriter

        path = os.path.join(
            cfg.logger.base_exp_path, "tensorboard", cfg.logger.system_name, unique_token
        )
        self.writer = TensorboardWriter(path)

    def log_stat(self, key, value, step, eval_step, event) -> None:
        t = step if event != LogEvent.EVAL else eval_step
        value = value.item() if isinstance(value, (np.ndarray, np.generic)) else value
        if isinstance(value, (int, float)):
            self.writer.scalar(f"{event.value}/{key}", value, t)

    def stop(self) -> None:
        self.writer.close()


class NeptuneLogger(BaseLogger):
    """neptune.ai backend (reference `logger.py:147-210`): tags and the config
    at start, only the main metrics unless `detailed_neptune_logging`, and with
    `upload_json_data` this run's marl-eval JSON zipped and uploaded on stop.
    The neptune package is imported here, so that the port runs without it."""

    # Metrics logged even when detailed logging is off.
    _MAIN_METRICS = ("episode_return", "win_rate", "steps_per_second")

    def __init__(self, cfg, unique_token: str):
        try:
            import neptune  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "logger.use_neptune=True but the neptune package is not installed."
            ) from e
        kwargs = cfg.logger.kwargs
        # The reference key is `neptune_tag`; the plural alias is honoured too.
        tags = kwargs.get("neptune_tag") or kwargs.get("neptune_tags") or []
        self.run = neptune.init_run(project=kwargs.get("neptune_project"), tags=list(tags))
        self.run["config"] = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        self.detailed = bool(
            kwargs.get("detailed_neptune_logging", False) or kwargs.get("detailed_logging", False)
        )
        self.upload_json_data = bool(kwargs.get("upload_json_data", False))
        # This run's marl-eval JSON directory only (JsonLogger's layout).
        self._json_base = os.path.join(
            cfg.logger.base_exp_path, "json", cfg.logger.system_name, unique_token
        )
        self.unique_token = unique_token

    def log_stat(self, key, value, step, eval_step, event) -> None:
        value = value.item() if isinstance(value, (np.ndarray, np.generic)) else value
        if not (self.detailed or any(key.startswith(m) for m in self._MAIN_METRICS)):
            return
        handler = self.run[f"{event.value}/{key}"]
        if hasattr(handler, "append"):  # neptune >= 1.0
            handler.append(value, step=step)
        else:  # older clients
            handler.log(value, step=step)

    def stop(self) -> None:
        if self.upload_json_data and os.path.isdir(self._json_base):
            zip_path = shutil.make_archive(
                os.path.join(tempfile.gettempdir(), f"metrics_{self.unique_token}"),
                "zip",
                self._json_base,
            )
            self.run["metrics_json"].upload(zip_path)
        self.run.stop()


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
        loggers: List[BaseLogger] = []
        unique_token = datetime.now().strftime("%Y%m%d%H%M%S")
        if is_main_process():
            if config.logger.get("use_neptune"):
                loggers.append(NeptuneLogger(config, unique_token))
            if config.logger.get("use_tb"):
                loggers.append(TensorboardLogger(config, unique_token))
            if config.logger.get("use_json"):
                loggers.append(JsonLogger(config, unique_token))
            if config.logger.get("use_console", True):
                loggers.append(ConsoleLogger(config, unique_token))
        self.logger: BaseLogger = MultiLogger(loggers)

    def log(self, metrics: Dict, t: int, t_eval: int, event: LogEvent) -> Dict:
        """Summarise `metrics` and send them to the backends; returns every
        rank's metrics joined (with `win_rate` in place of `won_episode`),
        which the caller reads as the run's (the evaluation's return, its win
        rate). Under a process group this is a collective (reference
        :334-356): every rank calls it, at the same point, with the same keys;
        no call site is wrapped in a rank check."""
        joined = gather_metrics(metrics)
        if "won_episode" in joined:
            joined = self.calc_winrate(joined, event)
        # Keys in sorted order at every level, as the reference's `jax.tree.map`
        # leaves them: the console line and the TensorBoard records follow it.
        metrics = _sorted_keys(pytree.tree_map(_to_host, joined))
        if event == LogEvent.TRAIN:
            metrics = pytree.tree_map(np.mean, metrics)
        else:
            metrics = pytree.tree_map(describe, metrics)
        self.logger.log_dict(metrics, t, t_eval, event)
        return joined

    def calc_winrate(self, episode_metrics: Dict, event: LogEvent) -> Dict:
        # Mutates the caller's dict, as the reference does (its :367-377): the
        # systems read eval_metrics["win_rate"] (`env.eval_metric`) after logging.
        won = _to_host(episode_metrics.pop("won_episode"))
        n_episodes = max(int(np.size(won)), 1)
        episode_metrics["win_rate"] = (np.sum(won) / n_episodes) * 100
        return episode_metrics

    def stop(self) -> None:
        self.logger.stop()
