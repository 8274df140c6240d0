"""Profiling hooks (port of `mava_tpu/utils/profiling.py`): a trace of one
learner round and the per-phase wall clock.

`+arch.profile=True` traces learner round `arch.profile_step` (default 1, the
first after warm-up) with `torch.profiler`, CPU and CUDA activities, into a
Chrome trace under `arch.profile_dir` (default `results/profile`); the
systems' `record_function` spans (`rec_ippo/rollout`, `gru/fwd`, ...) name
the phases in it.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime
from typing import Iterator

import torch


@contextlib.contextmanager
def maybe_trace(config, step: int) -> Iterator[None]:
    """Trace round `arch.profile_step` when `arch.profile` is set (reference :19-29)."""
    enabled = bool(config.arch.get("profile", False))
    if not enabled or step != int(config.arch.get("profile_step", 1)):
        yield
        return
    log_dir = config.arch.get("profile_dir") or "results/profile"
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    stamp = datetime.now().strftime("%Y%m%d%H%M%S")
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{config.logger.system_name}_round{step}_{stamp}.json"))


class PhaseTimer:
    """Accumulates wall-clock per phase for MISC logging.

    CUDA work is asynchronous, so on a CUDA device the timer synchronises the
    device before reading the clock at both ends of a phase.
    """

    def __init__(self, device: torch.device | str = "cpu") -> None:
        self._cuda = torch.device(device).type == "cuda"
        self.phases: dict = {}

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = self._now()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (self._now() - start)

    def metrics(self, prefix: str = "time_") -> dict:
        return {f"{prefix}{k}": v for k, v in self.phases.items()}
