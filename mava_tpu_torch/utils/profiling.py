"""Per-phase wall clock (port of `mava_tpu/utils/profiling.py:32`)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


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
