"""Trajectory replay buffer: a ring over the time axis per env, sampled as
whole sequences (port of `mava_tpu/replay/trajectory_buffer.py:50-147`).

The experience is a pytree whose leaves are (add_batch_size, max_length, ...)
tensors on the run's device. `add` writes a (add_batch_size, T_add, ...) slab
at the ring head, in place (the reference returns a new array); the ring's
counters are host integers, since they move the same way in every run.
`sample` gathers sequences of `sample_sequence_length` steps that start at
`(row, logical start)` pairs counted from the oldest step, so a sequence never
spans the write head. The pairs are drawn apart from the gather
(`sample_indices`), so that a test can hand in the reference's.

A captured program (rec-IQL's update, one CUDA graph) cannot read the host
counters inside its graph: it takes the parts apart. `write_positions` and
`advance` are what `add` does with the counters, `write` the write at given
ring positions; `physical_starts` turns logical starts into ring positions
from the counters, and `gather` reads the sequences at those positions.

As in the reference, a buffer that holds fewer steps than a sequence still
samples: `max(size - L + 1, 1)` starts, and the sequence reads the ring's
zero-filled rows beyond what was written.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class TrajectoryBufferState(NamedTuple):
    experience: Any  # pytree, leaves (add_batch_size, max_length_time_axis, ...)
    current_index: int  # next write position on the time ring
    is_full: bool


class TrajectoryBuffer:
    """The reference's flashbax-shaped API: `init`, `add`, `can_sample`, `sample`."""

    def __init__(
        self,
        sample_sequence_length: int,
        period: int,
        add_batch_size: int,
        sample_batch_size: int,
        max_length_time_axis: int,
        min_length_time_axis: int,
    ):
        if period != 1:
            raise ValueError("Only period=1 (any unique trajectory) is supported.")
        if sample_sequence_length > max_length_time_axis:
            raise ValueError("sample_sequence_length exceeds max_length_time_axis.")
        self.sample_sequence_length = sample_sequence_length
        self.add_batch_size = add_batch_size
        self.sample_batch_size = sample_batch_size
        self.max_length_time_axis = max_length_time_axis
        self.min_length_time_axis = min_length_time_axis

    def init(self, dummy_item: Any) -> TrajectoryBufferState:
        """Zeroed storage shaped like `dummy_item` (one transition, no batch or
        time axes), on the device and with the dtypes of its leaves."""
        experience = pytree.tree_map(
            lambda x: x.new_zeros((self.add_batch_size, self.max_length_time_axis, *x.shape)),
            dummy_item,
        )
        return TrajectoryBufferState(experience, 0, False)

    def add(self, state: TrajectoryBufferState, batch: Any) -> TrajectoryBufferState:
        """Writes `batch` (leaves (add_batch_size, T_add, ...)) at the ring head."""
        leaves = pytree.tree_leaves(batch)
        t_add = leaves[0].shape[1]
        if leaves[0].shape[0] != self.add_batch_size:
            raise ValueError(
                f"add expects leading dim {self.add_batch_size}, got {leaves[0].shape[0]}")
        self.write(state, batch, self.write_positions(state, t_add, leaves[0].device))
        return self.advance(state, t_add)

    def write_positions(self, state: TrajectoryBufferState, t_add: int,
                        device: torch.device) -> torch.Tensor:
        """The ring positions (t_add,) that the next `t_add` steps are written at."""
        steps = torch.arange(t_add, device=device)
        return (state.current_index + steps) % self.max_length_time_axis

    def write(self, state: TrajectoryBufferState, batch: Any, positions: torch.Tensor) -> None:
        """Writes `batch` (leaves (add_batch_size, T_add, ...)) at the ring
        `positions` (T_add,), in place; the counters are left as they are."""

        def write(buf: torch.Tensor, x: torch.Tensor) -> None:
            buf[:, positions] = x.to(buf.dtype)

        pytree.tree_map(write, state.experience, batch)

    def advance(self, state: TrajectoryBufferState, t_add: int) -> TrajectoryBufferState:
        """The counters after `t_add` more steps were written."""
        idx = state.current_index
        return TrajectoryBufferState(
            state.experience,
            (idx + t_add) % self.max_length_time_axis,
            state.is_full or idx + t_add >= self.max_length_time_axis,
        )

    def size(self, state: TrajectoryBufferState) -> int:
        return self.max_length_time_axis if state.is_full else state.current_index

    def can_sample(self, state: TrajectoryBufferState) -> bool:
        return self.size(state) >= self.min_length_time_axis

    def num_starts(self, state: TrajectoryBufferState) -> int:
        """How many logical start steps a sequence can take (at least 1)."""
        return max(self.size(state) - self.sample_sequence_length + 1, 1)

    def sample_indices(
        self, state: TrajectoryBufferState, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, logical_starts), each (sample_batch_size,), uniform over the
        envs and over the valid starts."""
        device = pytree.tree_leaves(state.experience)[0].device
        kw = dict(generator=generator, device=device)
        rows = torch.randint(0, self.add_batch_size, (self.sample_batch_size,), **kw)
        starts = torch.randint(0, self.num_starts(state), (self.sample_batch_size,), **kw)
        return rows, starts

    def sample(
        self, state: TrajectoryBufferState, rows: torch.Tensor, logical_starts: torch.Tensor
    ) -> Any:
        """The experience of the sequences at (rows, logical_starts): leaves
        (sample_batch_size, sample_sequence_length, ...)."""
        return self.gather(state, rows, self.physical_starts(state, logical_starts))

    def physical_starts(self, state: TrajectoryBufferState,
                        logical_starts: torch.Tensor) -> torch.Tensor:
        """The ring positions of logical starts (counted from the oldest step)."""
        oldest = state.current_index if state.is_full else 0
        return (oldest + logical_starts.long()) % self.max_length_time_axis

    def gather(self, state: TrajectoryBufferState, rows: torch.Tensor,
               physical_starts: torch.Tensor) -> Any:
        """The experience of the sequences at (rows, ring positions of their
        first steps): leaves (sample_batch_size, sample_sequence_length, ...)."""
        steps = torch.arange(self.sample_sequence_length, device=physical_starts.device)
        time_idx = (physical_starts[:, None] + steps) % self.max_length_time_axis
        row_idx = rows.long()[:, None]
        return pytree.tree_map(lambda buf: buf[row_idx, time_idx], state.experience)
