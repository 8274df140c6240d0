"""Replay buffers of S entries in one (the stacked programs' replay: the
reference `jax.vmap`s the stock buffer over its seed axis,
`mava_tpu/advanced_usage/ff_isac_vmap_seeds.py:117-140`).

Each entry has its own ring: every leaf carries a leading entry axis, (S, ...)
before the stock buffer's axes. The entries write in lockstep (every entry
adds one slab per env step), so one pair of host counters serves them all and
one in-place write fills the same ring positions of every entry. Each entry
samples only its own rows, from its own indices (S, B). The storage is made
once, zeroed, on the device of the dummy item it is shaped like: never an
entry at a time on the host.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.replay.item_buffer import ItemBuffer, ItemBufferState
from mava_tpu_torch.replay.trajectory_buffer import TrajectoryBuffer, TrajectoryBufferState

# `draw(fn, shape)` -> (S, *shape): one draw of `fn(shape, generator, device)`
# an entry (`advanced_usage.common.Draws`).
Draw = Callable[[Callable, Tuple[int, ...]], torch.Tensor]


def _zeros(dummy_item: Any, shape: Tuple[int, ...]) -> Any:
    return pytree.tree_map(lambda x: x.new_zeros((*shape, *x.shape)), dummy_item)


def _entries(rows: torch.Tensor) -> torch.Tensor:
    """(S, 1): the entry index of every row of an (S, B) index."""
    return torch.arange(rows.shape[0], device=rows.device)[:, None]


def _randint(high: int) -> Callable:
    def draw(shape, generator, device):
        return torch.randint(0, high, shape, generator=generator, device=device)
    return draw


class StackedTrajectoryBuffer(TrajectoryBuffer):
    """`TrajectoryBuffer` over S entries: leaves (S, add_batch_size,
    max_length_time_axis, ...); `add` takes (S, add_batch_size, T_add, ...)."""

    def __init__(self, entries: int, **kwargs):
        super().__init__(**kwargs)
        self.entries = entries

    def init(self, dummy_item: Any) -> TrajectoryBufferState:
        return TrajectoryBufferState(
            _zeros(dummy_item, (self.entries, self.add_batch_size, self.max_length_time_axis)),
            0, False)

    def add(self, state: TrajectoryBufferState, batch: Any) -> TrajectoryBufferState:
        """Writes `batch` (leaves (S, add_batch_size, T_add, ...)) at the ring head
        of every entry."""
        leaves = pytree.tree_leaves(batch)
        if tuple(leaves[0].shape[:2]) != (self.entries, self.add_batch_size):
            raise ValueError(f"add expects leading dims ({self.entries}, {self.add_batch_size}), "
                             f"got {tuple(leaves[0].shape[:2])}")
        t_add = leaves[0].shape[2]
        idx = state.current_index
        positions = (idx + torch.arange(t_add, device=leaves[0].device)) % self.max_length_time_axis

        def write(buf: torch.Tensor, x: torch.Tensor) -> None:
            buf[:, :, positions] = x.to(buf.dtype)

        pytree.tree_map(write, state.experience, batch)
        return TrajectoryBufferState(
            state.experience,
            (idx + t_add) % self.max_length_time_axis,
            state.is_full or idx + t_add >= self.max_length_time_axis,
        )

    def sample_indices(self, state: TrajectoryBufferState,
                       draw: Draw) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, logical_starts), each (S, sample_batch_size), uniform over the
        envs and the valid starts, entry by entry."""
        shape = (self.sample_batch_size,)
        return draw(_randint(self.add_batch_size), shape), draw(_randint(self.num_starts(state)), shape)

    def sample(self, state: TrajectoryBufferState, rows: torch.Tensor,
               logical_starts: torch.Tensor) -> Any:
        """Each entry's sequences at its (rows, logical_starts) (S, B): leaves
        (S, B, sample_sequence_length, ...)."""
        oldest = state.current_index if state.is_full else 0
        physical = (oldest + logical_starts.long()) % self.max_length_time_axis
        steps = torch.arange(self.sample_sequence_length, device=physical.device)
        time_idx = (physical[..., None] + steps) % self.max_length_time_axis
        entry_idx, row_idx = _entries(rows)[..., None], rows.long()[..., None]
        return pytree.tree_map(lambda buf: buf[entry_idx, row_idx, time_idx], state.experience)


class StackedItemBuffer(ItemBuffer):
    """`ItemBuffer` over S entries: leaves (S, max_length, ...); `add` takes
    (S, add_batch_size, ...)."""

    def __init__(self, entries: int, **kwargs):
        super().__init__(**kwargs)
        self.entries = entries

    def init(self, dummy_item: Any) -> ItemBufferState:
        return ItemBufferState(_zeros(dummy_item, (self.entries, self.max_length)), 0, False)

    def add(self, state: ItemBufferState, batch: Any) -> ItemBufferState:
        """Writes `batch` (leaves (S, add_batch_size, ...)) at the ring head of
        every entry: one slice where it fits before the end, else a scatter of
        the wrapped positions."""
        leaves = pytree.tree_leaves(batch)
        if tuple(leaves[0].shape[:2]) != (self.entries, self.add_batch_size):
            raise ValueError(f"add expects leading dims ({self.entries}, {self.add_batch_size}), "
                             f"got {tuple(leaves[0].shape[:2])}")
        n, idx = self.add_batch_size, state.current_index
        if idx + n <= self.max_length:
            where = slice(idx, idx + n)
        else:
            where = (idx + torch.arange(n, device=leaves[0].device)) % self.max_length

        def write(buf: torch.Tensor, x: torch.Tensor) -> None:
            buf[:, where] = x.to(buf.dtype)

        pytree.tree_map(write, state.experience, batch)
        return ItemBufferState(
            state.experience,
            (idx + n) % self.max_length,
            state.is_full or idx + n >= self.max_length,
        )

    def sample_indices(self, state: ItemBufferState, draw: Draw) -> torch.Tensor:
        """(S, sample_batch_size) rows, uniform over the valid prefix, entry by entry."""
        return draw(_randint(self.size(state)), (self.sample_batch_size,))

    def sample(self, state: ItemBufferState, rows: torch.Tensor) -> Any:
        """Each entry's items at its `rows` (S, B): leaves (S, B, ...)."""
        entry_idx, rows = _entries(rows), rows.long()
        return pytree.tree_map(lambda buf: buf[entry_idx, rows], state.experience)
