"""Item replay buffer: a ring of single transitions, sampled uniformly (port of
`mava_tpu/replay/item_buffer.py:36-97`, the SAC systems' buffer).

The experience is a pytree whose leaves are (max_length, ...) tensors on the
run's device. `add` writes a batch of `add_batch_size` items (one per env) at
the ring head, in place: one slice where the batch fits before the end, a
scatter of the wrapped positions where it does not. The ring's counters are
host integers, as in the trajectory buffer. `sample` reads the rows handed to
it; `sample_indices` draws them uniformly over the valid prefix, apart from the
gather, so that a test can hand in the reference's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree


class ItemBufferState(NamedTuple):
    experience: Any  # pytree, leaves (max_length, ...)
    current_index: int  # next write position
    is_full: bool


class ItemBuffer:
    """The reference's flashbax-shaped API: `init`, `add`, `can_sample`, `sample`."""

    def __init__(self, max_length: int, min_length: int, sample_batch_size: int,
                 add_batch_size: int):
        self.max_length = max_length
        self.min_length = min_length
        self.sample_batch_size = sample_batch_size
        self.add_batch_size = add_batch_size

    def init(self, dummy_item: Any) -> ItemBufferState:
        """Zeroed storage shaped like `dummy_item` (one item, no batch axis), on
        the device and with the dtypes of its leaves."""
        experience = pytree.tree_map(
            lambda x: x.new_zeros((self.max_length, *x.shape)), dummy_item)
        return ItemBufferState(experience, 0, False)

    def add(self, state: ItemBufferState, batch: Any) -> ItemBufferState:
        """Writes `batch` (leaves (add_batch_size, ...)) at the ring head."""
        n = pytree.tree_leaves(batch)[0].shape[0]
        if n != self.add_batch_size:
            raise ValueError(f"add expects leading dim {self.add_batch_size}, got {n}")
        idx = state.current_index
        if idx + n <= self.max_length:
            where = slice(idx, idx + n)
        else:
            device = pytree.tree_leaves(state.experience)[0].device
            where = (idx + torch.arange(n, device=device)) % self.max_length

        def write(buf: torch.Tensor, x: torch.Tensor) -> None:
            buf[where] = x.to(buf.dtype)

        pytree.tree_map(write, state.experience, batch)
        return ItemBufferState(
            state.experience,
            (idx + n) % self.max_length,
            state.is_full or idx + n >= self.max_length,
        )

    def size(self, state: ItemBufferState) -> int:
        return self.max_length if state.is_full else state.current_index

    def can_sample(self, state: ItemBufferState) -> bool:
        return self.size(state) >= self.min_length

    def sample_indices(self, state: ItemBufferState, generator: torch.Generator) -> torch.Tensor:
        """(sample_batch_size,) rows, uniform over the valid prefix."""
        device = pytree.tree_leaves(state.experience)[0].device
        return torch.randint(0, self.size(state), (self.sample_batch_size,),
                             generator=generator, device=device)

    def sample(self, state: ItemBufferState, rows: torch.Tensor) -> Any:
        """The items at `rows`: leaves (len(rows), ...)."""
        rows = rows.long()
        return pytree.tree_map(lambda buf: buf[rows], state.experience)
