"""The port's data-parallel "mesh" (port of `mava_tpu/parallel/mesh.py`).

The reference runs one program over a 1-D `data` mesh of chips: env state,
rollouts, hidden states and replay rings are sharded on their leading env
axis, params and optimizer state are replicated, and every optimizer step ends
in one `lax.pmean('data')` over the gradients and the loss info. Here the mesh
is the default process group of `torch.distributed` (one process per card,
launched by `python -m torch.distributed.run`): each rank holds its own
`arch.num_envs` envs, and the params stay identical on every rank because they
start from the same seed and every rank steps its optimizers with the same
all-reduced gradients (`all_reduce_mean`).

`make_seed_sharded_mesh` is the 2-D (seed, data) mesh of the stacked seed
programs: the ranks split into `seed_shards` groups of consecutive ranks, each
holding `num_seeds / seed_shards` entries, and the all-reduce goes over the
ranks of one group only, so that independent seeds never mix gradients.

Without a process group (the stock single-process run) the mesh has no data
group and `all_reduce_mean` returns its inputs: no collective, no launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

DATA_AXIS = "data"
SEED_AXIS = "seed"

# All-reduces made by `all_reduce_mean` (one per optimizer step under a group).
all_reduces = 0


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the run.

    `data_group` is the group whose ranks average their gradients (None: no
    collective); `data_size` its size and `data_rank` this rank's index in it;
    `seed_group` the index of this rank's seed group among `seed_shards`."""

    world_size: int = 1
    rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    data_size: int = 1
    data_rank: int = 0
    seed_group: int = 0
    seed_shards: int = 1


def make_mesh() -> Mesh:
    """The 1-D data mesh over every rank of the default process group; with no
    group, the one-process mesh (no data group)."""
    if not dist.is_initialized():
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(world, rank, dist.group.WORLD, world, rank)


def make_seed_sharded_mesh(seed_shards: int) -> Mesh:
    """The 2-D (seed, data) mesh: `seed_shards` groups of W / seed_shards
    consecutive ranks (the reference's `devices.reshape(seed_shards, -1)`).
    Every rank creates every group, in the same order, as `new_group` asks; a
    group of one rank has no collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if seed_shards < 1 or world % seed_shards != 0:
        raise ValueError(f"seed_shards={seed_shards} must divide the device count ({world})")
    if not dist.is_initialized():
        return Mesh()
    rank, size = dist.get_rank(), world // seed_shards
    group = rank // size
    data_group = None
    if size > 1:
        groups = [dist.new_group(list(range(g * size, (g + 1) * size)))
                  for g in range(seed_shards)]
        data_group = groups[group]
    return Mesh(world, rank, data_group, size, rank % size, group, seed_shards)


def num_learner_devices(mesh: Mesh) -> int:
    """The ranks of the mesh (the reference's device count)."""
    return mesh.world_size


def all_reduce_mean(tree: Any, mesh: Mesh) -> Any:
    """The mean over the data group of every tensor of `tree` (the reference's
    `lax.pmean(tree, 'data')`): the tensors flattened into one fp32 buffer,
    one all-reduce (SUM, then divided by the group's size) and the buffer
    split back into a tree of the same structure. Without a data group `tree`
    is returned as it is."""
    global all_reduces
    if mesh.data_group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    all_reduces += 1
    flat = flat / mesh.data_size
    out, offset = [], 0
    for t in leaves:
        out.append(flat[offset : offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return pytree.tree_unflatten(out, spec)
