"""Multi-process support (port of `mava_tpu/parallel/distributed.py`).

One process per card, launched by torchrun:

    python -m torch.distributed.run --nproc-per-node=<W> \
        -m mava_tpu_torch.systems.ppo.rec_ippo [overrides]

`initialize` (which `systems.anakin.start_experiment` calls) reads torchrun's
variables and sets up the default process group, NCCL on the cards and gloo
when the run was asked onto the CPU (`+arch.device=cpu`); without them it does
nothing and the run is the stock single-process one.

The placement helpers give each rank its part of what a one-process run of the
global batch would hold: its rows of a global tensor (`put_sharded_rows`), its
own copy of a per-shard template (`tile_for_shards`), the replicated params
checked equal on every rank (`put_replicated`), and its rows of a global env
reset (`sharded_env_reset`). Logging and checkpointing are collective: every
rank calls them, rank 0 writes (`gather_metrics`, `utils/checkpointing.py`),
as does the recording program's vault (`gather_env_rows`).
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from mava_tpu_torch.parallel.mesh import Mesh

# What torchrun sets for every rank it starts.
_TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK")
# Collectives made by `gather_env_rows` (one per call under a data group).
env_row_gathers = 0


def initialize(device_type: str) -> bool:
    """With torchrun's variables set, initialize the default process group on
    `device_type`'s backend (NCCL for "cuda", with this rank on
    `cuda:LOCAL_RANK`; gloo for "cpu"); returns whether a group is up. A no-op
    without the variables or when a group is already up."""
    if dist.is_initialized():
        return True
    if not all(v in os.environ for v in _TORCHRUN_VARS):
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl")
    elif device_type == "cpu":
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"no process group backend for arch.device={device_type!r}")
    return True


def rank_device(device: torch.device) -> torch.device:
    """This rank's card under a process group (`cuda:LOCAL_RANK`), else `device`."""
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def take_rows(tree: Any, rows: Any, n_total: int) -> Any:
    """`rows` (a slice or an index tensor) of every tensor of `tree` whose
    leading axis has `n_total` rows; an int equal to `n_total` (an env count,
    as Cleaner's reset noise) becomes the number of rows taken; everything
    else is kept."""
    n = len(range(n_total)[rows]) if isinstance(rows, slice) else len(rows)

    def take(x: Any) -> Any:
        if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] == n_total:
            return x[rows]
        if isinstance(x, int) and not isinstance(x, bool) and x == n_total:
            return n
        return x

    return pytree.tree_map(take, tree)


def put_sharded_rows(tree: Any, mesh: Mesh) -> Any:
    """This rank's contiguous rows of a GLOBAL tree (leading axis split over
    the data ranks): rank r keeps rows [r * n, (r + 1) * n)."""
    leaves = [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]
    n_total = leaves[0].shape[0]
    if n_total % mesh.data_size:
        raise ValueError(f"{n_total} rows do not split over {mesh.data_size} ranks")
    n = n_total // mesh.data_size
    return take_rows(tree, slice(mesh.data_rank * n, (mesh.data_rank + 1) * n), n_total)


def tile_for_shards(tree: Any, mesh: Mesh) -> Any:
    """Each rank's own copy of a PER-SHARD template (hidden states, dones, a
    ring's experience): the global array is the template tiled over the data
    ranks, of which this rank holds its copy."""
    return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def put_replicated(tree: Any, mesh: Mesh) -> Any:
    """The replicated `tree` (params, optimizer state), checked bitwise equal
    on every rank of the mesh: they are so by construction (the same seed, the
    same init draws), and an all-reduced step keeps them so. Raises where a
    rank differs."""
    if mesh.data_group is None:
        return tree
    digest = hashlib.sha256()

    def add(x: Any) -> None:
        if isinstance(x, torch.nn.Module):  # a network: its parameters and buffers
            x = list(x.state_dict().values())
        elif isinstance(getattr(x, "params", None), dict):  # a `StackedNetwork`
            x = list(x.params.values())
        for t in pytree.tree_leaves(x):
            if isinstance(t, torch.Tensor):
                digest.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())

    pytree.tree_map(add, tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)
                    or isinstance(getattr(x, "params", None), dict))
    mine = digest.hexdigest()
    sums = [None] * mesh.data_size
    dist.all_gather_object(sums, mine, group=mesh.data_group)
    if len(set(sums)) != 1:
        raise RuntimeError(f"rank {mesh.rank}: replicated state differs across ranks: {sums}")
    return tree


def sharded_env_reset(env: Any, generator: torch.Generator, n_total: int,
                      mesh: Mesh) -> Tuple[Any, Any]:
    """Reset this rank's rows of `n_total` envs: every rank draws the reset
    noise of the whole global batch from the same generator and resets its
    row slice, so a W-rank run starts from exactly the rows of a one-process
    reset of `n_total` envs."""
    n = n_total // mesh.data_size
    rows = slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)
    return env.reset(take_rows(env.reset_noise(n_total, generator), rows, n_total))


def rank_generator(generator: torch.Generator, mesh: Mesh,
                   shared_over_seed_groups: bool = False) -> torch.Generator:
    """This rank's stream, from a generator every rank holds in the same state
    (the counterpart of `jax.random.split(key, n_devices)[rank]`): one stream
    per rank, or with `shared_over_seed_groups` one per data rank, the same in
    every seed group (a sweep's entries share their draws). Where there is
    one stream, the generator itself, so that a one-process run draws as it
    always has; else a generator seeded with this rank's of the seeds drawn
    from it."""
    n, index = ((mesh.data_size, mesh.data_rank) if shared_over_seed_groups
                else (mesh.world_size, mesh.rank))
    if n == 1:
        return generator
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int(seeds[index]))


def _host(x: Any) -> Any:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def gather_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Every rank's metrics joined (the reference's `process_allgather(...,
    tiled=True)`): arrays concatenated along their leading axis in rank order,
    scalars averaged (kept as they are where every rank holds the same). A
    collective over every rank: every rank calls it with the same keys.
    Without a process group the metrics are returned as they are."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return metrics
    mine = pytree.tree_map(_host, metrics)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)

    def join(*xs: Any) -> Any:
        if isinstance(xs[0], np.ndarray) and xs[0].ndim > 0:
            return np.concatenate(xs)
        if all(np.array_equal(x, xs[0]) for x in xs):  # replicated: kept as it is
            return xs[0]
        return float(np.mean(np.asarray(xs, dtype=np.float64)))

    return pytree.tree_map(join, *every)


def gather_env_rows(tree: Any, mesh: Mesh) -> Any:
    """Every data rank's rows of a (updates, T, E, ...) batch `tree` on its
    data rank 0, concatenated in rank order along the env axis (the
    reference's out spec `P(None, None, DATA_AXIS)`), and None on the other
    ranks. Each rank packs its tensors, env axis first, into one byte buffer,
    and one `gather` brings the W buffers to data rank 0, whatever the
    leaves' dtypes: every rank holds the same shapes, so each buffer splits
    back at the same offsets. Under a data group this is a collective even at
    one rank (every rank calls it); without one `tree` is returned as it is."""
    global env_row_gathers
    if mesh.data_group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    tensors = [x.detach().movedim(2, 0).contiguous() for x in leaves
               if isinstance(x, torch.Tensor)]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    dst = dist.get_global_rank(mesh.data_group, 0)
    every = ([torch.empty_like(flat) for _ in range(mesh.data_size)]
             if mesh.data_rank == 0 else None)
    dist.gather(flat, every, dst=dst, group=mesh.data_group)
    env_row_gathers += 1
    if every is None:
        return None
    parts: list = [[] for _ in tensors]
    for buffer in every:
        offset = 0
        for i, t in enumerate(tensors):
            n = t.numel() * t.element_size()
            # A copy: the slice's offset need not be aligned to the dtype's size.
            parts[i].append(buffer[offset : offset + n].clone().view(t.dtype).view(t.shape))
            offset += n
    joined = iter(torch.cat(p).movedim(0, 2) for p in parts)
    return pytree.tree_unflatten(
        [next(joined) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
