"""Data parallelism over ranks with `torch.distributed` (port of
`mava_tpu/parallel/`). The reference's `build_learner`, `replicate_sharding`
and `shard_leading_axis` place a jitted program on a mesh; a rank here runs
its own update and holds its own tensors, so they have no counterpart."""

from mava_tpu_torch.parallel.distributed import (
    initialize,
    is_main_process,
    put_replicated,
    put_sharded_rows,
    sharded_env_reset,
    tile_for_shards,
)
from mava_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEED_AXIS,
    Mesh,
    all_reduce_mean,
    make_mesh,
    make_seed_sharded_mesh,
    num_learner_devices,
)

__all__ = [
    "DATA_AXIS",
    "SEED_AXIS",
    "Mesh",
    "all_reduce_mean",
    "initialize",
    "is_main_process",
    "make_mesh",
    "make_seed_sharded_mesh",
    "num_learner_devices",
    "put_replicated",
    "put_sharded_rows",
    "sharded_env_reset",
    "tile_for_shards",
]
