"""rec-IQL's seed program over a seed-sharded mesh of gloo ranks, against the
JAX vmapped learner and the port's unsharded stacked learner (the harness and
its description: `test_torch_seed_sharding.py`)."""

import pytest
import torch

from test_torch_seed_sharding import check_program

torch.set_num_threads(1)


@pytest.mark.parametrize("world", [2, 4])
def test_rec_iql_seed_sharded_update_matches_jax_and_unsharded(world, tmp_path):
    check_program("rec_iql", world, tmp_path)
