"""One data-parallel update of ff-MASAC (critics on the global state and the
joint action) over two gloo ranks against the JAX learner on a 2-device CPU
mesh: the CTDE case of `test_torch_distributed_offpolicy.py`."""

import torch

from test_torch_distributed_offpolicy import check_sac_over_two_ranks

torch.set_num_threads(1)


def test_one_masac_update_over_two_ranks_matches_jax_mesh(tmp_path):
    check_sac_over_two_ranks(tmp_path, "default_ff_masac", True)
