"""rec-MAPPO and rec-IPPO of the port on SMAX 2s3z against `mava_tpu`'s: one
update from the same parameters, env state, Gumbel noise and epoch
permutations, to rtol = atol = 1e-5 (as `test_torch_rec_ippo.py` does on
RWARE). SMAX brings what RWARE does not: 5 agents, 10 actions, masks that
change every step, and the env's own world state as the centralised critic's
input. No episode ends in the rollout, so no reset draw is read.
"""

import pytest
import torch

from test_torch_rec_ippo import check_one_recurrent_update
from test_torch_smax import to_torch_state

torch.set_num_threads(1)
SMAX_2S3Z = ["env=smax", "env/scenario=2s3z"]


@pytest.mark.parametrize("system,centralised,impl", [
    ("rec_mappo", True, "auto"),
    ("rec_mappo", True, "pallas"),
    ("rec_ippo", False, "auto"),
])
def test_one_update_on_smax_matches_jax_learner(system, centralised, impl):
    check_one_recurrent_update("contiguous", impl, system=system, centralised=centralised,
                               env_overrides=SMAX_2S3Z, to_torch_state=to_torch_state)
