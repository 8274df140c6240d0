"""rec-IPPO and rec-MAPPO of the port's stacked seed programs against the
port's stock learner and the JAX package's vmapped learner (twin of
`tests/test_vmap_seeds.py:30`): one update of S = 2 seeds on RWARE tiny-2ag at
small widths, through the stacked GRU op (`network.gru_impl=pallas`: on CPU
tensors its plain versions), to rtol = atol = 1e-5, hidden states included.
The harness is `test_torch_vmap_seeds.check_stacked_update`; this file holds
the recurrent half so that each file compiles two JAX learners.
"""

import pytest

from test_torch_vmap_seeds import check_stacked_update


@pytest.mark.parametrize("system", ["rec_ippo", "rec_mappo"])
def test_stacked_update_matches_stock_and_jax_learners(system):
    check_stacked_update(system)
