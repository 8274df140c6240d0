"""The port's MaHumanoid (humanoid-9-8) steps against `mava_tpu`'s: one step
from contact, flight and joint-limit states (1e-5). Apart from
`test_torch_humanoid.py` because the JAX step alone takes about 25 s to
compile on a CPU; the 20-step rollout is in `test_torch_humanoid_rollout.py`,
so that each file stays within 90 s on one worker.
"""

import pytest
import torch

from test_torch_planar_envs import Pair, assert_step_matches

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def humanoid():
    return Pair("mahumanoid", ["env.kwargs.time_limit=10"])


def test_one_step_matches_from_the_same_state(humanoid):
    q, qd, _, actions = humanoid.states(3)
    assert_step_matches(humanoid, q, qd, actions)
