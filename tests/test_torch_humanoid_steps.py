"""The port's MaHumanoid (humanoid-9-8) steps against `mava_tpu`'s: one step
from contact, flight and joint-limit states (1e-5), and a 20-step rollout
through AutoReset -> RecordEpisodeMetrics with the JAX reset's draws injected
(1e-4), in which the humanoid, pushed over at the start, terminates with
discount 0 and is reset. Apart from `test_torch_humanoid.py` because the JAX
step alone takes about 25 s to compile on a CPU.
"""

import pytest
import torch

from test_torch_planar_envs import NUM_ENVS, Pair, assert_step_matches, run_rollout

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def humanoid():
    return Pair("mahumanoid", ["env.kwargs.time_limit=10"])


def test_one_step_matches_from_the_same_state(humanoid):
    q, qd, _, actions = humanoid.states(3)
    assert_step_matches(humanoid, q, qd, actions)


def test_rollout_matches_through_auto_resets(humanoid):
    terminations, resets = run_rollout(humanoid, 20, seed=4)
    assert terminations > 0 and resets >= NUM_ENVS


