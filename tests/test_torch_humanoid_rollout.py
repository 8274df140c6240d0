"""The port's MaHumanoid (humanoid-9-8) against `mava_tpu`'s over a 20-step
rollout through AutoReset -> RecordEpisodeMetrics with the JAX reset's draws
injected (1e-4), in which the humanoid, pushed over at the start, terminates
with discount 0 and is reset. Apart from `test_torch_humanoid_steps.py`, so
that each file, with its own compile of the JAX step (about 25 s on a CPU)
and trace of the port's q̈, stays within 90 s on one worker.
"""

import pytest
import torch

from test_torch_planar_envs import NUM_ENVS, Pair, run_rollout

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def humanoid():
    return Pair("mahumanoid", ["env.kwargs.time_limit=10"])


def test_rollout_matches_through_auto_resets(humanoid):
    terminations, resets = run_rollout(humanoid, 20, seed=4)
    assert terminations > 0 and resets >= NUM_ENVS
