"""ff-MASAC of the port against `mava_tpu`'s: the centralised twin critics on
the global state and the joint action, the actor loss on the joint action with
each agent's fresh action in its own slot, and the global state stored once
per item. One whole update from the JAX learner's state and draws (after its
explore phase and a warm-up update; the buffer wraps) equals the JAX learner's
to 1e-5: every parameter, `log_alpha`, the Adam states, the losses and the
buffer. The same on MaHumanoid humanoid-9-8, whose centralised critics read
the global state, the two agents' 40-wide views tiled (2 x 80), and the joint
action of the padded (2, 9) rectangle; the JAX learner's two compiles of the
humanoid's step take most of a minute on a CPU, so this file starts early in
a run's queue of files. Then the CLI on the CPU, on MaSwarm and on MaReacher.
"""

import sys

import numpy as np
import pytest
import torch

from mava_tpu_torch.systems.sac import ff_masac
from mava_tpu_torch.utils.config import load_config
from test_torch_sac import CLI, REWARD_SCALES, _setup, check_one_update
from test_torch_sac_articulated import articulated_draws
from test_torch_planar_envs import jax_accel_once  # noqa: F401 (autouse: q̈ traced once)

torch.set_num_threads(1)


@REWARD_SCALES
def test_one_masac_update_matches_jax_learner(overrides):
    out = check_one_update("default_ff_masac", centralised=True, overrides=overrides)
    stored = out.learner_state.buffer_state.experience.obs.global_state
    assert stored.shape[1] == 1  # (max_length, 1, G): once per item


def test_one_masac_update_on_mahumanoid_matches_jax_learner():
    out = check_one_update("default_ff_masac", centralised=True, overrides=["env=mahumanoid"],
                           **articulated_draws("mahumanoid"))
    obs = out.learner_state.buffer_state.experience.obs
    assert obs.agents_view.shape[1:] == (2, 40) and obs.global_state.shape[1:] == (1, 80)
    q1 = out.learner_state.params.q.online.q1
    assert q1.torso.layers[0].in_features == 80 + 2 * 9


def test_autotune_off_keeps_alpha_and_matches():
    """`autotune=False`: log_alpha stays log(init_alpha) and no alpha step runs."""
    out = check_one_update("default_ff_masac", centralised=True, overrides=["system.autotune=False"])
    alpha = out.learner_state.params.log_alpha
    assert torch.allclose(alpha, torch.log(torch.tensor(0.1)).expand_as(alpha))
    assert out.learner_state.opt_states.alpha.count == 0
    assert (out.train_metrics["alpha_loss"] == 0).all()


def test_centralised_critics_read_the_joint_action():
    cfg, _, _, state = _setup(centralised=True, system="default_ff_masac")
    q1 = state.params.q.online.q1
    a = cfg.system.num_agents
    # global state (3 agents x 14 features) and the joint action (3 x 2)
    assert q1.torso.layers[0].in_features == a * 14 + a * 2
    assert state.obs.global_state.shape == (3, a, a * 14)


@pytest.mark.parametrize("env_overrides", [
    ["env.kwargs.time_limit=16"],
    ["env=mareacher", "env.kwargs.time_limit=8"],
], ids=["maswarm", "mareacher"])
def test_cli_end_to_end(monkeypatch, capsys, env_overrides):
    monkeypatch.setattr(sys, "argv", ["ff_masac", *CLI, *env_overrides])
    performance = ff_masac.main()
    assert np.isfinite(performance)
    captured = capsys.readouterr()
    assert "MASAC experiment completed." in captured.out
    assert "Log alpha" in captured.out + captured.err


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        ff_masac.run_experiment(load_config("default_ff_masac", ["system.num_updates=2"]))
