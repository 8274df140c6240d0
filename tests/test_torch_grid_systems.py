"""The PPO systems of the port on the grid envs and Gigastep, against
`mava_tpu`'s.

One update of ff-IPPO with `network=cnn` on Cleaner, and of rec-MAPPO with
`network=rcnn` on MaConnector (CNN pre-torsos on the agents' grid views and
the grid global state; chunks of 2 steps; the plain GRU and `gru_impl=pallas`,
which on CPU tensors runs the GRU op's plain versions), from the same
parameters, env state, Gumbel noise and epoch permutations as the JAX learner
on a 1-device CPU mesh: losses, new parameters and hidden states to rtol =
atol = 1e-5. Then the CLIs end to end on the CPU.
"""

import sys

import numpy as np
import pytest
import torch

from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs.cleaner import CleanerState
from mava_tpu_torch.envs.connector import ConnectorState
from mava_tpu_torch.systems.ppo import ff_ippo, rec_mappo
from mava_tpu_torch.utils.config import load_config
from test_torch_ff_ippo import _jax_update as jax_ff_update
from test_torch_grid_envs import to_torch_state
from test_torch_rec_ippo import (
    _assert_no_episode_ended,
    _assert_update_matches,
    _prepare,
    _start_from_jax,
    check_one_recurrent_update,
)

torch.set_num_threads(1)
SMALL = ["arch.num_envs=2", "system.rollout_length=8", "system.ppo_epochs=2",
         "system.num_minibatches=2", "system.num_updates=1", "logger.use_console=False"]
CNN_TINY = ["network=cnn", "env=cleaner", *SMALL,
            "network.actor_network.pre_torso.channel_sizes=[8,8]",
            "network.critic_network.pre_torso.channel_sizes=[8,8]",
            "+env.kwargs.time_limit=50"]
RCNN_TINY = ["network=rcnn", "env=connector", *SMALL, "system.recurrent_chunk_size=2",
             "network.hidden_state_dim=16",
             "network.actor_network.pre_torso.channel_sizes=[8,8]",
             "network.critic_network.pre_torso.channel_sizes=[8,8]",
             "network.actor_network.post_torso.layer_sizes=[16]",
             "network.critic_network.post_torso.layer_sizes=[16]",
             "+env.kwargs.time_limit=50"]


def test_one_ff_ippo_cnn_update_on_cleaner_matches_jax_learner():
    jstate, noise, perms, jout = jax_ff_update("ff_ippo", False, [], tiny=CNN_TINY)
    _assert_no_episode_ended(jout)
    cfg = _prepare(load_config("default_ff_ippo", CNN_TINY))
    env, _ = tenvs.make(cfg, "cpu")
    learn, _, state = ff_ippo.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
    )
    out = learn(_start_from_jax(state, jstate, lambda js: to_torch_state(js, CleanerState)))
    _assert_update_matches(out, jout)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_one_rec_mappo_rcnn_update_on_connector_matches_jax_learner(impl):
    check_one_recurrent_update("contiguous", impl, system="rec_mappo", centralised=True,
                               to_torch_state=lambda js: to_torch_state(js, ConnectorState),
                               tiny=RCNN_TINY)


@pytest.mark.parametrize("system,overrides,last_line,win_rate", [
    ("ff_ippo", ["env=cleaner", "network=cnn", "+env.kwargs.time_limit=16"],
     "ff-IPPO experiment completed.", False),
    ("rec_mappo", ["env=connector", "network=rcnn", "system.recurrent_chunk_size=2"],
     "Recurrent MAPPO experiment completed.", False),
    ("ff_ippo", ["env=gigastep", "+env.kwargs.time_limit=16"],
     "ff-IPPO experiment completed.", True),
], ids=["ff_ippo-cleaner-cnn", "rec_mappo-connector-rcnn", "ff_ippo-gigastep"])
def test_cli_end_to_end(system, overrides, last_line, win_rate, fast_config_overrides,
                        monkeypatch, capsys):
    """Cleaner logs a win rate while its eval metric stays the return;
    Gigastep's eval metric is the win rate, which `run_experiment` returns."""
    module = {"ff_ippo": ff_ippo, "rec_mappo": rec_mappo}[system]
    argv = [system, *fast_config_overrides, *overrides, "+arch.device=cpu",
            "logger.use_console=True"]
    monkeypatch.setattr(sys, "argv", argv)
    performance = module.main()
    captured = capsys.readouterr()
    assert last_line in captured.out
    logged = captured.out + captured.err
    evaluator = [line for line in logged.splitlines() if "EVALUATOR" in line]
    assert evaluator and "Episode return mean" in evaluator[-1]
    if "env=connector" not in overrides:  # Cleaner and Gigastep log a win rate
        assert "Win rate" in evaluator[-1]
    if win_rate:
        assert 0.0 <= performance <= 100.0
    else:
        assert np.isfinite(performance)
