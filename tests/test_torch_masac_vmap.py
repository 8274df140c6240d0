"""ff-MASAC of the port's stacked programs (`advanced_usage/ff_masac_vmap_{seeds,
sweep}.py`): the centralised critics on the global state and the joint action,
through the harness of `test_torch_isac_vmap.py` (twin of
`tests/test_vmap_seeds.py:95` with `centralised_critic=True`). The stacked
explore phase from the JAX vmapped learner's first states and draws; entry s
of one stacked update against the JAX vmapped learner's entry s and the port's
stock ff-MASAC learner from entry s's state and draws, to rtol = atol = 1e-5,
at the shipped reward scale and at 0.1 (the MaSwarm anchor's);
the CLIs on the CPU. The JAX learner is compiled once for the file.
"""

import pytest
import torch

from mava_tpu_torch import envs as tenvs
from test_torch_isac_vmap import (
    check_cli,
    check_runs_on_the_card_by_default,
    check_stacked_explore,
    check_stacked_update,
    port_config,
)
from test_torch_sac import REWARD_SCALES

torch.set_num_threads(1)


def test_stacked_explore_matches_jax_vmapped_learner():
    check_stacked_explore(True)


@REWARD_SCALES
def test_stacked_update_matches_jax_vmapped_and_stock_learners(overrides):
    out = check_stacked_update(True, overrides)
    # Each entry's critics read the global state and the joint action.
    env, _ = tenvs.make(port_config(True, overrides), "cpu", add_global_state=True)
    width = env.num_global_state_features + env.num_agents * env.action_dim
    weight = out.learner_state.params.q.online.q1.params["torso.layers.0.weight"]
    assert weight.shape[0] == 2 and weight.shape[-1] == width


@pytest.mark.parametrize("program", ["ff_masac_seeds", "ff_masac_sweep"])
def test_cli_end_to_end(program, monkeypatch, capsys):
    check_cli(program, monkeypatch, capsys)


@pytest.mark.parametrize("program", ["ff_masac_seeds", "ff_masac_sweep"])
def test_runs_on_the_card_by_default(program):
    check_runs_on_the_card_by_default(program, "default_ff_masac")
