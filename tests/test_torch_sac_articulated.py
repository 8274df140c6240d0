"""ff-ISAC on the articulated envs against `mava_tpu`'s: one whole update on
MaHopper hopper-3x1 from the JAX learner's state and draws equals the JAX
learner's to 1e-5 (every parameter, `log_alpha`, the Adam states, the losses,
the buffer), on the harness of `test_torch_sac.py`, with the hopper's
auto-reset draws (episodes of 5 steps: truncations, and falls with discount
0, inside the compared update). Then ff-ISAC's CLI on MaHumanoid on the CPU.
"""

import sys

import jax
import numpy as np
import torch

from mava_tpu_torch.systems.sac import ff_isac
from test_torch_planar_envs import _t, reset_draws, to_torch_state
from test_torch_sac import check_one_update
from test_torch_planar_envs import jax_accel_once  # noqa: F401 (autouse: q̈ traced once)

torch.set_num_threads(1)


def articulated_draws(name: str):
    """(reset_noise, key_after_reset) of an articulated env for the harness."""
    def reset_noise(env_keys, unwrapped):
        return _t(jax.vmap(lambda k: reset_draws(jax.random.split(k)[0], name, unwrapped))(env_keys))

    return dict(reset_noise=reset_noise, key_after_reset=lambda k: jax.random.split(k)[0],
                to_state=lambda s: to_torch_state(s))


def test_one_isac_update_on_mahopper_matches_jax_learner():
    out = check_one_update("default_ff_isac", centralised=False, overrides=["env=mahopper"],
                           **articulated_draws("mahopper"))
    assert out.learner_state.buffer_state.experience.obs.agents_view.shape[1:] == (3, 9)


def test_isac_cli_on_mahumanoid(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "ff_isac", "env=mahumanoid", "arch.num_envs=2", "system.explore_steps=4",
        "system.batch_size=4", "system.total_timesteps=8", "system.epochs=2",
        "system.policy_update_delay=2", "arch.num_evaluation=1", "arch.num_eval_episodes=2",
        "arch.absolute_metric=False", "env.kwargs.time_limit=2",
        "network.actor_network.pre_torso.layer_sizes=[16]",
        "network.critic_network.pre_torso.layer_sizes=[16]", "+arch.device=cpu"])
    assert np.isfinite(ff_isac.main())
    assert "ISAC experiment completed." in capsys.readouterr().out
