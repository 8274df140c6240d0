"""The PPO systems with a continuous (tanh-Normal) head against `mava_tpu`'s, on
the articulated envs.

The reference draws the standard normals of a tanh-Normal's one-sample entropy
estimate from a fresh key every minibatch (`ff_ippo.py:202`, `rec_ippo.py`'s
`_update_minibatch`); the port draws them from the learner's generator, or
takes them as `entropy_noise`. One ff-IPPO update on MaWalker walker2d-2x3
(`network=continuous_mlp`) and one rec-IPPO update on MaHopper hopper-3x1
(`network=rnn` with the continuous head, the plain GRU on the CPU) equal the
JAX learner's to rtol = atol = 1e-5, losses and new parameters, from the JAX
learner's parameters, env states and draws: the rollout's normals, the epoch
permutations and the entropy normals, recomputed from its keys as
`test_torch_ff_ippo.py` recomputes them. Then: the port draws the entropy
noise from the learner's generator and from nowhere else, and ff-IPPO's CLI
on MaWalker on the CPU.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mava_tpu import envs as jenvs
from mava_tpu.parallel import make_mesh
from mava_tpu.systems.ppo import ff_ippo as jff_ippo
from mava_tpu.systems.ppo import rec_ippo as jrec_ippo
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.utils.config import load_config
from test_torch_planar_envs import to_torch_state
from test_torch_rec_ippo import (
    TINY as REC_TINY,
    _assert_no_episode_ended,
    _assert_update_matches,
    _prepare,
    _start_from_jax,
)
from test_torch_planar_envs import jax_accel_once  # noqa: F401 (autouse: q̈ traced once)

torch.set_num_threads(1)
FF_TINY = [
    "arch.num_envs=2",
    "system.rollout_length=8",
    "system.ppo_epochs=2",
    "system.num_minibatches=2",
    "system.num_updates=1",
    "network.actor_network.pre_torso.layer_sizes=[16,16]",
    "network.critic_network.pre_torso.layer_sizes=[16,16]",
    "logger.use_console=False",
]
WALKER = ["env=mawalker", "network=continuous_mlp", "env.kwargs.time_limit=50"]
# A wider healthy band: the learner cannot take injected reset draws, so no
# episode may end in the compared rollout.
HOPPER = ["env=mahopper", "network=rnn", "network.action_head.type=ContinuousActionHead",
          "+env.kwargs.min_torso_height=0.3", "+env.kwargs.max_pitch=1.5"]


def _jax_draws(system, module, overrides, chunk=None):
    """The JAX learner's state, its draws and its update: the rollout normals,
    the epoch permutations and, per epoch and minibatch, the entropy normals
    of loc's shape (`ff_ippo.py:180-205`, `rec_ippo.py:259-290`)."""
    cfg = _prepare(jax_load_config(f"default_{system}", overrides))
    env, _ = jenvs.make(cfg)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    learn, _, state = module.learner_setup(env, tuple(keys), cfg, make_mesh(jax.devices()[:1]))
    sys_cfg = cfg.system
    t_len, e, a, act = sys_cfg.rollout_length, cfg.arch.num_envs, env.num_agents, env.action_dim
    key, sample_key = jax.random.split(state.key[0])
    noise = jax.random.normal(sample_key, (t_len, e, a, act))
    key, shuffle_key = jax.random.split(key)
    rows = t_len * e if chunk is None else t_len * e // chunk
    perms = jnp.argsort(jax.random.bits(shuffle_key, (sys_cfg.ppo_epochs, rows), dtype=jnp.uint32),
                        axis=1)
    mb = rows // sys_cfg.num_minibatches
    loc_shape = (mb, a, act) if chunk is None else (chunk, mb, a, act)
    entropy = []
    for _ in range(sys_cfg.ppo_epochs * sys_cfg.num_minibatches):
        key, entropy_key = jax.random.split(key)
        entropy.append(jax.random.normal(entropy_key, loc_shape))
    entropy = np.stack(entropy).reshape(sys_cfg.ppo_epochs, sys_cfg.num_minibatches, *loc_shape)
    out = jax.device_get(learn(state))
    return jax.device_get(state), np.asarray(noise), np.asarray(perms), entropy, out


def _check_update(system, module, jmodule, overrides, chunk=None):
    jstate, noise, perms, entropy, jout = _jax_draws(system, jmodule, overrides, chunk)
    _assert_no_episode_ended(jout)
    cfg = _prepare(load_config(f"default_{system}", overrides))
    env, _ = tenvs.make(cfg, "cpu")
    learn, _, state = module.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
        noise=torch.tensor(noise)[None], permutations=torch.tensor(perms)[None],
        entropy_noise=torch.tensor(entropy)[None],
    )
    out = learn(_start_from_jax(state, jstate, to_torch_state))
    _assert_update_matches(out, jout)
    assert (out.train_metrics["entropy"] != 0).all()
    return out


def test_continuous_ff_ippo_update_on_mawalker_matches_jax_learner():
    _check_update("ff_ippo", ff_ippo, jff_ippo, FF_TINY + WALKER)


def test_continuous_rec_ippo_update_on_mahopper_matches_jax_learner():
    out = _check_update("rec_ippo", rec_ippo, jrec_ippo,
                        REC_TINY + HOPPER + ["network.gru_impl=auto"], chunk=4)
    assert out.learner_state.hstates.policy_hidden_state.shape == (2, 3, 16)


def test_entropy_draws_come_from_the_learner_generator():
    """Without injected draws the update takes its entropy normals from the
    learner's generator: the same seed gives the same update whatever the
    global RNG holds, and the global RNG is left as it was."""
    # A rollout of 2: the minibatches' entropy normals are what is checked.
    cfg = _prepare(load_config("default_ff_ippo", FF_TINY + WALKER + ["system.rollout_length=2"]))
    env, _ = tenvs.make(cfg, "cpu")

    def update(global_seed):
        torch.manual_seed(global_seed)
        before = torch.random.get_rng_state()
        learn, _, state = ff_ippo.learner_setup(
            env, torch.Generator().manual_seed(7), cfg, torch.device("cpu"))
        out = learn(state)
        assert torch.equal(torch.random.get_rng_state(), before)
        return torch.cat([p.detach().flatten() for p in out.learner_state.params[0].parameters()])

    assert torch.equal(update(0), update(1))


def test_ff_ippo_cli_on_mawalker(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "ff_ippo", "env=mawalker", "network=continuous_mlp", "system.rollout_length=4",
        "system.num_updates=1", "arch.num_envs=2", "arch.num_evaluation=1",
        "arch.num_eval_episodes=2", "arch.absolute_metric=False", "env.kwargs.time_limit=6",
        "network.actor_network.pre_torso.layer_sizes=[16]",
        "network.critic_network.pre_torso.layer_sizes=[16]", "+arch.device=cpu"])
    assert np.isfinite(ff_ippo.main())
    assert "ff-IPPO experiment completed." in capsys.readouterr().out
