"""The port's viewers (`mava_tpu_torch/envs/render.py`) against `mava_tpu`'s:
for every env `tests/test_render.py` covers, the frames drawn from the same
state (a reset, then a step, or a moved pose for the articulated envs) are
equal pixel for pixel; the episode rollout and GIF export, and the render
example, write their files."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from mava_tpu import specs as jspecs
from mava_tpu.envs import render as jrender
from mava_tpu.envs.cleaner import Cleaner as JCleaner
from mava_tpu.envs.connector import MaConnector as JMaConnector
from mava_tpu.envs.gigastep import Gigastep as JGigastep
from mava_tpu.envs.lbf import LevelBasedForaging as JLevelBasedForaging
from mava_tpu.envs.maant import MaAnt as JMaAnt
from mava_tpu.envs.macheetah import MaCheetah as JMaCheetah
from mava_tpu.envs.mahopper import MaHopper as JMaHopper
from mava_tpu.envs.mahumanoid import MaHumanoid as JMaHumanoid
from mava_tpu.envs.mareacher import MaReacher as JMaReacher
from mava_tpu.envs.maswarm import MaSwarm as JMaSwarm
from mava_tpu.envs.maswimmer import MaSwimmer as JMaSwimmer
from mava_tpu.envs.mawalker import MaWalker as JMaWalker
from mava_tpu.envs.rware import RobotWarehouse as JRobotWarehouse
from mava_tpu.envs.smax import Smax as JSmax
from mava_tpu_torch.envs import (
    cleaner, connector, gigastep, lbf, maant, macheetah, mahopper, mahumanoid, mareacher,
    maswarm, maswimmer, mawalker, rware, smax,
)
from mava_tpu_torch.envs.render import render_frame, rollout_episode, save_gif

torch.set_num_threads(1)
RWARE_KW = dict(shelf_rows=1, shelf_columns=3, column_height=8, num_agents=2, sensor_range=1,
                request_queue_size=2, time_limit=16)
PAIRS = {  # name -> (JAX env, port env)
    "RobotWarehouse": (lambda: JRobotWarehouse(**RWARE_KW),
                       lambda: rware.RobotWarehouse(**RWARE_KW)),
    "LevelBasedForaging": (JLevelBasedForaging, lbf.LevelBasedForaging),
    "Cleaner": (JCleaner, cleaner.Cleaner),
    "MaConnector": (JMaConnector, connector.MaConnector),
    "Smax": (lambda: JSmax(scenario="2s3z"), lambda: smax.Smax(scenario="2s3z")),
    "MaSwarm": (JMaSwarm, maswarm.MaSwarm),
    "MaReacher": (JMaReacher, mareacher.MaReacher),
    "MaSwimmer": (JMaSwimmer, maswimmer.MaSwimmer),
    "MaHopper": (JMaHopper, mahopper.MaHopper),
    "MaWalker": (JMaWalker, mawalker.MaWalker),
    "MaCheetah": (JMaCheetah, macheetah.MaCheetah),
    "Gigastep": (lambda: JGigastep(scenario="waypoint"), lambda: gigastep.Gigastep(scenario="waypoint")),
    "MaAnt": (JMaAnt, maant.MaAnt),
    "MaHumanoid": (JMaHumanoid, mahumanoid.MaHumanoid),
}


def _to_port_state(jstate, tstate):
    """The unbatched JAX state as a port state of one env: each field of the
    port's state from the JAX field of its name, in the port's dtype."""
    fields = {}
    for name, like in tstate._asdict().items():
        value = np.asarray(getattr(jstate, name))[None]
        fields[name] = torch.tensor(value).to(like.dtype)
    return type(tstate)(**fields)


def _random_action(env, key):
    spec = env.action_spec()
    if isinstance(spec, jspecs.DiscreteArray):
        return jax.random.randint(key, (env.num_agents,), 0, env.action_dim)
    return jax.random.uniform(key, (env.num_agents, env.action_dim), minval=-1.0, maxval=1.0)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_frames_equal_jax_frames(name):
    make_jax, make_port = PAIRS[name]
    jenv, tenv = make_jax(), make_port()
    tstate, _ = tenv.reset(tenv.reset_noise(1, torch.Generator().manual_seed(0)))
    jstate, _ = jenv.reset(jax.random.PRNGKey(3))
    frames = []
    for t in range(2):
        want = jrender.render_frame(jenv, jstate)
        got = render_frame(tenv, _to_port_state(jstate, tstate))
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} frame {t}")
        frames.append(got)
        if hasattr(jstate, "q"):  # articulated: a moved pose (their JAX step takes long to jit)
            q = jstate.q + 0.3 * jax.random.normal(jax.random.PRNGKey(t), jstate.q.shape)
            jstate = jstate.replace(q=q)
        else:
            jstate, _ = jax.jit(jenv.step)(jstate, _random_action(jenv, jax.random.PRNGKey(t)))
    assert frames[0].std() > 0  # something was drawn


def test_rollout_and_gif(tmp_path):
    env = cleaner.Cleaner(time_limit=5)

    def random_act(timestep, generator):
        return torch.randint(0, env.action_dim, (1, env.num_agents), generator=generator)

    frames, _ = rollout_episode(env, random_act, torch.Generator().manual_seed(0))
    assert 2 <= len(frames) <= 6
    path = save_gif(frames, str(tmp_path / "ep.gif"))
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("policy", ["random", "fresh", "checkpoint"])
def test_render_example(policy, tmp_path, monkeypatch):
    """`python -m mava_tpu_torch.examples.render_episode`: a random or fresh
    ff actor, or one restored from a checkpoint that a training run saved."""
    from mava_tpu_torch.examples import render_episode
    from mava_tpu_torch.systems.ppo import ff_ippo
    from mava_tpu_torch.utils.config import load_config

    monkeypatch.chdir(tmp_path)
    extra = []
    if policy == "checkpoint":
        ff_ippo.run_experiment(load_config("default_ff_ippo", [
            "env=cleaner", "network=cnn", "system.num_updates=1", "arch.num_evaluation=1",
            "system.rollout_length=4", "arch.num_envs=2", "arch.num_eval_episodes=2",
            "arch.absolute_metric=False", "system.ppo_epochs=1", "+env.kwargs.time_limit=8",
            "logger.use_console=False", "+arch.device=cpu", "logger.checkpointing.save_model=True",
            "logger.checkpointing.save_args.checkpoint_uid=run"]))
        extra = ["checkpoint_uid=run"]
    out = tmp_path / f"{policy}.gif"
    monkeypatch.setattr(sys, "argv", ["render_episode", "env=cleaner", "network=cnn",
                                      "+env.kwargs.time_limit=6", "+arch.device=cpu",
                                      f"policy={policy}", f"out={out}", *extra])
    assert render_episode.main() == str(out)
    assert os.path.getsize(out) > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default without a card")
def test_render_example_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Like the training CLIs, the example asks for the card unless the caller
    passes `+arch.device=cpu`."""
    from mava_tpu_torch.examples import render_episode

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["render_episode", "env=cleaner", "network=cnn",
                                      "+env.kwargs.time_limit=6"])
    with pytest.raises(RuntimeError, match=r"\+arch.device=cpu"):
        render_episode.main()
