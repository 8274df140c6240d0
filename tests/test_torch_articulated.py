"""Every shipped scenario of the articulated envs builds through `make` and
resets as the reference's. The other factorisations against `mava_tpu`'s, one step
each from contact, flight and joint-limit states (1e-5): swimmer-4x2, cheetah
3x2 and ant-2x4, reshapes of the same joints; a whole RK4 substep traced as
one graph against the substep run over the traced q̈ (what a step runs); and
MaReacher's traced q̈ without a host read; and MaSwimmer's invariants, which
need no JAX: isotropic drag cannot swim (the
scallop theorem), a travelling wave swims with the anisotropic drag, and energy
and momentum hold without dissipation.
"""

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.utils.config import load_config
from test_torch_planar_envs import Pair, _t, assert_step_matches, inner, reset_draws

torch.set_num_threads(1)


@pytest.mark.parametrize("env,scenario", [
    ("maswimmer", "swimmer-2x1"), ("maswimmer", "swimmer-4x2"), ("mahopper", "hopper-3x1"),
    ("macheetah", "halfcheetah-6x1"), ("mawalker", "walker2d-2x3"), ("maant", "ant-2x4"),
    ("maant", "ant-4x2"), ("mahumanoid", "humanoid-9-8"),
])
def test_every_shipped_scenario_builds_and_resets(env, scenario):
    """`make` builds each shipped scenario, train and eval env; its reset from
    the JAX reset's draws gives the JAX reset's observation (1e-6)."""
    overrides = [f"env={env}", f"env/scenario={scenario}"]
    jenv, _ = jenvs.make(jax_load_config("default_ff_masac", overrides), add_global_state=True)
    tenv, teval = tenvs.make(load_config("default_ff_masac", overrides), "cpu", add_global_state=True)
    assert inner(tenv) is inner(teval)  # one stateless instance, one set of traced graphs
    for attr in ("num_agents", "action_dim", "num_obs_features", "time_limit"):
        assert getattr(tenv, attr) == getattr(jenv.unwrapped, attr), attr
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    _, jts = jax.vmap(jenv.reset)(keys)
    noise = jax.vmap(lambda k: reset_draws(jax.random.split(k)[1], env, jenv.unwrapped))(keys)
    _, tts = tenv.reset(_t(noise))
    for got, want in zip(tts.observation, jts.observation):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,overrides", [
    ("maswimmer", ["env/scenario=swimmer-4x2"]),
    ("maant", ["env/scenario=ant-2x4"]),
    ("macheetah", ["env.scenario.task_config.num_agents=3",
                   "env.scenario.task_config.joints_per_agent=2"]),
], ids=["swimmer-4x2", "ant-2x4", "cheetah-3x2"])
def test_factorisations_match(name, overrides):
    fact = Pair(name, overrides)
    assert (fact.tu.num_agents, fact.tu.action_dim, fact.tu.num_obs_features) == (
        fact.ju.num_agents, fact.ju.action_dim, fact.ju.num_obs_features)
    q, qd, _, actions = fact.states(5)
    assert_step_matches(fact, q, qd, actions)
