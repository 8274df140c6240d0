"""The port's specs and staggered resets against `mava_tpu`'s.

Specs: every env's `observation_spec()` and `action_spec()`, bare and through
the wrapper chain (global state and agent ids), equal the JAX env's in kind,
shape, dtype, bounds, `num_values` and name.

Stagger: the burn-in of `stagger_env_states` is replayed step by step in JAX
from the reference's key (`derive_stagger_key`, the splits of stagger.py
:88-91, `jax.random.categorical` as Gumbel-max over the masked logits, or the
uniforms of a continuous spec) and checked against the JAX function; the port,
handed those draws and each step's env draws, must take exactly the JAX random
actions and leave every env where the JAX burn-in leaves it: RWARE's states
exactly, MaSwarm's ints exactly and its floats to its env test's 1e-6.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu import envs as jenvs
from mava_tpu import specs as jspecs
from mava_tpu.envs.stagger import derive_stagger_key
from mava_tpu.envs.stagger import stagger_env_states as jax_stagger
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch import specs
from mava_tpu_torch.envs.stagger import stagger_env_states, stagger_generator
from mava_tpu_torch.systems.ppo import ff_ippo, ff_mappo
from mava_tpu_torch.utils.config import load_config
from test_torch_maswarm import auto_reset_draws, reset_draws, to_noise
from test_torch_maswarm import to_torch_state as maswarm_state
from test_torch_rware import _reset_draws as rware_reset_draws
from test_torch_rware import _reset_noise as rware_reset_noise
from test_torch_rware import _step_draws as rware_step_draws
from test_torch_rware import _to_torch_state as rware_state

torch.set_num_threads(1)
# RWARE's states are ints and its views exact; MaSwarm's float dynamics are held
# to test_torch_maswarm.py's 1e-6 (XLA contracts its products into FMAs).
FLOAT_TOL = 1e-6

ENVS = {  # env -> (system config, extra overrides)
    "rware": ("default_ff_ippo", []),
    "matrax": ("default_ff_ippo", []),
    "smax": ("default_ff_ippo", ["env/scenario=3s5z"]),
    "lbf": ("default_ff_ippo", []),
    "cleaner": ("default_ff_ippo", []),
    "connector": ("default_ff_ippo", []),
    "gigastep": ("default_ff_ippo", []),
    "maswarm": ("default_ff_isac", []),
    "mareacher": ("default_ff_isac", []),
    "maswimmer": ("default_ff_isac", []),
    "mahopper": ("default_ff_isac", []),
    "macheetah": ("default_ff_isac", []),
    "mawalker": ("default_ff_isac", []),
    "maant": ("default_ff_isac", []),
    "mahumanoid": ("default_ff_isac", []),
}


def _assert_spec_equal(got, want, where):
    if isinstance(want, jspecs.TreeSpec):
        assert isinstance(got, specs.TreeSpec), where
        assert got._constructor.__name__ == want._constructor.__name__, where
        assert got._name == want._name and set(got.fields) == set(want.fields), where
        for k, v in want.fields.items():
            _assert_spec_equal(got.fields[k], v, f"{where}.{k}")
        return
    assert type(got).__name__ == type(want).__name__, where
    assert got.shape == tuple(want.shape) and got.name == want.name, where
    assert str(got.dtype).removeprefix("torch.") == str(np.dtype(want.dtype)), where
    for attr in ("minimum", "maximum", "num_values"):
        assert getattr(got, attr, None) == getattr(want, attr, None), f"{where}.{attr}"
    value = got.generate_value()
    assert tuple(value.shape) == got.shape and value.dtype == got.dtype, where


@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_specs_match_jax_envs(env_name):
    system, extra = ENVS[env_name]
    overrides = [f"env={env_name}", *extra]
    for centralised in (False, True):
        jenv, _ = jenvs.make(jax_load_config(system, overrides), add_global_state=centralised)
        tenv, _ = tenvs.make(load_config(system, overrides), "cpu", add_global_state=centralised)
        where = f"{env_name} centralised={centralised}"
        _assert_spec_equal(tenv.observation_spec(), jenv.observation_spec(), where)
        _assert_spec_equal(tenv.action_spec(), jenv.action_spec(), where)
    _assert_spec_equal(tenv.unwrapped.observation_spec(), jenv.unwrapped.observation_spec(),
                       env_name)
    _assert_spec_equal(tenv.unwrapped.action_spec(), jenv.unwrapped.action_spec(), env_name)


def _replay_jax_burn_in(jenv, jstate, jts, key, env_draws):
    """stagger.py's burn-in as a host loop, keeping each step's draws: the
    action noise, and `env_draws(env keys)` of the wrapped env's step."""
    time_limit, n = int(jenv.time_limit), int(jts.reward.shape[0])
    spec = jenv.action_spec()
    cap_key, step_key = jax.random.split(key)
    caps = jax.random.randint(cap_key, (n,), 0, time_limit)
    step_keys = jax.random.split(step_key, time_limit - 1)
    jstep = jax.jit(jax.vmap(jenv.step))
    action_noise, env_noise, taken = [], [], []
    for t in range(time_limit - 1):
        mask = jts.observation.action_mask
        if isinstance(spec, jspecs.DiscreteArray):
            noise = jax.random.gumbel(step_keys[t], mask.shape)
            actions = jnp.argmax(noise + jnp.where(mask, 0.0, -1e9), axis=-1).astype(spec.dtype)
        else:
            noise = jax.random.uniform(step_keys[t], (n, *spec.shape))
            actions = jax.random.uniform(step_keys[t], (n, *spec.shape), minval=-1.0, maxval=1.0)
        action_noise.append(torch.tensor(np.asarray(noise)))
        taken.append(np.asarray(actions))
        env_noise.append(env_draws(jstate.env_state.key))
        new_state, new_ts = jstep(jstate, actions)
        advance = t < caps

        def sel(new, old):
            return jnp.where(advance.reshape((n,) + (1,) * (new.ndim - 1)), new, old)

        jstate, jts = jax.tree.map(sel, new_state, jstate), jax.tree.map(sel, new_ts, jts)
    return (jstate, jts), torch.tensor(np.asarray(caps)).long(), action_noise, env_noise, taken


def _rware_draws(unwrapped):
    fn = jax.jit(jax.vmap(lambda k: rware_step_draws(k, unwrapped)))

    def draws(keys):
        gumbels, resets = fn(keys)
        return torch.tensor(np.asarray(gumbels)), rware_reset_noise(resets)

    return draws


def _maswarm_draws(unwrapped):
    fn = jax.jit(jax.vmap(lambda k: auto_reset_draws(k, unwrapped)))
    return lambda keys: (None, to_noise(fn(keys)))


CASES = {  # env -> (system config, overrides, reset draws and their noise, env draws,
    #          to torch state)
    "rware": ("default_ff_ippo", ["env.kwargs.time_limit=12"],
              (rware_reset_draws, rware_reset_noise), _rware_draws, rware_state),
    "maswarm": ("default_ff_isac", ["env=maswarm", "env.kwargs.time_limit=9"],
                (reset_draws, to_noise), _maswarm_draws, maswarm_state),
}


@pytest.mark.parametrize("env_name", sorted(CASES))
def test_staggered_states_equal_jax(env_name):
    system, overrides, (reset_fn, to_reset_noise), draws_fn, to_torch = CASES[env_name]
    num_envs = 8
    jenv, _ = jenvs.make(jax_load_config(system, overrides))
    tenv, _ = tenvs.make(load_config(system, overrides), "cpu")
    unwrapped = jenv.unwrapped
    keys = jax.random.split(jax.random.PRNGKey(4), num_envs)
    jstate, jts = jax.vmap(jenv.reset)(keys)
    inner = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    tstate, tts = tenv.reset(to_reset_noise(jax.vmap(lambda k: reset_fn(k, unwrapped))(inner)))

    key = derive_stagger_key(jax.random.PRNGKey(42))
    (want_state, want_ts), caps, action_noise, env_noise, want_actions = _replay_jax_burn_in(
        jenv, jstate, jts, key, draws_fn(unwrapped))
    ref_state, ref_ts = jax_stagger(jenv, jstate, jts, key)  # the replay is the reference's
    for a, b in zip(jax.tree.leaves((ref_state, ref_ts)), jax.tree.leaves((want_state, want_ts))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    steps = np.asarray(want_state.running_count_episode_length)
    assert len(set(steps.tolist())) > 1, f"the burn-in left step counts {steps}"

    got_actions, step = [], tenv.step
    tenv.step = lambda state, action, noise: got_actions.append(action) or step(state, action, noise)
    got_state, got_ts = stagger_env_states(
        tenv, tstate, tts, torch.Generator(), caps=caps, action_noise=action_noise,
        env_noise=env_noise)
    # The burn-in's own work is exact: every random action, and which envs advanced
    # how far (step counts, episode counters, step types).
    for got, want in zip(got_actions, want_actions, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    want = to_torch(want_state)
    for g, w in zip(pytree.tree_leaves(got_state), pytree.tree_leaves(want)):
        if g.is_floating_point():  # MaSwarm's float dynamics: its own parity tolerance
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=FLOAT_TOL, atol=FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_allclose(got_ts.observation.agents_view.numpy(),
                               np.asarray(want_ts.observation.agents_view),
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_array_equal(got_ts.step_type.numpy(), np.asarray(want_ts.step_type))
    np.testing.assert_array_equal(got_ts.observation.step_count.numpy(),
                                  np.asarray(want_ts.observation.step_count))


def test_stagger_generator_leaves_the_learner_stream_alone():
    """The burn-in's generator is its own, the same for the same seed, and
    another for another seed."""
    a, b, c = (stagger_generator(s, "cpu") for s in (42, 42, 7))
    main = torch.Generator().manual_seed(42)
    x = torch.rand(4, generator=a)
    assert torch.equal(x, torch.rand(4, generator=b))
    assert not torch.equal(x, torch.rand(4, generator=c))
    assert not torch.equal(x, torch.rand(4, generator=main))


@pytest.mark.parametrize("module", [ff_ippo, ff_mappo])
def test_ff_systems_run_with_stagger_resets(module, fast_config_overrides, monkeypatch):
    system = module.__name__.rsplit(".", 1)[1]
    argv = [system, *fast_config_overrides, "env.kwargs.time_limit=16", "+arch.device=cpu",
            "arch.stagger_resets=True"]
    monkeypatch.setattr(sys, "argv", argv)
    assert np.isfinite(module.main())
