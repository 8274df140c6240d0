"""The port's planar serial chains (MaSwimmer, MaHopper) against `mava_tpu`'s,
and the harness the other articulated tests share (`Pair`, `run_rollout`,
the asserts); the kinematic trees MaCheetah and MaWalker are in
`test_torch_planar_tree_envs.py`.

Per env, at its shipped scenario: the mass matrix against `jax.hessian`'s
(1e-6); q̈ from the same (q, q̇, τ) in three states, contact on (the body
pressed 1 cm into the ground), in flight (1 m up) and with every joint pushed
past its upper limit (1e-5 of q̈'s largest entry: the solve mixes every
entry); one step from those states (1e-5); then a rollout through AutoReset
-> RecordEpisodeMetrics with the JAX reset's draws injected (1e-4), long
enough for truncations, auto-resets and two steps after them
(`ROLLOUT_STEPS`), in which the hopper and the walker, pushed over at the
start, terminate with discount 0. The other factorisations
and the invariants are in `test_torch_articulated.py`.

The JAX envs' q̈ is traced once a file (`jax_accel_once`, which every file
that builds a JAX program over an articulated env takes up): see
`jax_accel_traced_once`.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.envs._dynamics import BodyState
from mava_tpu_torch.envs.wrappers import RecordEpisodeMetricsState
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
NUM_ENVS = 3
MASS_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)
# The rollouts run at `env.kwargs.time_limit=10`: every env ends its first
# episode (a fall, or the time limit at step 10) and is reset, and two steps
# follow its reset.
ROLLOUT_STEPS = 12
# env: (its base coordinates, the vertical one, reset noise width past the
# base, its half range, a pitch rate that topples it)
BODIES = {
    "maswimmer": (3, 1, 1, 0.1, 0.0),
    "mahopper": (3, 1, 1, 0.05, 4.0),
    "macheetah": (3, 1, 1, 0.05, 0.0),
    "mawalker": (3, 1, 1, 0.05, 4.0),
    "maant": (6, 2, 3, 0.05, 0.0),
    "mahumanoid": (6, 2, 3, 0.03, 8.0),
}


# Each JAX articulated env's q̈ (`_accel`) jitted once, the env static. A
# program that steps such an env then traces q̈ once, where it traced it once
# a Runge-Kutta stage (four in each substep scan) and a program (the step, the
# explore phase, the update); XLA inlines the call, so every program computes
# what it did (the same parameters bit for bit after a MaHumanoid MASAC
# update). Kept for the process, so that a file's programs share the traces.
_JITTED_ACCEL = {}


@contextlib.contextmanager
def jax_accel_traced_once():
    """The JAX articulated envs' `_accel` jitted (`_JITTED_ACCEL`) inside the
    block, restored after it; not reentrant."""
    from mava_tpu.envs import maant, macheetah, mahopper, mahumanoid, mareacher, maswimmer

    classes = [maant.MaAnt, macheetah.MaCheetah, mahopper.MaHopper, mahumanoid.MaHumanoid,
               mareacher.MaReacher, maswimmer.MaSwimmer]
    plain = {cls: cls.__dict__["_accel"] for cls in classes}
    for cls, fn in plain.items():
        cls._accel = _JITTED_ACCEL.setdefault(cls, jax.jit(fn, static_argnums=0))
    try:
        yield
    finally:
        for cls, fn in plain.items():
            cls._accel = fn


@pytest.fixture(scope="module", autouse=True)
def jax_accel_once():
    """`jax_accel_traced_once` for a whole test file (imported by name into
    every file that steps a JAX articulated env)."""
    with jax_accel_traced_once():
        yield


def _t(x, dtype=None):
    x = torch.tensor(np.asarray(x))
    return x if dtype is None else x.to(dtype)


def inner(env):
    while hasattr(env, "_env"):
        env = env._env
    return env


def reset_draws(key, name: str, unwrapped):
    """The uniform noise of `reset(key)` (e.g. `mahopper.py:263-270`)."""
    base, _, extra, half, _ = BODIES[name]
    _, q_key = jax.random.split(key)
    return jax.random.uniform(q_key, (extra + unwrapped.num_joints,), minval=-half, maxval=half)


def to_torch_state(jstate) -> RecordEpisodeMetricsState:
    s = jax.device_get(jstate)
    r = s.env_state
    return RecordEpisodeMetricsState(
        BodyState(_t(r.step_count, torch.int32), _t(r.q), _t(r.qd)),
        _t(s.running_count_episode_return), _t(s.running_count_episode_length, torch.int32),
        _t(s.episode_return), _t(s.episode_length, torch.int32))


class Pair:
    """One env of both packages, built as `make` builds them, with the JAX
    functions jitted once."""

    def __init__(self, name: str, overrides=()):
        overrides = [f"env={name}", *overrides]
        self.name = name
        self.jenv, _ = jenvs.make(jax_load_config("default_ff_isac", overrides))
        self.tenv, _ = tenvs.make(load_config("default_ff_isac", overrides), "cpu")
        self.ju, self.tu = self.jenv.unwrapped, inner(self.tenv)
        self.jstep = jax.jit(jax.vmap(self.jenv.step))
        self.jreset = jax.jit(jax.vmap(self.jenv.reset))  # eager, MaHumanoid's takes seconds
        self.jaccel = jax.jit(jax.vmap(self.ju._accel))

    def states(self, seed: int):
        """(q, q̇, τ, actions) of NUM_ENVS envs: pressed into the ground, in
        flight, and with the joints past their upper limits."""
        base, up, _, _, _ = BODIES[self.name]
        rng = np.random.default_rng(seed)
        keys = jax.random.split(jax.random.PRNGKey(seed), NUM_ENVS)
        q = np.array(self.jreset(keys)[0].env_state.q)
        n = q.shape[1]
        q[0, up] -= 0.01
        q[1, up] += 1.0
        hi = getattr(self.ju, "_joint_hi", None)
        q[2, base:] = (np.asarray(hi) + 0.2) if hi is not None else 1.2
        q[2, up] -= 0.02
        qd = rng.uniform(-1.5, 1.5, (NUM_ENVS, n)).astype(np.float32)
        tau = np.concatenate([np.zeros((NUM_ENVS, base)),
                              rng.uniform(-5, 5, (NUM_ENVS, n - base))], 1).astype(np.float32)
        actions = rng.uniform(-1.2, 1.2, (NUM_ENVS, self.ju.num_agents, self.ju.action_dim))
        return q.astype(np.float32), qd, tau, actions.astype(np.float32)

    def jax_state(self, q, qd, steps=4):
        keys = jax.random.split(jax.random.PRNGKey(0), NUM_ENVS)
        jstate, _ = self.jreset(keys)
        env_state = jstate.env_state.replace(
            q=jnp.asarray(q), qd=jnp.asarray(qd), step_count=jnp.full((NUM_ENVS,), steps, jnp.int32))
        return jstate.replace(env_state=env_state)


_PAIRS = {}


def shipped(name: str) -> Pair:
    """The env at its shipped scenario, built once per test module."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name, ["env.kwargs.time_limit=10"])
    return _PAIRS[name]


@pytest.fixture(scope="module", params=["maswimmer", "mahopper"])
def pair(request):
    return shipped(request.param)


# ATen ops that read a tensor back to the host (an error check, `.item()`, a
# data-dependent shape): none may be in a traced q̈, which a CUDA step queues
# without waiting for the device.
HOST_READS = ("aten._linalg_check_errors", "aten._local_scalar_dense", "aten.item",
              "aten._assert_async", "aten._assert_scalar", "aten.nonzero", "aten.masked_select")


def assert_graphs_read_nothing_back(integrator):
    graphs = list(integrator.accel.graphs.values())
    assert graphs, "q̈ was never traced"
    for graph in graphs:
        targets = {str(n.target) for n in graph.graph.nodes if n.op == "call_function"}
        assert not [t for t in targets if t.startswith(HOST_READS)], targets
        assert "aten._linalg_solve_ex.default" in targets


def assert_accel_matches(pair, q, qd, tau):
    want = np.asarray(pair.jaccel(*map(jnp.asarray, (q, qd, tau))))
    got = pair.tu.integrate.accel(_t(q), _t(qd), _t(tau)).numpy()
    bound = 1e-5 * np.abs(want).max(axis=1, keepdims=True) + 1e-5
    assert (np.abs(got - want) <= bound).all(), (np.abs(got - want) / bound).max()


def assert_step_matches(pair, q, qd, actions):
    jstate = pair.jax_state(q, qd)
    jnew, jts = pair.jstep(jstate, jnp.asarray(actions))
    noise = jax.vmap(lambda k: reset_draws(jax.random.split(k)[0], pair.name, pair.ju))(
        jstate.env_state.key)
    tnew, tts = pair.tenv.step(to_torch_state(jstate), _t(actions), (None, _t(noise)))
    for name in ("q", "qd"):
        np.testing.assert_allclose(getattr(tnew.env_state, name).numpy(),
                                   np.asarray(getattr(jnew.env_state, name)), err_msg=name,
                                   **STEP_TOL)
    np.testing.assert_allclose(tts.observation.agents_view.numpy(),
                               np.asarray(jts.observation.agents_view), **STEP_TOL)
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **STEP_TOL)
    np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
    np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
    return tnew, tts


def test_mass_matrix_matches_jax_hessian(pair):
    q, _, _, _ = pair.states(1)
    want = np.asarray(jax.jit(jax.vmap(pair.ju.mass_matrix))(jnp.asarray(q)))
    got = torch.stack([pair.tu.mass_matrix(_t(row)) for row in q]).numpy()
    np.testing.assert_allclose(got, want, **MASS_TOL)


def test_accel_matches_with_contact_flight_and_limits(pair):
    q, qd, tau, _ = pair.states(2)
    assert_accel_matches(pair, q, qd, tau)


def test_accel_graph_reads_nothing_back(pair):
    q, qd, tau, _ = pair.states(2)
    pair.tu.integrate.accel(_t(q), _t(qd), _t(tau))
    assert_graphs_read_nothing_back(pair.tu.integrate)


def test_one_step_matches_from_the_same_state(pair):
    q, qd, _, actions = pair.states(3)
    tnew, _ = assert_step_matches(pair, q, qd, actions)
    assert not np.allclose(q, tnew.env_state.q.numpy()), "the body did not move"


def run_rollout(pair, steps: int, seed: int, tol=ROLLOUT_TOL):
    """`steps` steps of both through the wrappers from the JAX reset, with the
    first episode pushed over by `BODIES`' pitch rate; returns the number of
    terminations (discount 0) and auto-resets."""
    base, _, _, _, push = BODIES[pair.name]
    keys = jax.random.split(jax.random.PRNGKey(seed), NUM_ENVS)
    jstate, jts = pair.jreset(keys)
    pitch = 2 if base == 3 else 4  # th, or the pitch of (roll, pitch, yaw)
    env_state = jstate.env_state.replace(qd=jstate.env_state.qd.at[:, pitch].set(push))
    jstate = jstate.replace(env_state=env_state)
    tstate = to_torch_state(jstate)
    tnoise = jax.vmap(lambda k: reset_draws(jax.random.split(k)[1], pair.name, pair.ju))(keys)
    _, tts = pair.tenv.reset(_t(tnoise))
    np.testing.assert_allclose(tts.observation.agents_view.numpy(),
                               np.asarray(jts.observation.agents_view), **STEP_TOL)
    draws = jax.jit(jax.vmap(lambda k: reset_draws(jax.random.split(k)[0], pair.name, pair.ju)))
    rng = np.random.default_rng(seed)
    terminations = resets = 0
    for _ in range(steps):
        shape = (NUM_ENVS, pair.ju.num_agents, pair.ju.action_dim)
        actions = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        noise = draws(jstate.env_state.key)
        jstate, jts = pair.jstep(jstate, jnp.asarray(actions))
        tstate, tts = pair.tenv.step(tstate, _t(actions), (None, _t(noise)))
        for key in ("observation", "real_next_obs"):
            tobs = tts.observation if key == "observation" else tts.extras[key]
            jobs = jts.observation if key == "observation" else jts.extras[key]
            np.testing.assert_allclose(tobs.agents_view.numpy(), np.asarray(jobs.agents_view),
                                       err_msg=key, **tol)
            np.testing.assert_array_equal(tobs.step_count.numpy(), np.asarray(jobs.step_count))
            np.testing.assert_array_equal(tobs.action_mask.numpy(), np.asarray(jobs.action_mask))
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward), **tol)
        np.testing.assert_array_equal(tts.step_type.numpy(), np.asarray(jts.step_type))
        np.testing.assert_array_equal(tts.discount.numpy(), np.asarray(jts.discount))
        for k, v in jts.extras["episode_metrics"].items():
            np.testing.assert_allclose(tts.extras["episode_metrics"][k].numpy(), np.asarray(v),
                                       err_msg=k, **tol)
        for name in ("q", "qd"):
            np.testing.assert_allclose(getattr(tstate.env_state, name).numpy(),
                                       np.asarray(getattr(jstate.env_state, name)),
                                       err_msg=name, **tol)
        terminations += int((np.asarray(jts.discount)[:, 0] == 0).sum())
        resets += int(np.asarray(jts.last()).sum())
    assert isinstance(tstate, RecordEpisodeMetricsState)
    return terminations, resets


def test_rollout_matches_through_auto_resets(pair):
    terminations, resets = run_rollout(pair, ROLLOUT_STEPS, seed=4)
    assert resets >= NUM_ENVS
    if BODIES[pair.name][4]:
        assert terminations > 0, "the pushed body never fell"
    else:
        assert terminations == 0
