"""Staggered resets of the stacked ff PPO programs over two gloo ranks (twin
of `mava_tpu/advanced_usage/ff_ippo_vmap_seeds.py:197-229`, whose burn-in
`tests/test_stagger.py:98` runs on a mesh-sharded batch).

`ff_ippo_vmap_seeds.learner_setup` with `arch.stagger_resets=True` at S = 2 on
W = 2 ranks, with one seed group and with `seed_shards=2`, for a seed study
and for an lr sweep. The ranks' start states equal what each rank's mesh
gives in this process, and hold the reference's invariants (:207-222): a
seed study's entries and the two data ranks' rows are staggered apart, with
more than 5 distinct step counts; a sweep's entries hold bitwise the same
envs on every rank and in every seed group. Then one stacked update of the
sweep from the ranks' staggered states equals the JAX vmapped learner on
`make_mesh(jax.devices()[:2])` given the same states (as its env state), the
same parameters and the same draws (the Gumbel noise and permutations of each
shard's key, and RWARE's request and auto-reset draws of each env's key chain,
as `tests/test_torch_specs_stagger.py` replays them), rtol = atol = 1e-5.
The JAX vmapped learner is compiled once for the file; the ranks run in one
spawn.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mava_tpu import envs as jenvs
from mava_tpu.advanced_usage import ff_ippo_vmap_seeds as jff_seeds
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds
from mava_tpu_torch.parallel import Mesh
from mava_tpu_torch.parallel.distributed import take_rows
from mava_tpu_torch.utils.checkpointing import differences
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_distributed_ppo import jax_shard
from test_torch_parallel_workers import run_workers
from test_torch_rware import _reset_noise, _step_draws
from test_torch_seed_sharding import entry, module_params
from test_torch_vmap_seeds import FF
from test_torch_vmap_sweep import SWEEP_LRS

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD, SEEDS, ENVS, ROLLOUT = 2, 2, 4, 8
OVERRIDES = FF + [f"arch.num_envs={ENVS}", "env.kwargs.time_limit=16"]
STAGGER = OVERRIDES + ["arch.stagger_resets=True"]
CPU = torch.device("cpu")
# (seed_shards, sweep) of each case, in the order the ranks run them.
CASES = [(1, True), (1, False), (2, True), (2, False)]


def rank_mesh(rank: int, shards: int) -> Mesh:
    """Rank `rank`'s place on the (seed, data) mesh of W = 2, without a group."""
    size = WORLD // shards
    return Mesh(WORLD, rank, None, size, rank % size, rank // size, shards)


def port_cfg(overrides, n_devices):
    cfg = load_config("default_ff_ippo", list(overrides) + ["+arch.device=cpu"])
    cfg.arch.n_devices, cfg.system.num_updates_per_eval = n_devices, 1
    return cfg


@functools.lru_cache(maxsize=None)
def local_start(rank: int, shards: int, sweep: bool):
    """(env state, timestep) that rank `rank`'s setup starts from."""
    mesh = rank_mesh(rank, shards)
    cfg = port_cfg(STAGGER, mesh.data_size)
    env, _ = tenvs.make(cfg, CPU)
    _, _, state = ff_ippo_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS,
        sweep_lrs=SWEEP_LRS if sweep else None, mesh=mesh)
    return state.env_state, state.timestep


def entry_rows(tree, e: int):
    """Entry e's ENVS rows of a rank's (entries * ENVS) batch."""
    n = pytree.tree_leaves(tree)[0].shape[0]
    return take_rows(tree, slice(e * ENVS, (e + 1) * ENVS), n)


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


# ----------------------------------------------------------------- JAX side
def global_batch(starts):
    """The (S, W * E, ...) batch of a one-group run from each rank's
    (S * E, ...) rows: entry e's rows of rank 0, then of rank 1."""
    def join(*ranks):
        return torch.stack([torch.cat([r[e * ENVS:(e + 1) * ENVS] for r in ranks])
                            for e in range(SEEDS)])
    return pytree.tree_map(join, *starts)


def to_jax(state, timestep, jstate):
    """The port's (S, W * E) env state and timestep as the JAX learner's, each
    env keeping the JAX state's own PRNG keys."""
    def a(x, like):
        return jnp.asarray(x.numpy()).astype(like.dtype)

    jenv, r = jstate.env_state, state.env_state
    rware = jenv.env_state.replace(**{f: a(getattr(r, f), getattr(jenv.env_state, f)) for f in (
        "step_count", "agent_pos", "agent_dir", "agent_carrying", "shelf_pos",
        "shelf_requested")})
    metrics = {f: a(getattr(state, f), getattr(jenv, f)) for f in (
        "running_count_episode_return", "running_count_episode_length", "episode_return",
        "episode_length")}
    jts = jstate.timestep
    obs = type(jts.observation)(*(a(x, y) for x, y in zip(timestep.observation,
                                                            jts.observation)))
    return jstate._replace(
        env_state=jenv.replace(env_state=rware, **metrics),
        timestep=jts.replace(step_type=a(timestep.step_type, jts.step_type),
                             reward=a(timestep.reward, jts.reward),
                             discount=a(timestep.discount, jts.discount), observation=obs))


def env_key_draws(jenv, jstate):
    """Each step's RWARE draws of every env, (S * W * E) rows: the request
    Gumbels and auto-reset draws of its key, the key chain advanced by the
    wrapped env's own step (its keys and resets do not depend on the actions)."""
    unwrapped = jenv.unwrapped
    draws_fn = jax.jit(jax.vmap(lambda k: _step_draws(k, unwrapped)))
    step = jax.jit(jax.vmap(jenv.step))
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), jstate.env_state)
    actions = jnp.zeros((flat.episode_length.shape[0], jenv.num_agents), jnp.int32)
    steps = []
    for _ in range(ROLLOUT):
        gumbels, resets = draws_fn(flat.env_state.key)
        steps.append((torch.tensor(np.asarray(gumbels)), _reset_noise(resets)))
        flat, _ = step(flat, actions)
    return steps


@functools.lru_cache(maxsize=None)
def jax_sweep_update():
    """The JAX vmapped sweep learner on a 2-device mesh, one update from the
    port ranks' staggered states; returns (config, env, first state, output)."""
    cfg = jax_load_config("default_ff_ippo", OVERRIDES)
    cfg.arch.n_devices, cfg.system.num_updates_per_eval = WORLD, 1
    jenv, _ = jenvs.make(cfg)
    learn, _, jstate = jff_seeds.learner_setup(
        jenv, jax.random.PRNGKey(3), cfg, make_mesh(jax.devices()[:WORLD]), SEEDS, False,
        sweep_lrs=SWEEP_LRS)
    starts = [local_start(r, 1, True) for r in range(WORLD)]
    jstate = to_jax(*global_batch(starts), jax.device_get(jstate))
    return cfg, jenv, jstate, jax.device_get(learn(jstate))


def sweep_inputs(rank: int):
    """Rank `rank`'s parameters (the JAX entries') and draws for the sweep's
    update at one seed group: each entry's noise and permutations from its
    shard's key, and the env draws of the rank's rows."""
    cfg, jenv, jstate, _ = jax_sweep_update()
    params = [{k: torch.stack([from_flax_params(entry(p, e))[k] for e in range(SEEDS)])
               for k in from_flax_params(entry(p, 0))} for p in jstate.params]
    noise, perms = [], []
    for e in range(SEEDS):
        shard = jax_shard(entry(jstate, e), rank, WORLD)
        key, sample_key = jax.random.split(shard.key[0])
        noise.append(jax.random.gumbel(sample_key, (ROLLOUT, ENVS, jenv.num_agents,
                                                    jenv.action_dim)))
        _, shuffle_key = jax.random.split(key)
        perms.append(jnp.argsort(jax.random.bits(
            shuffle_key, (cfg.system.ppo_epochs, ROLLOUT * ENVS), dtype=jnp.uint32), axis=1))
    rows = torch.cat([torch.arange(e * WORLD * ENVS + rank * ENVS,
                                   e * WORLD * ENVS + (rank + 1) * ENVS) for e in range(SEEDS)])
    env_noise = [take_rows(step, rows, SEEDS * WORLD * ENVS)
                 for step in env_key_draws(jenv, jstate)]
    return params, {"noise": torch.tensor(np.stack(noise))[None],
                    "permutations": torch.tensor(np.stack(perms))[None],
                    "env_noise": [env_noise]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the W = 2 gloo ranks, in one spawn: each rank's list of
    case outputs."""
    workdir = tmp_path_factory.mktemp("stagger_ranks")
    for rank in range(WORLD):
        cases = []
        for shards, sweep in CASES:
            case = {"seed_shards": shards, "sweep_lrs": SWEEP_LRS if sweep else None}
            if (shards, sweep) == (1, True):
                case["params"], case["draws"] = sweep_inputs(rank)
            cases.append(case)
        torch.save({"config": "default_ff_ippo", "overrides": STAGGER, "num": SEEDS,
                    "cases": cases}, workdir / f"in_{rank}.pt")
    return [out["cases"] for out in run_workers("stagger", WORLD, workdir)]


def starts_of(outs, case):
    return [outs[rank][CASES.index(case)]["start"] for rank in range(WORLD)]


def step_counts(start) -> torch.Tensor:
    return start[0].env_state.step_count


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("shards,sweep", CASES, ids=[
    f"shards{k}-{'sweep' if sweep else 'seeds'}" for k, sweep in CASES])
def test_each_rank_starts_where_its_mesh_says(ranks, shards, sweep):
    for rank, got in enumerate(starts_of(ranks, (shards, sweep))):
        assert equal(got, local_start(rank, shards, sweep)), f"rank {rank}"


@pytest.mark.parametrize("shards", [1, 2])
def test_a_sweep_holds_the_same_envs_in_every_entry_and_seed_group(ranks, shards):
    """Bitwise the same envs in every entry of a rank and, at seed_shards = 2,
    in both seed groups (each rank is data rank 0 of its group); staggered
    all the same (reference :213-222)."""
    starts = starts_of(ranks, (shards, True))
    for rank, start in enumerate(starts):
        for e in range(1, SEEDS // shards):
            assert equal(entry_rows(start, e), entry_rows(start, 0)), f"rank {rank} entry {e}"
    if shards == 2:
        assert equal(starts[0], starts[1])
    else:
        assert not torch.equal(step_counts(starts[0]), step_counts(starts[1]))
    distinct_ranks = starts if shards == 1 else starts[:1]
    counts = torch.cat([step_counts(entry_rows(s, 0)) for s in distinct_ranks])
    assert len(set(counts.tolist())) > 3, counts


@pytest.mark.parametrize("shards", [1, 2])
def test_a_seed_study_staggers_each_entry_and_data_rank_apart(ranks, shards):
    """Each entry its own offsets, each data rank its own (reference
    :209-212), and more than 5 step counts over the global batch
    (`tests/test_stagger.py:98`)."""
    starts = starts_of(ranks, (shards, False))
    blocks = [step_counts(entry_rows(s, e)) for s in starts for e in range(SEEDS // shards)]
    assert len(blocks) == SEEDS * WORLD // shards
    for i in range(len(blocks)):
        for j in range(i):
            assert not torch.equal(blocks[i], blocks[j]), (i, j)
    if shards == 1:
        assert len(set(torch.cat(blocks).tolist())) > 5, blocks


def test_one_staggered_sweep_update_over_two_ranks_matches_jax(ranks):
    _, _, _, jout = jax_sweep_update()
    outs = [ranks[rank][CASES.index((1, True))] for rank in range(WORLD)]
    for name, values in jout.train_metrics.items():
        np.testing.assert_allclose(outs[0]["train"][name].numpy(), np.asarray(values),
                                   err_msg=name, **TOL)
    for got, jparams in zip(module_params(outs[0]["params"]), jout.learner_state.params):
        for e in range(SEEDS):
            want = from_flax_params(entry(jparams, e))
            for name, value in got.items():
                np.testing.assert_allclose(value[e].numpy(), want[name].numpy(),
                                           err_msg=f"{name} entry {e}", **TOL)
    assert not differences(outs[1]["params"], outs[0]["params"])
    # Some env ended its episode in the rollout: the auto-reset draws were used.
    assert np.any(np.asarray(jout.episode_metrics["is_terminal_step"]))
