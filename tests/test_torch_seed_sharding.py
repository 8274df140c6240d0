"""The port's seed programs over a seed-sharded mesh of gloo ranks (twin of
`tests/test_seed_sharding.py`).

S = 2 entries on W ranks in `seed_shards` = K groups: at W = 2 and K = 2 each
rank holds one entry whole (no collective); at W = 4 and K = 2 each entry
lives on the two data ranks of its group, and the all-reduce runs within the
group only. The JAX vmapped learner on a D = W / K device data mesh (the same
per-seed data-shard count, as the reference's test compares) is warmed up and
run once in this process; each port rank gets its entries' part of the JAX
state (entry e, data shard d) and the draws of that shard's key. Every entry
of every rank must equal the JAX vmapped learner's entry to rtol = atol =
1e-5, and the port's unsharded stacked learner's entry (K = 1: one process at
D = 1, two data-parallel ranks at D = 2) to the same tolerance; the ranks of a
group end bitwise equal, and the entries of different groups differ (no
gradient crossed a seed group). ff-IPPO here (with the harness), rec-IQL in
`test_torch_seed_sharding_iql.py`, ff-ISAC in `test_torch_seed_sharding_sac.py`.
"""

import functools
from typing import Any, Callable, Dict, List, NamedTuple

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.advanced_usage import ff_ippo_vmap_seeds as jff_seeds
from mava_tpu.advanced_usage import rec_iql_vmap_seeds as jiql_seeds
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import common, ff_ippo_vmap_seeds, rec_iql_vmap_seeds
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.utils.checkpointing import differences
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_distributed_offpolicy import out_shard
from test_torch_distributed_ppo import jax_shard
from test_torch_parallel_workers import run_workers
from test_torch_rec_iql import TINY as IQL_TINY
from test_torch_rec_iql import WARMUP_UPDATES
from test_torch_rec_iql import _load_learner_state as load_iql_state
from test_torch_rec_iql import _update_draws as iql_draws
from test_torch_rec_iql_vmap import _stacked_draws as stacked_iql_draws
from test_torch_rec_iql_vmap import stack_states as stack_iql_states
from test_torch_rware import _to_torch_state
from test_torch_rec_ippo import _torch_timestep
from test_torch_vmap_seeds import FF

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = 2
CPU = torch.device("cpu")


def entry(tree, s):
    return jax.tree.map(lambda x: x[s], tree)


class Program(NamedTuple):
    """How one seed program is driven: its config, its JAX vmapped learner on
    a D-device mesh (`jax_run(D)` -> (config, env, state, output)), the port
    state and draws of entries `entries` on data shard d of D (`port_input`),
    the JAX entry's parameters as the port's module dicts (`jax_params`), and
    the port's one-process stacked learner (`port_learn(state, draws)`)."""

    config: str
    overrides: List[str]
    jax_run: Callable
    port_input: Callable
    jax_params: Callable
    port_learn: Callable


# ------------------------------------------------------------------ rec-IQL
def _iql_cfg(d):
    cfg = jax_load_config("default_rec_iql", IQL_TINY)
    cfg.arch.n_devices, cfg.system.num_updates_per_eval, cfg.system.scan_steps = d, 1, 1
    return cfg


@functools.lru_cache(maxsize=None)
def iql_jax_run(d: int):
    cfg = _iql_cfg(d)
    (jenv, _), _, update, jstate = jiql_seeds.learner_setup(cfg, make_mesh(jax.devices()[:d]),
                                                            SEEDS)
    for _ in range(WARMUP_UPDATES):
        jstate, _ = update(jstate)
    jstate = jax.device_get(jstate)
    return cfg, jenv.unwrapped, jstate, jax.device_get(update(jstate))


def _port_cfg(config, overrides, **extra):
    cfg = load_config(config, list(overrides) + ["+arch.device=cpu"])
    cfg.arch.n_devices, cfg.system.num_updates_per_eval, cfg.system.scan_steps = 1, 1, 1
    for k, v in extra.items():
        setattr(cfg.network if k == "gru_impl" else cfg.system, k, v)
    return cfg


def iql_port_input(entries, d_rank, d):
    jcfg, unwrapped, jstate, jout = iql_jax_run(d)
    cfg = _port_cfg("default_rec_iql", IQL_TINY, gru_impl="pallas")
    env, _ = tenvs.make(cfg, CPU)
    buffer = rec_iql.make_buffer(cfg)
    full = bool(np.asarray(jstate.buffer_state.is_full)[0])
    size = cfg.system.buffer_size if full else int(np.asarray(jstate.buffer_state.current_index)[0])
    size = min(size + cfg.system.rollout_length, cfg.system.buffer_size)
    num_starts = max(size - buffer.sample_sequence_length + 1, 1)
    stocks, draws = [], []
    for e in entries:
        shard = jax_shard(entry(jstate, e), d_rank, d)
        _, _, state = rec_iql.learner_setup(env, torch.Generator().manual_seed(0), cfg, CPU)
        stocks.append(load_iql_state(state, shard))
        draws.append(iql_draws(shard, out_shard(entry(jout, e), d_rank, cfg.arch.num_envs),
                               jcfg, unwrapped, buffer, num_starts))
    _, _, template = rec_iql_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, len(entries))
    return stack_iql_states(template, stocks), {"draws": stacked_iql_draws(draws)}


def iql_jax_params(jout, e):
    jnew = jout[0]
    return [from_flax_params(entry(p, e), head="q_head")
            for p in (jnew.params.online, jnew.params.target)]


def iql_port_learn(state, draws):
    cfg = _port_cfg("default_rec_iql", IQL_TINY, gru_impl="pallas")
    env, _ = tenvs.make(cfg, CPU)
    learn, _, _ = rec_iql_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, draws=[draws["draws"]])
    return learn(state)


# ------------------------------------------------------------------ ff-IPPO
def _ff_cfg(d):
    cfg = jax_load_config("default_ff_ippo", FF)
    cfg.arch.n_devices, cfg.system.num_updates_per_eval = d, 1
    return cfg


@functools.lru_cache(maxsize=None)
def ff_jax_run(d: int):
    cfg = _ff_cfg(d)
    jenv, _ = jenvs.make(cfg)
    learn, _, jstate = jff_seeds.learner_setup(
        jenv, jax.random.PRNGKey(3), cfg, make_mesh(jax.devices()[:d]), SEEDS, False)
    jout = jax.device_get(learn(jstate))
    assert not np.any(jout.episode_metrics["episode_return"]), "a reward was earned"
    return cfg, jenv, jax.device_get(jstate), jout


def ff_port_input(entries, d_rank, d):
    jcfg, jenv, jstate, _ = ff_jax_run(d)
    cfg = _port_cfg("default_ff_ippo", FF)
    env, _ = tenvs.make(cfg, CPU)
    _, _, state = ff_ippo_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, len(entries))
    noise, perms, env_states, timesteps = [], [], [], []
    rows = jcfg.system.rollout_length * jcfg.arch.num_envs
    for i, e in enumerate(entries):
        with torch.no_grad():
            for stacked, jparams in zip(state.params, jstate.params):
                for name, value in from_flax_params(entry(jparams, e)).items():
                    stacked.params[name][i].copy_(value)
        shard = jax_shard(entry(jstate, e), d_rank, d)
        key, sample_key = jax.random.split(shard.key[0])
        noise.append(jax.random.gumbel(sample_key, (
            jcfg.system.rollout_length, jcfg.arch.num_envs, jenv.num_agents, jenv.action_dim)))
        _, shuffle_key = jax.random.split(key)
        perms.append(jax.numpy.argsort(jax.random.bits(
            shuffle_key, (jcfg.system.ppo_epochs, rows), dtype=jax.numpy.uint32), axis=1))
        env_states.append(_to_torch_state(shard.env_state))
        timesteps.append(_torch_timestep(shard.timestep))
    cat = lambda *xs: torch.cat(xs)  # noqa: E731
    state = state._replace(
        env_state=torch.utils._pytree.tree_map(cat, *env_states),
        timestep=torch.utils._pytree.tree_map(cat, *timesteps))
    return state, {"noise": torch.tensor(np.stack(noise))[None],
                   "permutations": torch.tensor(np.stack(perms))[None]}


def ff_jax_params(jout, e):
    return [from_flax_params(entry(p, e)) for p in jout.learner_state.params]


def ff_port_learn(state, draws):
    cfg = _port_cfg("default_ff_ippo", FF)
    env, _ = tenvs.make(cfg, CPU)
    learn, _, _ = ff_ippo_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS, **draws)
    return learn(state)


PROGRAMS: Dict[str, Program] = {
    "rec_iql": Program("default_rec_iql", IQL_TINY + ["network.gru_impl=pallas"], iql_jax_run,
                       iql_port_input, iql_jax_params, iql_port_learn),
    "ff_ippo": Program("default_ff_ippo", FF, ff_jax_run, ff_port_input, ff_jax_params,
                       ff_port_learn),
}


# ------------------------------------------------------------------ harness
def run_program(program: Program, name: str, world: int, shards: int, tmp_path) -> List[Any]:
    """Each rank's output of one update of `program` on W ranks in `shards`
    seed groups, from the JAX vmapped learner's state and draws."""
    d = world // shards
    per = SEEDS // shards
    for rank in range(world):
        group, d_rank = divmod(rank, d)
        state, draws = program.port_input(range(group * per, (group + 1) * per), d_rank, d)
        torch.save({"system": name, "config": program.config, "overrides": program.overrides,
                    "seed_shards": shards, "num": SEEDS, "state": state._replace(key=None),
                    "draws": draws}, tmp_path / f"in_{rank}.pt")
    return run_workers("seed_update", world, tmp_path)


def module_params(host) -> List[Dict[str, torch.Tensor]]:
    """The modules of a `to_host` params tree, in order: {name: (S, ...)}."""
    found = []

    def walk(x):
        if isinstance(x, dict) and "__module__" in x:
            found.append(x["__module__"])
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(host)
    return found


def stacked_modules(params) -> List[Dict[str, torch.Tensor]]:
    """The stacked networks of a learner's params, {name: (S, ...)} each."""
    nets = [params.actor, *params.q.online, *params.q.targets] if hasattr(params, "q") \
        else list(params)
    return [{k: v.detach() for k, v in net.params.items()} for net in nets]


def check_sharded(name: str, world: int, tmp_path, unsharded: Callable[[], List[Dict]]):
    """The seed-sharded run of `name` at W ranks against the JAX vmapped
    learner and `unsharded()` (each entry's modules of the port's K = 1 run)."""
    program = PROGRAMS[name]
    outs = run_program(program, name, world, 2, tmp_path)
    d = world // 2
    jout = program.jax_run(d)[-1]
    want_port = unsharded()
    for rank, out in enumerate(outs):
        group, d_rank = divmod(rank, d)
        assert out["seed_group"] == group
        assert (out["all_reduces"] == 0) == (d == 1)  # a group of one rank has no collective
        got = module_params(out["params"])
        for net, want in zip(got, program.jax_params(jout, group)):
            for k, v in net.items():
                np.testing.assert_allclose(v[0].numpy(), want[k].numpy(), err_msg=f"{k} jax",
                                           **TOL)
        for net, want in zip(got, want_port[group]):
            for k, v in net.items():
                np.testing.assert_allclose(v[0].numpy(), want[k].numpy(), err_msg=f"{k} port",
                                           **TOL)
        if d_rank:
            assert not differences(out["params"], outs[rank - 1]["params"]), f"rank {rank}"
    first = [module_params(out["params"]) for out in (outs[0], outs[d])]
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(*first) for k in a)
    return outs


def one_process_unsharded(name: str):
    """Each entry's modules of the port's stacked learner in one process (D = 1)."""
    program = PROGRAMS[name]
    state, draws = program.port_input(range(SEEDS), 0, 1)
    params = stacked_modules(program.port_learn(state, draws).learner_state.params)
    return [[{k: v[e] for k, v in net.items()} for net in params] for e in range(SEEDS)]


def two_rank_unsharded(name: str, tmp_path):
    """Each entry's modules of the port's stacked learner over two
    data-parallel ranks (K = 1, D = 2); both ranks bitwise equal."""
    outs = run_program(PROGRAMS[name], name, 2, 1, tmp_path)
    assert not differences(outs[0]["params"], outs[1]["params"])
    nets = module_params(outs[0]["params"])
    return [[{k: v[e] for k, v in net.items()} for net in nets] for e in range(SEEDS)]


def check_program(name: str, world: int, tmp_path):
    """`check_sharded` at W = 2 (against one process) or W = 4 (against two
    data-parallel ranks)."""
    if world == 2:
        check_sharded(name, 2, tmp_path, lambda: one_process_unsharded(name))
    else:
        (tmp_path / "k1").mkdir()
        (tmp_path / "k2").mkdir()
        check_sharded(name, 4, tmp_path / "k2",
                      lambda: two_rank_unsharded(name, tmp_path / "k1"))


def test_seed_shards_must_divide_the_seeds_and_the_ranks():
    cfg = load_config("default_ff_ippo", ["+system.seed_shards=3", "+arch.device=cpu"])
    with pytest.raises(ValueError, match="seed_shards=3 must divide num_seeds=4"):
        common.seed_placement(cfg, 4)
    with pytest.raises(ValueError, match=r"seed_shards=3 must divide the device count \(1\)"):
        common.seed_placement(cfg, 6)


@pytest.mark.parametrize("world", [2, 4])
def test_ff_ippo_seed_sharded_update_matches_jax_and_unsharded(world, tmp_path):
    check_program("ff_ippo", world, tmp_path)

