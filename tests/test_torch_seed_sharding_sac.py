"""ff-ISAC's seed program over a seed-sharded mesh of gloo ranks, against the
JAX vmapped learner and the port's unsharded stacked learner (the harness and
its description: `test_torch_seed_sharding.py`). The JAX learner explores,
then takes a warm-up update so that the rings wrap, as in
`test_torch_isac_vmap.py`."""

import functools

import jax
import pytest
import torch

from mava_tpu.advanced_usage import ff_isac_vmap_seeds as jsac_seeds
from mava_tpu.parallel import make_mesh
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import ff_isac_vmap_seeds
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_distributed_offpolicy import out_shard
from test_torch_distributed_ppo import jax_shard
from test_torch_isac_vmap import stack_states, stacked_draws
from test_torch_sac import TINY
from test_torch_sac import _load_learner_state as load_sac_state
from test_torch_sac import _update_draws as sac_draws
from test_torch_seed_sharding import CPU, PROGRAMS, SEEDS, Program, _port_cfg, check_program, entry

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def sac_jax_run(d: int):
    cfg = jax_load_config("default_ff_isac", TINY)
    cfg.arch.n_devices, cfg.system.scan_steps = d, 1
    (jenv, _), _, (explore, update), jstate, _ = jsac_seeds.learner_setup(
        cfg, make_mesh(jax.devices()[:d]), SEEDS, False)
    warm, _ = update(explore(jstate)[0])
    return cfg, jenv.unwrapped, jax.device_get(warm), jax.device_get(update(warm))


def sac_port_input(entries, d_rank, d):
    jcfg, _, warm, jout = sac_jax_run(d)
    cfg = _port_cfg("default_ff_isac", TINY)
    env, _ = tenvs.make(cfg, CPU)
    stocks, draws = [], []
    for e in entries:
        shard = jax_shard(entry(warm, e), d_rank, d)
        _, _, _, state = ff_isac.learner_setup(env, torch.Generator().manual_seed(0), cfg, CPU)
        stocks.append(load_sac_state(state, shard))
        draws.append(sac_draws(shard, out_shard(entry(jout, e), d_rank, cfg.arch.num_envs),
                               jcfg, env))
    _, _, _, template = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, len(entries))
    return stack_states(template, stocks), {"draws": stacked_draws(draws)}


def sac_jax_params(jout, e):
    p = entry(jout[0].params, e)
    return [from_flax_params(p.actor)] + [from_flax_params(q, head="q_head")
                                          for q in (*p.q.online, *p.q.targets)]


def sac_port_learn(state, draws):
    cfg = _port_cfg("default_ff_isac", TINY)
    env, _ = tenvs.make(cfg, CPU)
    _, learn, _, _ = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, CPU, SEEDS)
    return learn(state, [draws["draws"]])


PROGRAMS["ff_isac"] = Program("default_ff_isac", TINY, sac_jax_run, sac_port_input,
                              sac_jax_params, sac_port_learn)


@pytest.mark.parametrize("world", [2, 4])
def test_isac_seed_sharded_update_matches_jax_and_unsharded(world, tmp_path):
    check_program("ff_isac", world, tmp_path)
