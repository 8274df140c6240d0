"""One data-parallel update of rec-IQL and ff-ISAC over two gloo ranks against
the JAX learners on a 2-device CPU mesh.

The JAX learner is warmed up until its rings wrap, then each port rank gets
the JAX shard r's part of the state (parameters, Adam moments and count, its
ring, its envs, observations, flags and carries; the counters, which are
global in the reference) and the draws of shard r's key for the next update.
Rank 0's losses (which the reference `pmean`s) and parameters must agree with
the JAX learner's to rtol = atol = 1e-5; every rank must end with bitwise the
same parameters and optimizer state. rec-IQL counts its env-steps, and so its
epsilon, over both ranks.
"""

import jax
import numpy as np
import torch

from mava_tpu.parallel import make_mesh
from mava_tpu.systems.q_learning import rec_iql as jrec_iql
from mava_tpu.systems.sac import ff_isac as jff_isac
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.utils.checkpointing import differences
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_distributed_ppo import jax_shard
from test_torch_parallel_workers import run_workers
from test_torch_rec_iql import TINY as IQL_TINY
from test_torch_rec_iql import WARMUP_UPDATES
from test_torch_rec_iql import _load_learner_state as load_iql_state
from test_torch_rec_iql import _update_draws as iql_draws
from test_torch_sac import TINY as SAC_TINY
from test_torch_sac import _load_learner_state as load_sac_state
from test_torch_sac import _update_draws as sac_draws

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2
CPU = torch.device("cpu")


def _prepare(cfg):
    cfg.arch.n_devices = WORLD
    cfg.system.num_updates_per_eval = 1
    cfg.system.scan_steps = 1
    return cfg


def out_shard(jout, r: int, num_envs: int):
    """Shard r's episode metrics (their env axis is the last) of a JAX update's
    output (state, (metrics, losses))."""
    metrics, losses = jout[1]
    rows = slice(r * num_envs, (r + 1) * num_envs)
    return jout[0], ({k: np.asarray(v)[..., rows] for k, v in metrics.items()}, losses)


def assert_ranks_equal(outs):
    for r, out in enumerate(outs[1:], 1):
        assert not differences(out["params"], outs[0]["params"]), f"rank {r} params"
        assert not differences(out["opt"], outs[0]["opt"]), f"rank {r} optimizer"


def assert_losses(outs, jlosses):
    for name, values in jlosses.items():
        np.testing.assert_allclose(outs[0]["train"][name].numpy(), np.asarray(values),
                                   err_msg=name, **TOL)


def assert_module(host, jparams, head):
    want = from_flax_params(jparams, head=head)
    for name, value in host["__module__"].items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_one_rec_iql_update_over_two_ranks_matches_jax_mesh(tmp_path):
    cfg = _prepare(jax_load_config("default_rec_iql", IQL_TINY))
    mesh = make_mesh(jax.devices()[:WORLD])
    (jenv, _), q_net, opt, rb, jstate, _ = jrec_iql.init(cfg, mesh)
    update = jrec_iql.build_learn_fn(cfg, jenv, q_net, opt, rb, mesh, jstate.buffer_state)
    for _ in range(WARMUP_UPDATES):
        jstate, _ = update(jstate)
    jstate = jax.device_get(jstate)
    jout = jax.device_get(update(jstate))

    tcfg = _prepare(load_config("default_rec_iql", IQL_TINY + ["+arch.device=cpu"]))
    tcfg.arch.n_devices = 1  # the shard's own state, built in one process
    tenv, _ = tenvs.make(tcfg, "cpu")
    buffer = rec_iql.make_buffer(tcfg)
    full = bool(np.asarray(jstate.buffer_state.is_full))
    size = tcfg.system.buffer_size if full else int(np.asarray(jstate.buffer_state.current_index))
    size = min(size + tcfg.system.rollout_length, tcfg.system.buffer_size)
    num_starts = max(size - buffer.sample_sequence_length + 1, 1)
    for r in range(WORLD):
        shard = jax_shard(jstate, r, WORLD)
        _, _, state = rec_iql.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg, CPU)
        draws = iql_draws(shard, out_shard(jout, r, tcfg.arch.num_envs), cfg, jenv.unwrapped,
                          buffer, num_starts)
        torch.save({"system": "rec_iql", "config": "default_rec_iql", "overrides": IQL_TINY,
                    "state": load_iql_state(state, shard)._replace(key=None),
                    "draws": {"draws": draws}}, tmp_path / f"in_{r}.pt")
    outs = run_workers("update", WORLD, tmp_path)

    jnew, (_, jlosses) = jout
    assert_losses(outs, jlosses)
    assert_module(outs[0]["params"][0], jnew.params.online, "q_head")
    assert_module(outs[0]["params"][1], jnew.params.target, "q_head")
    assert_ranks_equal(outs)
    # The env-step count (epsilon's clock) is global: both ranks' envs.
    assert outs[0]["state"].time_steps == int(np.ravel(jnew.time_steps)[0])
    assert all(out["all_reduces"] == tcfg.system.epochs for out in outs)


def check_sac_over_two_ranks(tmp_path, config: str, centralised: bool):
    """One update of ff-ISAC (ff-MASAC when `centralised`) over two ranks
    against the JAX learner on a 2-device mesh."""
    cfg = _prepare(jax_load_config(config, SAC_TINY))
    explore, update, jstate = jff_isac.build_bench_learners(
        cfg, make_mesh(jax.devices()[:WORLD]), centralised)
    jstate, _ = explore(jstate)
    jstate, _ = update(jstate)  # warm-up: the rings wrap
    jout = jax.device_get(update(jstate))
    jstate = jax.device_get(jstate)

    tcfg = _prepare(load_config(config, SAC_TINY + ["+arch.device=cpu"]))
    tcfg.arch.n_devices = 1
    tenv, _ = tenvs.make(tcfg, "cpu", add_global_state=centralised)
    for r in range(WORLD):
        shard = jax_shard(jstate, r, WORLD)
        _, _, _, state = ff_isac.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg, CPU,
                                               centralised)
        draws = sac_draws(shard, out_shard(jout, r, tcfg.arch.num_envs), cfg, tenv)
        torch.save({"system": "ff_isac", "config": config, "overrides": SAC_TINY,
                    "centralised": centralised,
                    "state": load_sac_state(state, shard)._replace(key=None),
                    "draws": {"draws": draws}}, tmp_path / f"in_{r}.pt")
    outs = run_workers("update", WORLD, tmp_path)

    jnew, (_, jlosses) = jout
    assert_losses(outs, jlosses)
    params = outs[0]["params"]  # [actor, [[q1, q2], [target q1, target q2]], log_alpha]
    assert_module(params[0], jnew.params.actor, "value_head")
    for got, want in zip((*params[1][0], *params[1][1]),
                         (*jnew.params.q.online, *jnew.params.q.targets)):
        assert_module(got, want, "q_head")
    np.testing.assert_allclose(params[2].numpy(), np.asarray(jnew.params.log_alpha), **TOL)
    assert_ranks_equal(outs)
    # Per epoch one Q all-reduce, and on the actor's epochs one per actor and
    # alpha step (policy_update_delay of each).
    sys_cfg = tcfg.system
    actor_epochs = len(range(0, sys_cfg.epochs, sys_cfg.policy_update_delay))
    want = sys_cfg.epochs + actor_epochs * sys_cfg.policy_update_delay * 2
    assert all(out["all_reduces"] == want for out in outs)


def test_one_isac_update_over_two_ranks_matches_jax_mesh(tmp_path):
    check_sac_over_two_ranks(tmp_path, "default_ff_isac", False)
