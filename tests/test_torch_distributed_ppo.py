"""One data-parallel update of the port's PPO systems over W gloo ranks against
the JAX learner on a W-device CPU mesh (`make_mesh(jax.devices()[:W])`).

The JAX learner runs once per case in this process. Rank r of the port gets
the JAX shard r's part of the learner state (its rows of the envs, timesteps,
dones and hidden states; the replicated params) and the draws of shard r's own
key (`state.key[r]`: Gumbel noise and epoch permutations), and runs in its own
process (`test_torch_parallel_workers.py`). The losses, which the reference
`pmean`s, and the new parameters of rank 0 must agree with the JAX learner's
to rtol = atol = 1e-5, and every rank must end with bitwise the same
parameters and optimizer moments: one all-reduce a minibatch step keeps them so.
"""

import jax
import numpy as np
import pytest
import torch

from mava_tpu import envs as jenvs
from mava_tpu.parallel import make_mesh
from mava_tpu.systems.ppo import ff_ippo as jff_ippo
from mava_tpu.systems.ppo import rec_ippo as jrec_ippo
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.utils.checkpointing import differences
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.convert import from_flax_params
from test_torch_ff_ippo import TINY as FF_TINY
from test_torch_parallel_workers import run_workers
from test_torch_rec_ippo import TINY as REC_TINY
from test_torch_rec_ippo import _assert_no_episode_ended, _start_from_jax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# The fields of a learner state that every shard holds whole; `key` is one per
# shard; every other field holds the shard's rows.
REPLICATED = {"params", "opt_states", "opt_state", "time_steps", "train_steps", "t"}


def jax_shard(jstate, r: int, world: int):
    """Shard r of W of a JAX learner state, as one device holds it: its rows
    of the sharded fields, its key (kept with a leading axis of one)."""
    parts = {}
    for name in jstate._fields:
        value = getattr(jstate, name)
        if name == "key":
            value = value[r : r + 1]
        elif name not in REPLICATED:
            value = jax.tree.map(
                lambda x: x[r * (x.shape[0] // world) : (r + 1) * (x.shape[0] // world)]
                if np.ndim(x) > 0 else x, value)
        parts[name] = value
    return type(jstate)(**parts)


def ppo_draws(key, cfg, env, sequences: int):
    """The Gumbel noise and epoch permutations a shard draws from its key
    (ff_ippo.py:116-126, :262-270; rec_ippo.py:138-148, :341-349)."""
    key, sample_key = jax.random.split(key)
    noise = jax.random.gumbel(
        sample_key,
        (cfg.system.rollout_length, cfg.arch.num_envs, env.num_agents, env.action_dim))
    _, shuffle_key = jax.random.split(key)
    perms = jax.numpy.argsort(jax.random.bits(
        shuffle_key, (cfg.system.ppo_epochs, sequences), dtype=jax.numpy.uint32), axis=1)
    return {"noise": torch.tensor(np.asarray(noise))[None],
            "permutations": torch.tensor(np.asarray(perms))[None]}


def _prepare(cfg, world):
    cfg.arch.n_devices = world
    cfg.system.num_updates_per_eval = 1
    return cfg


def run_ppo_case(tmp_path, system: str, centralised: bool, world: int, tiny, overrides=()):
    """The JAX learner on a W-device mesh and the port on W ranks, from the
    same state and per-shard draws; returns (rank outputs, JAX output, JAX state)."""
    recurrent = system.startswith("rec")
    config = f"default_{system}"
    jmodule = jrec_ippo if recurrent else jff_ippo
    overrides = list(tiny) + list(overrides)
    cfg = _prepare(jax_load_config(config, overrides), world)
    if recurrent:
        cfg.system.recurrent_chunk_size = cfg.system.get("recurrent_chunk_size") or \
            cfg.system.rollout_length
    jenv, _ = jenvs.make(cfg, add_global_state=centralised)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    learn, _, jstate = jmodule.learner_setup(
        jenv, tuple(keys), cfg, make_mesh(jax.devices()[:world]), centralised)
    jout = jax.device_get(learn(jstate))
    jstate = jax.device_get(jstate)
    _assert_no_episode_ended(jout)

    rows = cfg.system.rollout_length * cfg.arch.num_envs
    sequences = rows // cfg.system.recurrent_chunk_size if recurrent else rows
    tcfg = load_config(config, overrides + ["+arch.device=cpu"])
    tcfg.arch.n_devices, tcfg.system.num_updates_per_eval = 1, 1
    if recurrent:
        tcfg.system.recurrent_chunk_size = cfg.system.recurrent_chunk_size
    tenv, _ = tenvs.make(tcfg, "cpu", add_global_state=centralised)
    module = rec_ippo if recurrent else ff_ippo
    for r in range(world):
        shard = jax_shard(jstate, r, world)
        _, _, state = module.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg,
                                           torch.device("cpu"), centralised)
        torch.save({
            "system": "rec_ippo" if recurrent else "ff_ippo", "config": config,
            "overrides": overrides, "centralised": centralised,
            "state": _start_from_jax(state, shard)._replace(key=None),
            "draws": ppo_draws(shard.key[0], cfg, jenv, sequences),
        }, tmp_path / f"in_{r}.pt")
    return run_workers("update", world, tmp_path), jout, jstate


def assert_ranks_agree_with_jax(outs, jout):
    """Rank 0's losses and parameters against the JAX learner's, and every
    rank's parameters and optimizer moments bitwise equal to rank 0's."""
    for name, values in jout.train_metrics.items():
        np.testing.assert_allclose(outs[0]["train"][name].numpy(), np.asarray(values),
                                   err_msg=name, **TOL)
    for got, jparams in zip(outs[0]["params"], jout.learner_state.params):
        want = from_flax_params(jparams)
        for name, value in got["__module__"].items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **TOL)
    for r, out in enumerate(outs[1:], 1):
        assert not differences(out["params"], outs[0]["params"]), f"rank {r} params"
        assert not differences(out["opt"], outs[0]["opt"]), f"rank {r} optimizer"


@pytest.mark.parametrize("system,centralised", [("ff_ippo", False), ("ff_mappo", True)])
def test_one_ff_update_over_two_ranks_matches_jax_mesh(tmp_path, system, centralised):
    outs, jout, _ = run_ppo_case(tmp_path, system, centralised, 2, FF_TINY)
    assert_ranks_agree_with_jax(outs, jout)
    # One all-reduce a minibatch step: epochs x minibatches.
    assert all(out["all_reduces"] == 4 for out in outs)


def test_one_rec_ippo_update_over_two_ranks_matches_jax_mesh(tmp_path):
    outs, jout, _ = run_ppo_case(tmp_path, "rec_ippo", False, 2, REC_TINY,
                                 ["network.gru_impl=pallas"])
    assert_ranks_agree_with_jax(outs, jout)
    # Each rank's carries are its rows of the JAX learner's.
    for r, out in enumerate(outs):
        for got, want in zip(out["state"].hstates, jout.learner_state.hstates):
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[2 * r : 2 * r + 2], **TOL)
    assert all(out["all_reduces"] == 4 for out in outs)
