"""The port's `parallel/` package: the placement math (twin of
`tests/test_distributed.py`), the runtime's collectives on two gloo ranks, and
one rec-IPPO update over four ranks against the JAX learner on a 4-device
CPU mesh.

The placement helpers are pure functions of a rank's place (`Mesh`), so rank
r's slices are computed here for every r of W = 2 and 4 and must put back
exactly what a one-process run of the global batch holds. Without a process
group nothing in the package makes a collective.
"""

import numpy as np
import pytest
import torch

from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    make_seed_sharded_mesh,
    put_replicated,
    put_sharded_rows,
    sharded_env_reset,
    tile_for_shards,
)
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.parallel.distributed import gather_metrics, rank_generator
from mava_tpu_torch.systems.anakin import steps_per_round
from mava_tpu_torch.utils.checkpointing import _GENERATOR, _GENERATORS
from mava_tpu_torch.utils.config import load_config
from test_torch_distributed_ppo import assert_ranks_agree_with_jax, run_ppo_case
from test_torch_parallel_workers import run_workers
from test_torch_rec_ippo import TINY as REC_TINY

torch.set_num_threads(1)


def rank_mesh(rank: int, world: int) -> Mesh:
    return Mesh(world, rank, None, world, rank)


def leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("env_name", ["rware", "cleaner"])
def test_sharded_env_reset_rows_are_the_one_process_reset(world, env_name):
    """Rank r's reset is rows [r * n, (r + 1) * n) of a one-process reset of
    W * n envs from the same generator (Cleaner's reset noise is an env count)."""
    cfg = load_config("default_ff_ippo", [f"env={env_name}", "+arch.device=cpu"])
    env, _ = tenvs.make(cfg, "cpu")
    n_total = 8
    whole = sharded_env_reset(env, torch.Generator().manual_seed(5), n_total, Mesh())
    parts = [sharded_env_reset(env, torch.Generator().manual_seed(5), n_total,
                               rank_mesh(r, world)) for r in range(world)]
    for got, *ranks in zip(leaves(whole), *map(leaves, parts)):
        if got.dim() and got.shape[0] == n_total:
            assert torch.equal(torch.cat(ranks), got)
        else:
            assert all(torch.equal(x, got) for x in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_put_sharded_rows_slices(world):
    x = {"a": torch.arange(16).reshape(8, 2), "b": torch.arange(8.0)}
    parts = [put_sharded_rows(x, rank_mesh(r, world)) for r in range(world)]
    for key in x:
        assert all(p[key].shape[0] == 8 // world for p in parts)
        assert torch.equal(torch.cat([p[key] for p in parts]), x[key])
    with pytest.raises(ValueError, match="do not split"):
        put_sharded_rows({"a": torch.zeros(6)}, rank_mesh(0, 4))


@pytest.mark.parametrize("world", [2, 4])
def test_tile_for_shards_gives_each_rank_its_own_copy(world):
    template = {"h": torch.randn(3, 2, 4), "done": torch.zeros(3, 2, dtype=torch.bool)}
    parts = [tile_for_shards(template, rank_mesh(r, world)) for r in range(world)]
    for key, value in template.items():
        tiled = torch.cat([p[key] for p in parts])
        assert torch.equal(tiled, value.repeat(world, *([1] * (value.dim() - 1))))
        assert all(p[key].data_ptr() != value.data_ptr() for p in parts)


def test_without_a_process_group_nothing_is_collective():
    mesh = make_mesh()
    assert mesh == Mesh() and mesh.data_group is None
    before = mesh_module.all_reduces
    tree = (torch.ones(3), {"loss": torch.tensor(2.0)})
    assert all_reduce_mean(tree, mesh) is tree
    assert mesh_module.all_reduces == before
    metrics = {"x": torch.ones(2)}
    assert gather_metrics(metrics) is metrics
    params = torch.nn.Linear(2, 2)
    assert put_replicated(params, mesh) is params
    assert make_seed_sharded_mesh(1) == Mesh()
    with pytest.raises(ValueError, match=r"seed_shards=2 must divide the device count \(1\)"):
        make_seed_sharded_mesh(2)


def test_rank_generator_streams():
    """One process keeps its generator (so it draws as before); over ranks each
    rank draws its own stream, the same from the same start; a sweep's stream
    is its data rank's, the same in every seed group."""
    gen = torch.Generator().manual_seed(3)
    assert rank_generator(gen, Mesh()) is gen

    def draws(mesh, shared=False):
        stream = rank_generator(torch.Generator().manual_seed(3), mesh, shared)
        return torch.rand(4, generator=stream)

    a, b = draws(rank_mesh(0, 2)), draws(rank_mesh(1, 2))
    assert not torch.equal(a, b) and torch.equal(a, draws(rank_mesh(0, 2)))
    # Two seed groups of two data ranks: ranks 1 and 3 are data rank 1.
    group = lambda r: Mesh(4, r, None, 2, r % 2, r // 2, 2)  # noqa: E731
    assert torch.equal(draws(group(1), True), draws(group(3), True))
    assert not torch.equal(draws(group(1)), draws(group(3)))


def test_steps_per_round_counts_every_rank():
    cfg = load_config("default_rec_ippo", ["+arch.device=cpu"])
    cfg.system.num_updates_per_eval, cfg.arch.n_devices = 3, 1
    one = steps_per_round(cfg)
    cfg.arch.n_devices = 2
    assert steps_per_round(cfg) == 2 * one == 2 * 3 * cfg.system.rollout_length * cfg.arch.num_envs


def test_collectives_on_two_ranks(tmp_path):
    for r in range(2):
        torch.save({"cwd": str(tmp_path)}, tmp_path / f"in_{r}.pt")
    outs = run_workers("collectives", 2, tmp_path)
    for out in outs:
        # Arrays joined in rank order, a scalar that differs averaged, one that
        # does not kept.
        np.testing.assert_array_equal(out["gathered"]["episode_return"],
                                      [0, 1, 2, 10, 11, 12])
        assert out["gathered"]["steps_per_second"] == 0.5
        assert out["gathered"]["timestep"] == 64
        assert "replicated state differs across ranks" in out["replica_check"]
        assert torch.equal(out["mean"][0], torch.full((2, 2), 0.5))
        assert out["mean"][1].item() == 0.5
        assert out["directory"] == outs[0]["directory"]
    assert not torch.equal(outs[0]["eval_draws"], outs[1]["eval_draws"])
    # Rank 0 holds the joined state: the rows of each rank in rank order, the
    # params once, every rank's generator; the other ranks hold nothing.
    joined = outs[0]["joined"]
    assert outs[1]["joined"] is None
    assert torch.equal(joined["dones"], torch.tensor([0, 0, 1, 1]))
    assert torch.equal(joined["hstates"][0], torch.cat([torch.zeros(2, 3), torch.ones(2, 3)]))
    assert joined["key"][_GENERATORS].shape[0] == 2
    for r, out in enumerate(outs):
        split = out["split"]
        assert torch.equal(split[5], torch.tensor([r, r]))
        assert torch.equal(split[6][1], torch.full((2, 3), float(r + 1)))
        assert torch.equal(split[2][_GENERATOR],
                           torch.Generator().manual_seed(r).get_state())


def test_one_rec_ippo_update_over_four_ranks_matches_jax_mesh(tmp_path):
    outs, jout, _ = run_ppo_case(tmp_path, "rec_ippo", False, 4, REC_TINY,
                                 ["network.gru_impl=pallas", "arch.num_envs=1"])
    assert_ranks_agree_with_jax(outs, jout)
    assert all(out["all_reduces"] == 4 for out in outs)
