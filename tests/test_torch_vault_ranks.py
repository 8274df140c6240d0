"""The recording program over two gloo ranks against the JAX program on a
2-device CPU mesh (twin of `mava_tpu/advanced_usage/ff_ippo_store_experience.py`
:40-42, its out spec `P(None, None, DATA_AXIS)` :78-85, its global step count
:92-97, its vault :110-118 and its global mean :135-137, which
`tests/test_systems_integration.py:159` runs on the 8-device mesh).

The JAX recording learner of `tests/test_torch_vault.py` runs one update on
`make_mesh(jax.devices()[:2])`; each port rank runs
`ff_ippo_store_experience.run_experiment` from its shard's state and draws, in
a working directory of its own. Rank 0's vault, read back, equals the JAX
trajectories of both shards laid out batch-major, (2 * E * updates, T, ...):
the values to rtol = atol = 1e-5, the leaf names, dtypes and shapes exactly.
Rank 1 writes nothing, the MISC timestep counts both ranks' envs, and both
ranks return the JAX program's mean over the global batch. Then one torchrun
of the CLI at two ranks writes one vault of (2 * E * updates)-row chunks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from mava_tpu.replay import Vault as JVault
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.replay.vault import Vault
from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.utils.config import load_config
from test_torch_distributed_ppo import jax_shard
from test_torch_ff_ippo import TINY
from test_torch_parallel_workers import run_workers, worker_env
from test_torch_rec_ippo import _prepare, _start_from_jax
from test_torch_vault import LEAVES, TOL, _batch_major, _jax_trajectories

torch.set_num_threads(1)
WORLD = 2
STORE = TINY + ["arch.num_evaluation=1"]


def test_vault_over_two_ranks_matches_the_jax_mesh(tmp_path, monkeypatch):
    jstate, draws, jout, jtraj = _jax_trajectories(WORLD)
    cfg = _prepare(load_config("default_ff_ippo", TINY + ["+arch.device=cpu"]))
    env, _ = tenvs.make(cfg, "cpu")
    for r in range(WORLD):
        _, _, state = ff_ippo.learner_setup(env, torch.Generator().manual_seed(0), cfg,
                                            torch.device("cpu"))
        noise, perms = draws[r]
        (tmp_path / f"cwd_{r}").mkdir()
        torch.save({
            "config": "default_ff_ippo", "overrides": STORE, "cwd": str(tmp_path / f"cwd_{r}"),
            "state": _start_from_jax(state, jax_shard(jstate, r, WORLD))._replace(key=None),
            "draws": {"noise": torch.tensor(noise)[None],
                      "permutations": torch.tensor(perms)[None]},
        }, tmp_path / f"in_{r}.pt")
    outs = run_workers("store", WORLD, tmp_path)

    # One vault, rank 0's; rank 1 created nothing.
    assert os.listdir(tmp_path / "cwd_1") == []
    vaults = tmp_path / "cwd_0" / "vaults"
    (uid,) = os.listdir(vaults / "store_ranks")
    got = Vault("store_ranks", rel_dir=str(vaults), vault_uid=uid).read()
    # The JAX slab under the same leaf names, through the JAX package's vault.
    monkeypatch.chdir(tmp_path)
    JVault("jax", vault_uid="u").write(_batch_major(jtraj))
    want = JVault("jax", vault_uid="u").read()
    assert set(got) == set(want) == LEAVES
    for name in sorted(LEAVES):
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert got[name].shape[:2] == (WORLD * 2, 8), name  # W * E * updates, T
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **TOL)

    # Global step counts, one gather a round, the global mean on every rank.
    steps_per_rank = 8 * 2  # rollout x envs of one update
    want_mean = float(np.mean(np.asarray(jout.episode_metrics["episode_return"])))
    for out in outs:
        assert out["misc_timesteps"] == [WORLD * steps_per_rank]
        assert out["gathers"] == 1
        np.testing.assert_allclose(out["value"], want_mean, **TOL)
    assert outs[0]["value"] == outs[1]["value"]


def test_store_cli_over_two_ranks_writes_one_vault(tmp_path):
    """torchrun --nproc-per-node=2 of the CLI on the CPU: one vault, written by
    rank 0, of (2 * E * updates, T, ...) chunks, one a round."""
    overrides = ["+arch.device=cpu", "system.num_updates=2", "arch.num_evaluation=2",
                 "system.rollout_length=4", "arch.num_envs=2", "env.kwargs.time_limit=16"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "mava_tpu_torch.advanced_usage.ff_ippo_store_experience", *overrides],
        capture_output=True, text=True, env=worker_env(), cwd=tmp_path, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("ff-IPPO experience-recording run completed.") == 2
    assert proc.stdout.count("Experience stored in ") == 1
    (uid,) = os.listdir(tmp_path / "vaults" / "ff_ippo_store_experience")
    base = tmp_path / "vaults" / "ff_ippo_store_experience" / uid
    assert json.loads((base / "manifest.json").read_text())["chunk_count"] == 2
    for chunk in ("chunk_000000", "chunk_000001"):
        action = np.load(base / chunk / ".action.npy")
        assert action.shape == (2 * 2 * 1, 4, 2)  # W * E * updates a round, T = 4, 2 agents
    assert "Timestep: 16" in proc.stderr + proc.stdout  # 2 ranks x 2 envs x T = 4
