"""The rank processes of the port's data-parallel tests; no test lives here.

A test writes one input file per rank (`in_<rank>.pt`: a learner state, its
draws and the config) under a fresh directory and calls `run_workers`, which
starts one process per rank running this file. Each process joins a gloo
group through a file under that directory (so parallel tests never share a
port), runs the task and writes `out_<rank>.pt`. A worker imports torch,
numpy and the port, never JAX: the JAX side is computed once in the test's
own process.

    python tests/test_torch_parallel_workers.py <task> <rank> <world> <dir>
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def worker_env() -> Dict[str, str]:
    """The environment of a rank process: the repo and the tests importable,
    one thread each."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(TESTS), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_workers(task: str, world: int, workdir: Path, timeout: float = 240.0) -> List[Any]:
    """Run `task` on `world` ranks and return each rank's output, in rank
    order. Raises with the failing ranks' stderr if any rank fails."""
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), task, str(r), str(world), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=worker_env(), cwd=ROOT)
        for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False) for r in range(world)]


# ----------------------------------------------------------------------- tasks
def host_params(tree: Any) -> Any:
    """A learner's params as plain data: each network {"__module__": {name:
    tensor}} (a stacked network's (S, ...) tensors), tensors as they are."""
    if isinstance(tree, torch.nn.Module) or isinstance(getattr(tree, "params", None), dict):
        named = tree.params.items() if hasattr(tree, "params") else tree.state_dict().items()
        return {"__module__": {k: v.detach().clone() for k, v in named}}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return [host_params(v) for v in tree]


def _config(spec: Dict[str, Any], world: int):
    from mava_tpu_torch.utils.config import load_config

    cfg = load_config(spec["config"], list(spec["overrides"]) + ["+arch.device=cpu"])
    cfg.arch.n_devices = spec.get("n_devices", world)
    cfg.system.num_updates_per_eval = 1
    cfg.system.scan_steps = 1
    if cfg.system.get("recurrent_chunk_size") is None:
        cfg.system.recurrent_chunk_size = cfg.system.rollout_length
    return cfg


def update(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One update of a stock system (`spec["system"]`) on this rank's state
    and draws, data-parallel over the process group."""
    from mava_tpu_torch import envs as tenvs
    from mava_tpu_torch.parallel import mesh as mesh_module
    from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
    from mava_tpu_torch.systems.q_learning import rec_iql
    from mava_tpu_torch.systems.sac import ff_isac
    from mava_tpu_torch.utils.checkpointing import to_host

    cfg = _config(spec, world)
    system, centralised, draws = spec["system"], spec.get("centralised", False), spec["draws"]
    env, _ = tenvs.make(cfg, "cpu", add_global_state=centralised)
    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    state = spec["state"]._replace(key=gen)
    if system in ("ff_ippo", "rec_ippo"):
        module = ff_ippo if system == "ff_ippo" else rec_ippo
        learn, _, _ = module.learner_setup(env, gen, cfg, cpu, centralised, **draws)
        out = learn(state)
    elif system == "rec_iql":
        learn, _, _ = rec_iql.learner_setup(env, gen, cfg, cpu, draws=[draws["draws"]])
        out = learn(state)
    else:
        _, learn, _, _ = ff_isac.learner_setup(env, gen, cfg, cpu, centralised)
        out = learn(state, [draws["draws"]])
    return {
        "params": to_host(out.learner_state.params),
        "opt": to_host(getattr(out.learner_state, "opt_states", None)
                       or out.learner_state.opt_state),
        "train": {k: v.detach().clone() for k, v in out.train_metrics.items()},
        "state": out.learner_state._replace(key=None),
        "all_reduces": mesh_module.all_reduces,
    }


def seed_update(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One update of a stacked seed program on this rank's entries of a
    seed-sharded mesh (`spec["seed_shards"]` groups)."""
    from mava_tpu_torch import envs as tenvs
    from mava_tpu_torch.advanced_usage import (
        ff_ippo_vmap_seeds,
        ff_isac_vmap_seeds,
        rec_iql_vmap_seeds,
    )
    from mava_tpu_torch.parallel import make_seed_sharded_mesh
    from mava_tpu_torch.parallel import mesh as mesh_module

    cfg = _config(spec, world)
    mesh = make_seed_sharded_mesh(spec["seed_shards"])
    cfg.arch.n_devices = mesh.data_size
    env, _ = tenvs.make(cfg, "cpu")
    gen, cpu, num = torch.Generator().manual_seed(0), torch.device("cpu"), spec["num"]
    state = spec["state"]._replace(key=gen)
    draws = spec["draws"]
    if spec["system"] == "ff_ippo":
        learn, _, _ = ff_ippo_vmap_seeds.learner_setup(
            env, gen, cfg, cpu, num, mesh=mesh, **draws)
        out = learn(state)
    elif spec["system"] == "rec_iql":
        learn, _, _ = rec_iql_vmap_seeds.learner_setup(
            env, gen, cfg, cpu, num, draws=[draws["draws"]], mesh=mesh)
        out = learn(state)
    else:
        _, learn, _, _ = ff_isac_vmap_seeds.learner_setup(env, gen, cfg, cpu, num,
                                                                 mesh=mesh)
        out = learn(state, [draws["draws"]])
    return {
        "params": host_params(out.learner_state.params),
        "train": {k: v.detach().clone() for k, v in out.train_metrics.items()},
        "seed_group": mesh.seed_group,
        "all_reduces": mesh_module.all_reduces,
    }


def collectives(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The runtime's collectives on W ranks: the metrics gather, the replica
    check, the gradient mean, the per-rank streams, the checkpointer's shared
    directory and its gather of a learner state to rank 0 and split back."""
    import os

    from mava_tpu_torch.parallel import all_reduce_mean, make_mesh, put_replicated
    from mava_tpu_torch.parallel.distributed import gather_metrics
    from mava_tpu_torch.systems.anakin import eval_generator
    from mava_tpu_torch.systems.ppo.types import HiddenStates, OptStates, Params, RNNLearnerState
    from mava_tpu_torch.utils import checkpointing
    from mava_tpu_torch.utils.config import load_config

    mesh = make_mesh()
    out: Dict[str, Any] = {}
    out["gathered"] = gather_metrics({
        "episode_return": torch.arange(3.0) + 10 * rank, "steps_per_second": float(rank),
        "timestep": 64})
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    put_replicated(Params(net, net), mesh)
    with torch.no_grad():
        net.weight[0, 0] += rank
    try:
        put_replicated(Params(net, net), mesh)
        out["replica_check"] = "passed"
    except RuntimeError as e:
        out["replica_check"] = str(e)
    grads = (torch.full((2, 2), float(rank)), torch.tensor(float(rank * rank)))
    out["mean"] = all_reduce_mean(grads, mesh)
    cfg = load_config("default_rec_ippo", ["+arch.device=cpu"])
    out["eval_draws"] = torch.rand(4, generator=eval_generator(cfg, torch.device("cpu")))

    os.chdir(spec["cwd"])
    ckpt = checkpointing.Checkpointer(model_name="m")
    out["directory"] = ckpt.directory
    hidden = torch.full((2, 3), float(rank))
    state = RNNLearnerState(Params(net, net), OptStates(None, None),
                            torch.Generator().manual_seed(rank), None, None,
                            torch.tensor([rank, rank]), HiddenStates(hidden, hidden + 1))
    out["joined"] = checkpointing.gather_state(state, state._fields, mesh)
    box = [out["joined"]]  # rank 0's file, as every rank reads it on a restore
    torch.distributed.broadcast_object_list(box, src=0)
    out["split"] = checkpointing.split_state([box[0][f] for f in state._fields], state, mesh)
    return out


def store(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The recording program (`ff_ippo_store_experience.run_experiment`) in
    this rank's own working directory, its learner started from this rank's
    state and draws; what it logged at MISC and returned, and its gathers."""
    import os

    from mava_tpu_torch.advanced_usage import ff_ippo_store_experience
    from mava_tpu_torch.parallel import distributed
    from mava_tpu_torch.systems.ppo import ff_ippo
    from mava_tpu_torch.utils.config import load_config
    from mava_tpu_torch.utils.logger import LogEvent, MavaLogger

    setup, log, misc = ff_ippo.learner_setup, MavaLogger.log, []

    def started(*args, **kwargs):
        learn, actor, state = setup(*args, **kwargs, **spec["draws"])
        return learn, actor, spec["state"]._replace(key=state.key)

    def logged(self, metrics, t, t_eval, event):
        if event == LogEvent.MISC:
            misc.append(metrics["timestep"])
        return log(self, metrics, t, t_eval, event)

    ff_ippo.learner_setup, MavaLogger.log = started, logged
    os.chdir(spec["cwd"])
    cfg = load_config(spec["config"], list(spec["overrides"]) + ["+arch.device=cpu"])
    cfg.logger.system_name = "store_ranks"
    value = ff_ippo_store_experience.run_experiment(cfg)
    return {"value": value, "misc_timesteps": misc, "gathers": distributed.env_row_gathers}


def stagger(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """`ff_ippo_vmap_seeds.learner_setup` with `arch.stagger_resets` for each
    case of `spec["cases"]` (seed shards, sweep or seeds) on this rank's
    seed-sharded mesh: the env state and timestep it starts from, and, where
    the case holds this rank's params and draws, one update from there."""
    from mava_tpu_torch import envs as tenvs
    from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds
    from mava_tpu_torch.parallel import make_seed_sharded_mesh

    cfg = _config(spec, world)
    env, _ = tenvs.make(cfg, "cpu")
    out = []
    for case in spec["cases"]:
        mesh = make_seed_sharded_mesh(case["seed_shards"])
        cfg.arch.n_devices = mesh.data_size
        learn, _, state = ff_ippo_vmap_seeds.learner_setup(
            env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), spec["num"],
            sweep_lrs=case["sweep_lrs"], mesh=mesh, **case.get("draws", {}))
        result = {"start": (state.env_state, state.timestep)}
        if "params" in case:
            with torch.no_grad():
                for net, params in zip(state.params, case["params"]):
                    for name, value in params.items():
                        net.params[name].copy_(value)
            new = learn(state)
            result["params"] = host_params(new.learner_state.params)
            result["train"] = {k: v.detach().clone() for k, v in new.train_metrics.items()}
        out.append(result)
    return {"cases": out}


TASKS = {"update": update, "seed_update": seed_update, "collectives": collectives,
         "store": store, "stagger": stagger}


def main(task: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'group'}",
                            rank=rank, world_size=world)
    try:
        spec = torch.load(workdir / f"in_{rank}.pt", weights_only=False)
        out = TASKS[task](rank, world, spec)
        torch.save(out, workdir / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
