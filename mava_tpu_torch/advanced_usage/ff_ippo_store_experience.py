"""ff-IPPO with experience recording for offline MARL (port of
`mava_tpu/advanced_usage/ff_ippo_store_experience.py`).

The stock ff-IPPO learner with `return_trajectories=True` returns the raw
`PPOTransition` batch of every update beside its output; each round's batch,
(updates, T, E, ...), is laid out batch-major as (E * updates, T, ...) slabs,
brought to the host and appended to a `Vault` under
`vaults/<logger.system_name>/<uid>` of the working directory (the OG-MARL
dataset pattern). `examples/bc_from_vault.py` reads such a vault back.

Over W ranks (torchrun) each rank records its own `arch.num_envs` envs; every
round `gather_env_rows` brings every rank's batch to rank 0 in rank order
along the env axis (the reference's out spec `P(None, None, DATA_AXIS)`,
:78-85), so that rank 0's vault holds (W * E * updates, T, ...) slabs. Rank 0
alone creates and writes the vault; the step counts and the returned mean are
the global batch's (reference :92-97, :135-137).

CLI: python -m mava_tpu_torch.advanced_usage.ff_ippo_store_experience \
    env=rware env/scenario=tiny-2ag system.total_timesteps=2000000
(on the card; add `+arch.device=cpu` to run on the CPU; over N cards
`python -m torch.distributed.run --nproc-per-node=N -m ...`).
"""

from __future__ import annotations

import copy
import sys

import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.parallel import is_main_process, make_mesh
from mava_tpu_torch.parallel.distributed import gather_env_rows, gather_metrics
from mava_tpu_torch.replay.vault import Vault
from mava_tpu_torch.systems.anakin import schedule_updates, start_experiment, steps_per_round
from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.profiling import PhaseTimer


def batch_major(trajectories):
    """(updates, T, E, ...) -> (E * updates, T, ...) for every leaf, env-major
    (reference :115-121)."""
    return pytree.tree_map(
        lambda x: x.movedim(2, 0).reshape(x.shape[2] * x.shape[0], x.shape[1], *x.shape[3:]),
        trajectories)


def run_experiment(_config: Config) -> float:
    """Train ff-IPPO and store every update's transitions in a vault (rank 0's
    of the global batch); returns the mean episode return of the last round's
    rollouts over the global batch, on every rank."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)
    mesh = make_mesh()
    env, _ = environments.make(config, device)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, _, learner_state = ff_ippo.learner_setup(env, generator, config, device,
                                                    return_trajectories=True, mesh=mesh)
    steps_per_rollout = steps_per_round(config)
    logger = MavaLogger(config)
    vault = Vault(vault_name=config.logger.system_name) if is_main_process() else None
    output = None
    for eval_step in range(config.arch.num_evaluation):
        timer = PhaseTimer(device)
        with timer.phase("learn"):
            output, trajectories = learn(learner_state)
        with timer.phase("vault"):
            trajectories = gather_env_rows(trajectories, mesh)
            if vault is not None:
                vault.write(batch_major(trajectories))
        t = int(steps_per_rollout * (eval_step + 1))
        joined = gather_metrics(output.episode_metrics)
        episode_metrics, ep_completed = get_final_step_metrics(joined)
        episode_metrics["steps_per_second"] = steps_per_rollout / sum(timer.phases.values())
        logger.log({"timestep": t, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(output.train_metrics, t, eval_step, LogEvent.TRAIN)
        learner_state = output.learner_state
    logger.stop()
    if vault is not None:
        print(f"Experience stored in {vault.base_dir}")
    return float(torch.as_tensor(joined["episode_return"]).float().mean())


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    cfg.logger.system_name = "ff_ippo_store_experience"
    performance = run_experiment(cfg)
    print("ff-IPPO experience-recording run completed.")
    return performance


if __name__ == "__main__":
    main()
