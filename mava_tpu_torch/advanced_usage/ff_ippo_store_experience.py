"""ff-IPPO with experience recording for offline MARL (port of
`mava_tpu/advanced_usage/ff_ippo_store_experience.py`).

The stock ff-IPPO learner with `return_trajectories=True` returns the raw
`PPOTransition` batch of every update beside its output; each round's batch,
(updates, T, E, ...), is laid out batch-major as (E * updates, T, ...) slabs,
brought to the host and appended to a `Vault` under
`vaults/<logger.system_name>/<uid>` of the working directory (the OG-MARL
dataset pattern). `examples/bc_from_vault.py` reads such a vault back.

CLI: python -m mava_tpu_torch.advanced_usage.ff_ippo_store_experience \
    env=rware env/scenario=tiny-2ag system.total_timesteps=2000000
(on the card; add `+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import copy
import sys

import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch import envs as environments
from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.replay.vault import Vault
from mava_tpu_torch.systems.anakin import schedule_updates, start_experiment
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
    """Train ff-IPPO and store every update's transitions in a vault; returns
    the mean episode return of the last round's rollouts."""
    config = copy.deepcopy(_config)
    device = start_experiment(config)
    if config.arch.n_devices > 1:
        raise NotImplementedError(
            "ff_ippo_store_experience writes its vault from one process; run it without "
            "torch.distributed.run (ROADMAP.md Queue 1 item 5.3).")
    env, _ = environments.make(config, device)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    learn, _, learner_state = ff_ippo.learner_setup(env, generator, config, device,
                                                    return_trajectories=True)
    steps_per_rollout = (config.system.num_updates_per_eval * config.system.rollout_length
                         * config.arch.num_envs)
    logger = MavaLogger(config)
    vault = Vault(vault_name=config.logger.system_name)
    output = None
    for eval_step in range(config.arch.num_evaluation):
        timer = PhaseTimer(device)
        with timer.phase("learn"):
            output, trajectories = learn(learner_state)
        with timer.phase("vault"):
            vault.write(batch_major(trajectories))
        t = int(steps_per_rollout * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(output.episode_metrics)
        episode_metrics["steps_per_second"] = steps_per_rollout / sum(timer.phases.values())
        logger.log({"timestep": t, **timer.metrics()}, t, eval_step, LogEvent.MISC)
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(output.train_metrics, t, eval_step, LogEvent.TRAIN)
        learner_state = output.learner_state
    logger.stop()
    print(f"Experience stored in {vault.base_dir}")
    return float(output.episode_metrics["episode_return"].float().mean())


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    cfg.logger.system_name = "ff_ippo_store_experience"
    performance = run_experiment(cfg)
    print("ff-IPPO experience-recording run completed.")
    return performance


if __name__ == "__main__":
    main()
