"""The port's quickstart: train ff-IPPO to solve Level-Based Foraging in one
command (port of `examples/quickstart.py`).

Every piece that the reference's Quickstart notebook builds by hand is a
tested module of the port:

* networks   -> `mava_tpu_torch/networks/` (torsos, heads, FeedForwardActor / ValueNet)
* learner    -> `mava_tpu_torch/systems/ppo/ff_ippo.py::get_learner_fn`
                (rollout -> one critic pass -> GAE -> minibatched PPO epochs)
* the card   -> `mava_tpu_torch/systems/anakin.py::start_experiment` (the device,
                fp32 products; under torchrun the process group, `parallel/`)
* evaluation -> `mava_tpu_torch/evaluator.py` (greedy eval episodes, return table)
* config     -> the YAML tree of `mava_tpu/configs/`, read by `utils/config.py`
                (composable groups, CLI overrides)

Run it on the card (defaults: LBF 2s-8x8-2p-2f-coop, 2M env-steps, 128 envs,
10 evaluations):

    python -m mava_tpu_torch.examples.quickstart

or on the CPU, when asked:

    python -m mava_tpu_torch.examples.quickstart +arch.device=cpu

Every config key is overridable as in the training CLIs; the overrides come
after the defaults, e.g. RWARE on a harder 4-agent map:

    python -m mava_tpu_torch.examples.quickstart env=rware env/scenario=tiny-4ag \\
        system.total_timesteps=5000000

The console prints the eval table as training goes; `main()` returns the final
evaluation's episode return.
"""

from __future__ import annotations

import sys

from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.utils.config import load_config

QUICKSTART_DEFAULTS = [
    "env=lbf",
    "env/scenario=2s-8x8-2p-2f-coop",
    "system.total_timesteps=2000000",
    "arch.num_envs=128",
    "arch.num_evaluation=10",
    "logger.use_console=True",
]


def main() -> float:
    # CLI overrides come after the quickstart's defaults, so anything can be
    # changed: algorithm keys, the env's scenario, the eval cadence, the device.
    cfg = load_config("default_ff_ippo", QUICKSTART_DEFAULTS + sys.argv[1:])

    print(
        f"Training ff-IPPO on {cfg.env.env_name} {cfg.env.scenario.task_name} "
        f"for {int(cfg.system.total_timesteps):,} env steps "
        f"({cfg.arch.num_envs} vectorised envs)...",
        flush=True,
    )
    # `run_experiment` starts the device (and, under torchrun, the process
    # group) itself; it returns (evaluation performance, last learner output).
    final_eval_return, _ = ff_ippo.run_experiment(cfg)
    print(f"Final evaluation episode return: {final_eval_return:.2f}", flush=True)
    return final_eval_return


if __name__ == "__main__":
    main()
