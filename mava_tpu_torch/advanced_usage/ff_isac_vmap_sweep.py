"""ff-ISAC with a learning-rate sweep: one stacked program trains one entry per
learning rate (port of `mava_tpu/advanced_usage/ff_isac_vmap_sweep.py`).

Entry i trains with `policy_lr = q_lr = sweep_lrs[i]` (alpha keeps
`system.alpha_lr`), held in its optimizers' state (`make_swept_adam`); the
entries share their init, env resets and draws, so they differ by their
learning rate alone (`ff_isac_vmap_seeds.learner_setup` with `sweep_lrs`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_isac_vmap_sweep \
    env=maswarm system.total_timesteps=200000 '+system.sweep_lrs=[1e-4, 3e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import ff_isac_vmap_seeds as _seeds
from mava_tpu_torch.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(config, centralised_critic, sweep_lrs=parse_sweep_lrs(config))


def main() -> float:
    cfg = load_config("default_ff_isac", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-ISAC vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
