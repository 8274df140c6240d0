"""rec-IQL with a learning-rate sweep: one stacked program trains one entry per
`q_lr` (port of `mava_tpu/advanced_usage/rec_iql_vmap_sweep.py`).

The entries share their init, env resets and draws, and each entry's learning
rate lives in its optimizer's state (`make_swept_adam`, eps 1e-5), so entry i
is the stock rec-IQL learner at `q_lr = sweep_lrs[i]`
(`rec_iql_vmap_seeds.learner_setup` with `sweep_lrs`).

CLI: python -m mava_tpu_torch.advanced_usage.rec_iql_vmap_sweep \
    env=smax env/scenario=3s5z '+system.sweep_lrs=[1e-4, 3e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import rec_iql_vmap_seeds as _seeds
from mava_tpu_torch.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return _seeds.run_experiment(config, sweep_lrs=parse_sweep_lrs(config))


def main() -> float:
    cfg = load_config("default_rec_iql", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IQL vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
