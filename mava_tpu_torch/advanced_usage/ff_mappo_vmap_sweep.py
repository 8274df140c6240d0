"""ff-MAPPO with a learning-rate sweep in one stacked program: `ff_ippo_vmap_sweep`
with the centralised critic (port of `mava_tpu/advanced_usage/ff_mappo_vmap_sweep.py`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_mappo_vmap_sweep '+system.sweep_lrs=[1e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import ff_ippo_vmap_sweep
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return ff_ippo_vmap_sweep.run_experiment(config, centralised_critic=True)


def main() -> float:
    cfg = load_config("default_ff_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-MAPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
