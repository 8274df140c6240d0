"""rec-MAPPO over a stack of S seeds in one program: `rec_ippo_vmap_seeds` with
the centralised recurrent critic (port of
`mava_tpu/advanced_usage/rec_mappo_vmap_seeds.py`).

CLI: python -m mava_tpu_torch.advanced_usage.rec_mappo_vmap_seeds +system.num_seeds=4
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import rec_ippo_vmap_seeds
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> float:
    return rec_ippo_vmap_seeds.run_experiment(config, centralised_critic=True)


def main() -> float:
    cfg = load_config("default_rec_mappo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-MAPPO vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
