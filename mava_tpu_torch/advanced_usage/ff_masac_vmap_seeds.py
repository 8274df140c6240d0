"""ff-MASAC over a stack of seeds in one program: `ff_isac_vmap_seeds` with the
centralised critics on the global state and the joint action (port of
`mava_tpu/advanced_usage/ff_masac_vmap_seeds.py`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_masac_vmap_seeds +system.num_seeds=4
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage.ff_isac_vmap_seeds import run_experiment
from mava_tpu_torch.utils.config import load_config


def main() -> float:
    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance = run_experiment(cfg, centralised_critic=True)
    print("ff-MASAC vmap-seeds experiment completed.")
    return performance


if __name__ == "__main__":
    main()
