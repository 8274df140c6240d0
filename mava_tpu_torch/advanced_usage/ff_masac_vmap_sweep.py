"""ff-MASAC with a learning-rate sweep in one stacked program:
`ff_isac_vmap_sweep` with the centralised critics (port of
`mava_tpu/advanced_usage/ff_masac_vmap_sweep.py`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_masac_vmap_sweep '+system.sweep_lrs=[1e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage.ff_isac_vmap_sweep import run_experiment
from mava_tpu_torch.utils.config import load_config


def main() -> float:
    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance = run_experiment(cfg, centralised_critic=True)
    print("ff-MASAC vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
