"""rec-IPPO with a learning-rate sweep: one stacked recurrent program trains one
entry per learning rate, the entry axis on the GRU hidden states too, every
BPTT pass through the stacked GRU kernels (port of
`mava_tpu/advanced_usage/rec_ippo_vmap_sweep.py`). The entries share their
init, env resets and draws.

CLI: python -m mava_tpu_torch.advanced_usage.rec_ippo_vmap_sweep \
    env=smax env/scenario=3s5z arch.num_envs=64 '+system.sweep_lrs=[1e-4, 2.5e-4, 5e-4]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import rec_ippo_vmap_seeds as _seeds
from mava_tpu_torch.advanced_usage.ff_ippo_vmap_sweep import parse_sweep_lrs
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(config, centralised_critic, sweep_lrs=parse_sweep_lrs(config))


def main() -> float:
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
