"""ff-IPPO with a learning-rate sweep: one stacked program trains one entry per
learning rate (port of `mava_tpu/advanced_usage/ff_ippo_vmap_sweep.py`).

The entries share their init, env resets and draws, and each entry's peak
learning rate lives in its optimizer's state (`SweptClippedAdam`), so entry i
is the stock ff-IPPO learner at `sweep_lrs[i]` and the entries differ by their
learning rate alone (`ff_ippo_vmap_seeds.learner_setup` with `sweep_lrs`).

CLI: python -m mava_tpu_torch.advanced_usage.ff_ippo_vmap_sweep \
    env=rware env/scenario=tiny-2ag arch.num_envs=128 '+system.sweep_lrs=[1e-4, 2.5e-4, 5e-4, 1e-3]'
"""

from __future__ import annotations

import sys
from typing import List

from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds as _seeds
from mava_tpu_torch.utils.config import Config, load_config


def parse_sweep_lrs(config: Config) -> List[float]:
    """`system.sweep_lrs` as floats: a YAML list (whose bare `1e-4` items YAML
    reads as strings) or a comma string; by default four rates (reference :40)."""
    raw = config.system.get("sweep_lrs", [1e-4, 2.5e-4, 5e-4, 1e-3])
    if isinstance(raw, str):
        raw = raw.strip("[]").split(",")
    return [float(x) for x in raw]


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return _seeds.run_experiment(config, centralised_critic, sweep_lrs=parse_sweep_lrs(config))


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO vmap-lr-sweep experiment completed.")
    return performance


if __name__ == "__main__":
    main()
