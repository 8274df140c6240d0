"""Feed-forward Multi-Agent PPO (ff-MAPPO): ff-IPPO with a centralised critic
(port of `mava_tpu/systems/ppo/ff_mappo.py`). The critic reads the global
state, and the env factory attaches one.

CLI: python -m mava_tpu_torch.systems.ppo.ff_mappo [overrides].
"""

from __future__ import annotations

import sys
from typing import Tuple

from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> Tuple[float, ExperimentOutput]:
    return ff_ippo.run_experiment(config, centralised_critic=True)


def main() -> float:
    cfg = load_config("default_ff_mappo", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("ff-MAPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
