"""Recurrent Multi-Agent PPO (rec-MAPPO): rec-IPPO with a centralised recurrent
critic (port of `mava_tpu/systems/ppo/rec_mappo.py`). The critic reads the
global state, and the env factory attaches one; every BPTT pass goes through
the same GRU kernels as rec-IPPO's.

CLI: python -m mava_tpu_torch.systems.ppo.rec_mappo [overrides].
"""

from __future__ import annotations

import sys
from typing import Tuple

from mava_tpu_torch.systems.ppo import rec_ippo
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> Tuple[float, ExperimentOutput]:
    return rec_ippo.run_experiment(config, centralised_critic=True)


def main() -> float:
    cfg = load_config("default_rec_mappo", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("Recurrent MAPPO experiment completed.")
    return performance


if __name__ == "__main__":
    main()
