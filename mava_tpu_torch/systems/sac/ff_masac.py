"""Feed-forward Multi-Agent SAC (port of `mava_tpu/systems/sac/ff_masac.py`):
ff-ISAC whose twin critics read the global state and the joint action; the
actor loss puts each agent's fresh action into the replayed joint action.

CLI: python -m mava_tpu_torch.systems.sac.ff_masac [overrides]
(`+arch.device=cpu` to run on the CPU).
"""

from __future__ import annotations

import sys
from typing import Tuple

from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.types import ExperimentOutput
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config) -> Tuple[float, ExperimentOutput]:
    return ff_isac.run_experiment(config, centralised_critic=True)


def main() -> float:
    cfg = load_config("default_ff_masac", sys.argv[1:])
    performance, _ = run_experiment(cfg)
    print("MASAC experiment completed.")
    return performance


if __name__ == "__main__":
    main()
