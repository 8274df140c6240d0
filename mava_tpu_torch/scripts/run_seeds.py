"""Run a system config across several seeds and print a result-per-seed table
(port of `scripts/run_seeds.py`).

Usage:
  python -m mava_tpu_torch.scripts.run_seeds <module> <default> [seeds] [override ...]
  python -m mava_tpu_torch.scripts.run_seeds ppo.rec_mappo default_rec_mappo 42,7,123 \\
      env=smax env/scenario=3s5z arch.num_envs=64 system.recurrent_chunk_size=16 \\
      system.total_timesteps=10000000

`<module>` is relative to `mava_tpu_torch.systems` (`ppo.ff_ippo`,
`q_learning.rec_iql`, `sac.ff_masac`, ...); the seeds default to 42, 7 and 123.
Each seed runs the full experiment through the system's `run_experiment`
(the absolute metric included when enabled), on the card unless an override
says `+arch.device=cpu`. It prints one `seed=...: <eval_metric>=...` line per
seed, then `mean=... std=... over N seeds`.
"""

from __future__ import annotations

import importlib
import statistics
import sys
from typing import List, Optional, Sequence

from mava_tpu_torch.utils.config import load_config

DEFAULT_SEEDS = (42, 7, 123)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__)
        raise SystemExit(1)
    module_name, default = argv[0], argv[1]
    try:
        seeds = [int(s) for s in argv[2].split(",")]
        overrides = argv[3:]
    except (IndexError, ValueError):
        # The seeds argument left out: everything from argv[2] on is an override.
        seeds = list(DEFAULT_SEEDS)
        overrides = argv[2:]

    module = importlib.import_module(f"mava_tpu_torch.systems.{module_name}")
    results = []
    for seed in seeds:
        cfg = load_config(default, overrides + [f"system.seed={seed}"])
        performance, _ = module.run_experiment(cfg)
        results.append(performance)
        print(f"seed={seed}: {cfg.env.eval_metric}={performance:.4f}", flush=True)

    mean = statistics.mean(results)
    std = statistics.stdev(results) if len(results) > 1 else 0.0
    print(f"mean={mean:.4f} std={std:.4f} over {len(results)} seeds", flush=True)
    return results


if __name__ == "__main__":
    main()
