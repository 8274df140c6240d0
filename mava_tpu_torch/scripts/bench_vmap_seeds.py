"""S seeds in one stacked learner against S runs in turn (port of
`scripts/bench_vmap_seeds.py`).

    python -m mava_tpu_torch.scripts.bench_vmap_seeds [num_seeds ...] [--device cpu]

Times the stock ff-IPPO learner call and the S-seed call of
`advanced_usage/ff_ippo_vmap_seeds` (one stacked learner: parameters with a
leading seed axis, the envs one batch of S x 128 rows) on the same config,
RWARE tiny-2ag at 128 envs a seed, rollout 128, 4 updates a call: one warm-up
call, then 5 timed calls of each, in one process, with the loop the port's
tools share. S = 2, 4 and 8 by default. Prints one JSON line for the stock
learner ({"config", "ms_per_call", "env_steps_per_second", "device"}) and one
for each S ({"config", "ms_per_call", "env_steps_per_second_all_seeds",
"cost_vs_1_seed", "speedup_vs_sequential", "device"}): `cost_vs_1_seed` is a
stacked call's time over a stock call's, `speedup_vs_sequential` S stock
calls' time over a stacked call's.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds
from mava_tpu_torch.scripts.common import (
    bench_config,
    device_label,
    next_learner_state,
    ppo_learner,
    time_calls,
)

NUM_ENVS = 128
ROLLOUT = 128
UPDATES_PER_CALL = 4
WARMUP_CALLS = 1
TIMED_CALLS = 5
OVERRIDES = ["env=rware", "env/scenario=tiny-2ag"]


def compare(seed_counts: Sequence[int], device: str, num_envs: int = NUM_ENVS,
            rollout: int = ROLLOUT, updates_per_call: int = UPDATES_PER_CALL,
            warmup_calls: int = WARMUP_CALLS, timed_calls: int = TIMED_CALLS) -> List[dict]:
    """The stock line, then one line for each S of `seed_counts`; each printed."""
    overrides = [*OVERRIDES, f"arch.num_envs={num_envs}", f"system.rollout_length={rollout}"]
    calls = warmup_calls + timed_calls
    learn, state, steps = ppo_learner("default_ff_ippo", overrides, device, updates_per_call,
                                      calls)
    label = device_label(device)
    seconds, _ = time_calls(next_learner_state(learn), state, warmup_calls, timed_calls, device)
    t1 = seconds / timed_calls
    lines = [{"config": "1 seed (stock)", "ms_per_call": round(t1 * 1e3, 2),
              "env_steps_per_second": round(steps / t1), "device": label}]
    print(json.dumps(lines[-1]), flush=True)

    for num_seeds in seed_counts:
        config, dev = bench_config("default_ff_ippo", overrides, device)
        config.system.num_updates = updates_per_call * calls
        config.system.num_updates_per_eval = updates_per_call
        env, _ = environments.make(config, dev)
        generator = torch.Generator(device=dev).manual_seed(0)
        learn, _, state = ff_ippo_vmap_seeds.learner_setup(env, generator, config, dev, num_seeds)
        seconds, _ = time_calls(next_learner_state(learn), state, warmup_calls, timed_calls,
                                device)
        t_s = seconds / timed_calls
        lines.append({
            "config": f"{num_seeds} seeds (vmap)", "ms_per_call": round(t_s * 1e3, 2),
            "env_steps_per_second_all_seeds": round(num_seeds * steps / t_s),
            "cost_vs_1_seed": round(t_s / t1, 3),
            "speedup_vs_sequential": round(num_seeds * t1 / t_s, 2), "device": label,
        })
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_seeds", nargs="*", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return compare(args.num_seeds or [2, 4, 8], args.device)


if __name__ == "__main__":
    main()
