"""The headline bench's in-process band: `bench_torch.py`'s measurement repeated
R times in one process (port of `scripts/bench_band.py`).

    python -m mava_tpu_torch.scripts.bench_band [repeats] [--device cpu]

`bench_torch.py` prints one reading a process, and readings spread from call
to call more than any kernel's share of an update (PERF.md §7). This builds
the headline learner once (ff-IPPO on RWARE tiny-2ag, 512 envs, rollout 128, 4
updates a call), runs its 3 warm-up calls, then times its 10 calls R times in
turn (R = 3 by default) with the loop the port's tools share, and prints one
JSON line: {"metric", "repeats": [...], "min", "median", "max", "unit",
"device"}, `device` the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Optional, Sequence

from mava_tpu_torch.scripts.common import (
    NUM_ENVS,
    ROLLOUT_LENGTH,
    TIMED_CALLS,
    UPDATES_PER_CALL,
    WARMUP_CALLS,
    device_label,
    next_learner_state,
    ppo_learner,
    time_calls,
)


def band(repeats: int, device: str, num_envs: int = NUM_ENVS,
         rollout_length: int = ROLLOUT_LENGTH, updates_per_call: int = UPDATES_PER_CALL,
         warmup_calls: int = WARMUP_CALLS, timed_calls: int = TIMED_CALLS) -> dict:
    """Env-steps/s of `repeats` runs of `timed_calls` calls of one learner."""
    learn, state, steps = ppo_learner(
        "default_ff_ippo", [f"arch.num_envs={num_envs}", f"system.rollout_length={rollout_length}"],
        device, updates_per_call, warmup_calls + repeats * timed_calls)
    call = next_learner_state(learn)
    rates = []
    for r in range(repeats):
        seconds, state = time_calls(call, state, warmup_calls if r == 0 else 0, timed_calls, device)
        rates.append(round(timed_calls * steps / seconds, 1))
        print(f"repeat {r}: {rates[-1]:,.1f} env-steps/s", flush=True)
    return {"metric": "torch_bench_band_ff_ippo_rware_tiny2ag", "repeats": rates,
            "min": min(rates), "median": statistics.median(rates), "max": max(rates),
            "unit": "env-steps/s", "device": device_label(device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("repeats", nargs="?", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    record = band(args.repeats, args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
