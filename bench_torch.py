"""Throughput benchmark of the PyTorch port: env-steps/s for ff-IPPO on RWARE
tiny-2ag on one NVIDIA GPU.

    python3 bench_torch.py [--device cpu]

It times the program that `bench.py` times, through `mava_tpu_torch`:
`default_ff_ippo` with 512 envs and a rollout of 128, the whole training
update (rollout + critic pass + GAE + 4 PPO epochs), 4 updates a call, 3
warm-up calls, then 10 timed calls closed by `torch.cuda.synchronize()`.
"env-steps" counts only real training env steps. Prints ONE JSON line:
{"metric", "value", "unit", "device"}; `device` is the card's name and power
limit as `nvidia-smi` gives them. TF32 is off: every product is full fp32.
The timing loop is the one the port's tools share
(`mava_tpu_torch/scripts/common.py`).
"""

from __future__ import annotations

import argparse
import json

from mava_tpu_torch.scripts.common import (
    NUM_ENVS,
    ROLLOUT_LENGTH,
    TIMED_CALLS,
    UPDATES_PER_CALL,
    WARMUP_CALLS,
    device_label,
    env_steps_per_second,
)

METRIC = "torch_ff_ippo_rware_tiny2ag_env_steps_per_second"


def run(
    num_envs: int,
    rollout_length: int,
    updates_per_call: int,
    warmup_calls: int,
    timed_calls: int,
    device: str,
) -> float:
    """Env-steps/s of `timed_calls` learner calls of `updates_per_call` updates."""
    return env_steps_per_second(
        "default_ff_ippo",
        [f"arch.num_envs={num_envs}", f"system.rollout_length={rollout_length}"],
        device, updates_per_call, warmup_calls, timed_calls,
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sps = run(
        NUM_ENVS, ROLLOUT_LENGTH, UPDATES_PER_CALL, WARMUP_CALLS, TIMED_CALLS, args.device
    )
    print(json.dumps({
        "metric": METRIC,
        "value": round(sps, 1),
        "unit": "env-steps/s",
        "device": device_label(args.device),
    }))


if __name__ == "__main__":
    main()
