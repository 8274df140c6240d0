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
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

METRIC = "torch_ff_ippo_rware_tiny2ag_env_steps_per_second"
NUM_ENVS = 512
ROLLOUT_LENGTH = 128
UPDATES_PER_CALL = 4
TIMED_CALLS = 10
# The first calls pay for the allocator's growth and cuBLAS's set-up.
WARMUP_CALLS = 3


def run(
    num_envs: int,
    rollout_length: int,
    updates_per_call: int,
    warmup_calls: int,
    timed_calls: int,
    device: str,
) -> float:
    """Env-steps/s of `timed_calls` learner calls of `updates_per_call` updates."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.systems.ppo.ff_ippo import learner_setup
    from mava_tpu_torch.utils.config import load_config

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: CUDA is not available; this bench needs an NVIDIA GPU.")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = load_config(
        "default_ff_ippo",
        [
            f"arch.num_envs={num_envs}",
            f"system.rollout_length={rollout_length}",
            "logger.use_console=False",
        ],
    )
    cfg.arch.n_devices = 1
    cfg.system.num_updates = updates_per_call * (timed_calls + warmup_calls)
    cfg.system.num_updates_per_eval = updates_per_call

    def wait() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()

    env, _ = environments.make(cfg, device)
    generator = torch.Generator(device=device).manual_seed(0)
    learn, _, state = learner_setup(env, generator, cfg, device)

    for _ in range(warmup_calls):
        state = learn(state).learner_state
    wait()

    start = time.perf_counter()
    for _ in range(timed_calls):
        state = learn(state).learner_state
    wait()
    elapsed = time.perf_counter() - start
    return timed_calls * updates_per_call * rollout_length * num_envs / elapsed


def device_label(device: str) -> str:
    if torch.device(device).type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
