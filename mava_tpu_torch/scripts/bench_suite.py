"""Multi-config throughput suite of the port: env-steps/s of the whole training
update in five configs, one JSON line each (port of `scripts/bench_suite.py`).

    python -m mava_tpu_torch.scripts.bench_suite [config ...] [--device cpu]

Configs: ff_ippo_rware  ff_mappo_rware4  ff_mappo_lbf  rec_ippo_smax  rec_mappo_smax
(the reference's, with its overrides: 256 envs, or 64 with chunks of 16 on SMAX).
Each runs a rollout of 128, 4 updates a call, 3 warm-up and 3 timed calls of
the loop the port's tools share (`common.time_calls`), on the card unless
`--device cpu` asks for the CPU. A line is {"metric":
"torch_<config>_env_steps_per_second", "value", "unit", "device"}, `device` the
card's name and power limit. The rec configs run the GRU kernels: 17 K1 and 16
of each backward kernel (K2p, K2a, K2b and its sum) an update.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from mava_tpu_torch.scripts.common import device_label, env_steps_per_second

SMAX_3S5Z = ["env=smax", "env/scenario=3s5z", "network=rnn", "arch.num_envs=64",
             "system.recurrent_chunk_size=16"]
CONFIGS = {
    "ff_ippo_rware": ("default_ff_ippo",
                      ["env=rware", "env/scenario=tiny-2ag", "arch.num_envs=256"]),
    "ff_mappo_rware4": ("default_ff_mappo",
                        ["env=rware", "env/scenario=tiny-4ag", "arch.num_envs=256"]),
    "ff_mappo_lbf": ("default_ff_mappo",
                     ["env=lbf", "env/scenario=8x8-2p-2f-coop", "arch.num_envs=256"]),
    "rec_ippo_smax": ("default_rec_ippo", SMAX_3S5Z),
    "rec_mappo_smax": ("default_rec_mappo", SMAX_3S5Z),
}

ROLLOUT = 128
UPDATES_PER_CALL = 4
WARMUP_CALLS = 3
TIMED_CALLS = 3


def bench_one(name: str, device: str, overrides: Sequence[str] = (),
              updates_per_call: int = UPDATES_PER_CALL, warmup_calls: int = WARMUP_CALLS,
              timed_calls: int = TIMED_CALLS) -> dict:
    """Times config `name` (`overrides` after its own), prints its line and returns it."""
    default, config_overrides = CONFIGS[name]
    sps = env_steps_per_second(
        default, [*config_overrides, f"system.rollout_length={ROLLOUT}", *overrides], device,
        updates_per_call, warmup_calls, timed_calls)
    record = {"metric": f"torch_{name}_env_steps_per_second", "value": round(sps, 1),
              "unit": "env-steps/s", "device": device_label(device)}
    print(json.dumps(record), flush=True)
    return record


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("configs", nargs="*", help=" ".join(CONFIGS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        parser.error(f"no config {unknown}; the configs are {list(CONFIGS)}")
    for name in args.configs or CONFIGS:
        bench_one(name, args.device)


if __name__ == "__main__":
    main()
