"""Throughput against the number of vectorised envs: the reference's speed-plot
protocol on the port (port of `scripts/bench_envs_sweep.py`).

    python -m mava_tpu_torch.scripts.bench_envs_sweep [timed_calls] [--device cpu]

ff-IPPO on RWARE tiny-2ag (`default_ff_ippo`), the whole training update, at
16, 64, 256, 512, 1,024 and 2,048 envs, one process for every point: a fresh
learner a point, 4 updates a call, 3 warm-up calls, then `timed_calls` (10 by
default) with the loop the port's tools share. One JSON line a point: {"metric",
"num_envs", "value", "unit", "device"}, `device` the card's name and power
limit; then, where matplotlib imports, the curve in
`results/plots/sps_vs_envs_torch.png` in the repo's chart style
(`scripts/plot_results.py`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

from mava_tpu_torch.scripts.common import device_label, env_steps_per_second

ENV_COUNTS = (16, 64, 256, 512, 1024, 2048)
ROLLOUT = 128
UPDATES_PER_CALL = 4
WARMUPS = 3
PLOT = os.path.join("results", "plots", "sps_vs_envs_torch.png")


def sweep(env_counts: Sequence[int], timed_calls: int, device: str,
          updates_per_call: int = UPDATES_PER_CALL, warmup_calls: int = WARMUPS,
          rollout: int = ROLLOUT) -> List[Tuple[int, float]]:
    """(num_envs, env-steps/s) of each point; prints each point's line."""
    points = []
    for num_envs in env_counts:
        sps = env_steps_per_second(
            "default_ff_ippo", [f"arch.num_envs={num_envs}", f"system.rollout_length={rollout}"],
            device, updates_per_call, warmup_calls, timed_calls)
        points.append((num_envs, sps))
        print(json.dumps({"metric": "torch_ff_ippo_sps_vs_envs", "num_envs": num_envs,
                          "value": round(sps, 1), "unit": "env-steps/s",
                          "device": device_label(device)}), flush=True)
    return points


def plot(points: Sequence[Tuple[int, float]], label: str, out_path: str = PLOT) -> None:
    try:
        import matplotlib
    except ImportError as e:
        print(f"plot skipped: {e}", flush=True)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=120)
    xs, ys = zip(*points)
    ax.plot(xs, ys, color="#E8A33D", linewidth=2.25, marker="o")
    ax.set_xscale("log", base=2)
    ax.set_xticks(xs)
    ax.set_xticklabels([str(x) for x in xs])
    ax.set_xlabel("vectorised envs")
    ax.set_ylabel("env-steps / s")
    ax.set_title(f"ff-IPPO RWARE tiny-2ag, PyTorch port: whole training update ({label})")
    ax.grid(True, color="#E3E1DC", linewidth=0.8)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    print(f"wrote {out_path}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[int, float]]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("timed_calls", nargs="?", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    points = sweep(ENV_COUNTS, args.timed_calls, args.device)
    plot(points, device_label(args.device))
    return points


if __name__ == "__main__":
    main()
