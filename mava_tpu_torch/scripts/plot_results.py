"""Plot learning curves from the marl-eval JSON logs (`logger.use_json=True`)
(port of `scripts/plot_results.py`).

The reference ecosystem hands its JSON to the external marl-eval package for
aggregation plots; this is the in-tree consumer: it merges any number of
`metrics.json` files (the reference file structure, `utils/logger.py:JsonLogger`),
aggregates runs per (env, task, algorithm) across seeds, and writes one PNG per
task — mean curve per algorithm with a min/max band across seeds.

Usage:
    python -m mava_tpu_torch.scripts.plot_results results/json       # everything
    python -m mava_tpu_torch.scripts.plot_results results/json --metric win_rate
    python -m mava_tpu_torch.scripts.plot_results path/to/metrics.json --out results/plots

Chart conventions (dataviz method): single axis, change-over-time line form,
categorical color keyed to the ALGORITHM in a fixed slot order (stable across
figures — color follows the entity, never rank), recessive grid, legend only
when >=2 series. Palette: the validated reference categorical set (light mode).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

# Validated reference categorical palette (light surface), fixed slot order —
# all 8 slots so the 7 algorithm families never wrap onto a shared hue.
_PALETTE = [
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
    "#4a3aa7", "#e34948",
]
# Fixed algorithm -> slot assignment so ff_ippo is the same hue in every figure.
_ALG_SLOTS = [
    "ff_ippo", "ff_mappo", "rec_ippo", "rec_mappo", "rec_iql", "ff_isac",
    "ff_masac",
]
_TEXT = "#3d3d3a"


def _color_for(alg: str, fallback_idx: int) -> str:
    if alg in _ALG_SLOTS:
        return _PALETTE[_ALG_SLOTS.index(alg) % len(_PALETTE)]
    return _PALETTE[fallback_idx % len(_PALETTE)]


def collect(paths: List[str]) -> Dict:
    """env -> task -> algorithm -> list of (steps array, values array) per run."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files += [os.path.join(root, n) for n in names if n == "metrics.json"]
        else:
            files.append(p)

    data: Dict = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for f in sorted(files):
        with open(f) as fh:
            d = json.load(fh)
        for env_name, tasks in d.items():
            for task, algs in tasks.items():
                for alg, runs in algs.items():
                    for _run, steps in runs.items():
                        data[env_name][task][alg].append((f, steps))
    return data


def _series(steps_dict: Dict, metric: str):
    xs, ys = [], []
    for entry in steps_dict.values():
        if metric not in entry:
            continue
        v = entry[metric]
        xs.append(entry["step_count"])
        ys.append(float(np.mean(v)) if isinstance(v, list) else float(v))
    order = np.argsort(xs)
    return np.asarray(xs)[order], np.asarray(ys)[order]


def plot_task(env_name: str, task: str, algs: Dict, metric: str, out_dir: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 3.8))
    n_series = 0
    plotted = []
    _STYLES = ["-", "--", ":", "-."]
    for i, (alg, runs) in enumerate(sorted(algs.items())):
        curves = [_series(steps, metric) for _, steps in runs]
        curves = [(x, y) for x, y in curves if len(x)]
        if not curves:
            continue
        color = _color_for(alg, i)
        # Runs at different step budgets are NOT seeds of each other: band
        # only within a budget group; extra budgets get their own line style
        # (secondary encoding — the hue still follows the algorithm).
        groups: Dict[int, list] = defaultdict(list)
        for x, y in curves:
            groups[int(x[-1])].append((x, y))
        for j, budget in enumerate(sorted(groups)):
            grp = groups[budget]
            n_series += 1
            plotted.append((alg, len(grp)))
            base_x = grp[0][0]
            ys = np.stack([np.interp(base_x, x, y) for x, y in grp])
            label = f"{alg} ({len(ys)} runs)" if len(ys) > 1 else alg
            if len(groups) > 1:
                label += f" @{budget/1e6:g}M"
            ax.plot(
                base_x, ys.mean(axis=0), color=color, linewidth=2,
                linestyle=_STYLES[j % len(_STYLES)], label=label,
            )
            if len(ys) > 1:
                ax.fill_between(
                    base_x, ys.min(axis=0), ys.max(axis=0), color=color,
                    alpha=0.15, linewidth=0,
                )

    if not n_series:
        return ""
    ax.set_xlabel("env steps", color=_TEXT)
    ax.set_ylabel(metric.replace("_", " "), color=_TEXT)
    # A single series gets no legend box — the title names it instead.
    title = f"{env_name} / {task}"
    if n_series == 1:
        alg, n_runs = plotted[0]
        title += f" — {alg}" + (f" ({n_runs} seeds)" if n_runs > 1 else "")
    ax.set_title(title, color=_TEXT, fontsize=11)
    ax.grid(alpha=0.25, linewidth=0.5)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    ax.tick_params(colors=_TEXT)
    if n_series >= 2:
        ax.legend(frameon=False, fontsize=9)
    fig.tight_layout()

    os.makedirs(out_dir, exist_ok=True)
    safe = f"{env_name}_{task}_{metric}".replace("/", "-").replace(" ", "_")
    out = os.path.join(out_dir, f"{safe}.png")
    fig.savefig(out, dpi=140)
    plt.close(fig)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="metrics.json files or directories")
    ap.add_argument("--metric", default="mean_episode_return")
    ap.add_argument("--out", default="results/plots")
    args = ap.parse_args()

    data = collect(args.paths)
    wrote = []
    for env_name, tasks in data.items():
        for task, algs in tasks.items():
            out = plot_task(env_name, task, algs, args.metric, args.out)
            if out:
                wrote.append(out)
    if not wrote:
        raise SystemExit(
            f"no runs with metric '{args.metric}' found under {args.paths}"
        )
    for w in wrote:
        print(f"wrote {w}")


if __name__ == "__main__":
    main()
