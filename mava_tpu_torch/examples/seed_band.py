"""Hold the port to the JAX package over a band of seeds.

    python -m mava_tpu_torch.examples.seed_band [PERF_smax_1m_logs.txt]

Reads the log file of the rec-IPPO SMAX 3s5z runs at 1M env-steps (one section
`== <package>, <where>, ..., seed S` per run with its 20 EVALUATOR lines, or
one section for a stacked run of several seeds ending in its line "rec
vmap-seeds final eval win rates per seed: ..."), takes each seed's win rate
at the final evaluation, and tests whether the port (its runs on the GRU
kernels, stock and stacked) and the JAX package come from one distribution: a
two-sided Mann-Whitney U test on the win rates and a two-sided Fisher exact
test on the share at or above 45 %. The rule holds where both give p >= 0.05.
Runs of the plain GRU (`network.gru_impl=hoisted`) are listed, not tested.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List

THRESHOLD = 45.0  # win rate (%) that counts as the high mode
ALPHA = 0.05


def final_win_rates(path: str) -> Dict[str, List[float]]:
    """{section heading: the final evaluation's win rate of each of its seeds}."""
    runs: Dict[str, List[float]] = {}
    evals: Dict[str, List[float]] = {}
    section = None
    for line in open(path):
        if line.startswith("== "):
            section = line[3:].strip()
            runs[section], evals[section] = [], []
        elif section is None:
            continue
        elif line.startswith("EVALUATOR") and "Win rate:" in line:
            evals[section].append(float(re.search(r"Win rate: ([0-9.]+)", line).group(1)))
        elif "final eval win rates per seed:" in line:
            runs[section] = [float(x) for x in re.findall(r"([0-9.]+)%", line)]
    for section, rates in evals.items():
        if not runs[section] and rates:
            runs[section] = [rates[-1]]
    return runs


def group(section: str) -> str:
    if section.startswith("JAX package"):
        return "jax"
    if "plain GRU" in section:
        return "plain"
    return "port"


def main(path: str = "PERF_smax_1m_logs.txt") -> bool:
    from scipy import stats

    samples: Dict[str, List[float]] = {"port": [], "jax": [], "plain": []}
    for section, rates in final_win_rates(path).items():
        samples[group(section)].extend(rates)
        print(f"{group(section):5s} {', '.join(f'{r:.1f}' for r in rates):40s} {section}")
    port, jax = samples["port"], samples["jax"]
    high = [sum(r >= THRESHOLD for r in x) for x in (port, jax)]
    u = stats.mannwhitneyu(port, jax, alternative="two-sided")
    fisher = stats.fisher_exact([[high[0], len(port) - high[0]], [high[1], len(jax) - high[1]]])
    print(f"port: {len(port)} seeds, {high[0]} >= {THRESHOLD:g} %, median "
          f"{sorted(port)[len(port) // 2]:.1f}; JAX: {len(jax)} seeds, {high[1]} >= "
          f"{THRESHOLD:g} %, median {sorted(jax)[len(jax) // 2]:.1f}")
    print(f"Mann-Whitney U = {u.statistic:.1f}, p = {u.pvalue:.4f}; Fisher exact odds ratio "
          f"{fisher.statistic:.3f}, p = {fisher.pvalue:.4f}")
    holds = u.pvalue >= ALPHA and fisher.pvalue >= ALPHA
    print("one distribution (both p >= 0.05): " + ("holds" if holds else "fails"))
    return holds


if __name__ == "__main__":
    main(*sys.argv[1:])
