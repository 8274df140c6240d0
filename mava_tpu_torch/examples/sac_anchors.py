"""Read the logs of learning runs: the SAC and rec-IQL anchors and the MaSwarm
divergence.

    python -m mava_tpu_torch.examples.sac_anchors [PERF_maswarm_masac_logs.txt]
    python -m mava_tpu_torch.examples.sac_anchors PERF_rec_iql_logs.txt

A log is the console output of a SAC or rec-IQL CLI of either package
(`mava_tpu` or `mava_tpu_torch`; colour codes are dropped), or one section of a
logs file that holds several runs, each under a heading line `== <what ran>`.
Of each run it reads every round's mean Q (TRAINER line: SAC's `Q1 a vals`,
rec-IQL's `Mean q`), evaluation metric (EVALUATOR: the win rate where the line
logs one, else the mean return), env-step count and learn and evaluation
seconds (MISC), the absolute metric (ABSOLUTE, read as EVALUATOR), and a
stacked program's final return of each seed (its `final eval returns per
seed` line). A run diverges where a
round's logged Q (the mean over the round's train steps of the batch mean)
passes `DIVERGED` in absolute value: the rule for MaSwarm, whose Q values stay
within about [-20, 10] while its critics hold; on the articulated envs, whose
returns run to the hundreds, the same reading is only where |Q1| first passes
100. `main` prints one line a section.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

DIVERGED = 100.0  # |Q1| of a round past which a run counts as diverged

_ANSI = re.compile(r"\x1b\[[0-9;]*m")
_NUMBER = r"(-?[0-9.]+(?:e[-+]?[0-9]+)?|nan|-?inf)"


def _field(line: str, name: str) -> Optional[float]:
    found = re.search(re.escape(name) + r": " + _NUMBER, line)
    return None if found is None else float(found.group(1))


@dataclass
class Run:
    """What one run's log holds, round by round."""

    q1: List[float] = field(default_factory=list)
    evals: List[float] = field(default_factory=list)
    steps: List[int] = field(default_factory=list)  # env-steps at each round's end
    learn_s: float = 0.0
    eval_s: float = 0.0
    absolute: Optional[float] = None
    random: Optional[float] = None  # the first ACTOR line: the explore phase's return
    q_name: str = "Q1"  # SAC's Q1, or rec-IQL's Q
    per_seed: List[float] = field(default_factory=list)  # a stacked program's final returns

    def diverged(self) -> Optional[int]:
        """The env-step count of the first round whose |Q1| passes `DIVERGED`."""
        for i, q in enumerate(self.q1):
            if not abs(q) <= DIVERGED:  # NaN diverges too
                return self.steps[i] if i < len(self.steps) else -1
        return None

    def best(self) -> Tuple[float, int]:
        """The best evaluation's return and its env-step count."""
        i = max(range(len(self.evals)), key=lambda j: self.evals[j])
        return self.evals[i], self.steps[i] if i < len(self.steps) else -1

    def at_fifths(self) -> List[Tuple[int, float]]:
        """(env-steps, return) of the evaluations nearest 1/5 ... 5/5 of the run."""
        if not self.evals:
            return []
        n = len(self.evals)
        picks = sorted({max(0, round(n * k / 5) - 1) for k in range(1, 6)})
        return [(self.steps[i] if i < len(self.steps) else -1, self.evals[i]) for i in picks]

    def summary(self) -> str:
        if not self.evals:
            return "no evaluation logged"
        best, best_t = self.best()
        onset = self.diverged()
        text = (f"{len(self.evals)} rounds; absolute "
                + ("none" if self.absolute is None else f"{self.absolute:.3f}")
                + f"; best eval {best:.2f} ({best_t}), final {self.evals[-1]:.2f} "
                f"({self.steps[-1] if self.steps else -1}); "
                + (f"{self.q_name} within [{min(self.q1):.2f}, {max(self.q1):.2f}]; "
                   + (f"no round past |{self.q_name}| 100" if onset is None
                      else f"|{self.q_name}| past 100 from {onset}") if self.q1
                   else "no Q logged (an on-policy system)")
                + f"; learn {self.learn_s:.1f} s, eval {self.eval_s:.1f} s")
        return text


RETURN, WIN_RATE = "Episode return mean", "Win rate"


def metric_of(line: str) -> str:
    """What an EVALUATOR or ABSOLUTE line is read on: `WIN_RATE` where it logs
    one, else `RETURN`."""
    return WIN_RATE if WIN_RATE in line else RETURN


def read_log(lines: Iterable[str]) -> Run:
    """The `Run` of one log's lines."""
    run = Run()
    for raw in lines:
        line = _ANSI.sub("", raw)
        if line.startswith("TRAINER") and "Q1 a vals" in line:
            run.q1.append(_field(line, "Q1 a vals"))
        elif line.startswith("TRAINER") and "Mean q" in line:
            run.q1.append(_field(line, "Mean q"))
            run.q_name = "Q"
        elif line.startswith("EVALUATOR"):
            run.evals.append(_field(line, metric_of(line)))
        elif line.startswith("ABSOLUTE"):
            run.absolute = _field(line, metric_of(line))
        elif line.startswith("ACTOR") and run.random is None:
            run.random = _field(line, "Episode return mean")
        elif "final eval returns per seed:" in line:
            run.per_seed = [float(r) for r in line.split(":", 1)[1].split(",")]
        elif line.startswith("MISC") and "Timestep" in line:
            run.steps.append(int(_field(line, "Timestep")))
            run.learn_s += _field(line, "Time learn") or 0.0
            run.eval_s += _field(line, "Time eval") or 0.0
    return run


def read_sections(path: str) -> Dict[str, Run]:
    """{heading: its `Run`} of a logs file, one section a `== heading` line."""
    sections: Dict[str, List[str]] = {}
    current = None
    with open(path) as lines:
        for line in lines:
            if line.startswith("== "):
                current = line[3:].strip()
                sections[current] = []
            elif current is not None:
                sections[current].append(line)
    return {heading: read_log(lines) for heading, lines in sections.items()}


def main(path: str = "PERF_maswarm_masac_logs.txt") -> Dict[str, Run]:
    runs = read_sections(path)
    for heading, run in runs.items():
        print(f"{heading}: {run.summary()}")
    diverged = [h for h, r in runs.items() if r.diverged() is not None]
    print(f"{len(diverged)} of {len(runs)} runs pass |Q1| {DIVERGED:g} in some round")
    return runs


if __name__ == "__main__":
    main(*sys.argv[1:])
