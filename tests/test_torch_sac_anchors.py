"""The SAC learning anchors of `chip_smoke.py --anchors` and the log reader
`mava_tpu_torch.examples.sac_anchors`, on the CPU.

Every articulated anchor's overrides are its reference job's
(`scripts/tpu_queue/r3/j100-j122`), and its random and JAX returns are the
first ACTOR line and the ABSOLUTE line of that job's committed log, read by
the port's reader; its rule closes 80 % of the gap between them. The reader
takes a log of either package, and a section of a logs file; the divergence
rule (|Q1| > 100 in a round) is applied as written. One stock CLI run at a
tiny size goes through `run_anchors` in a process of its own.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
from mava_tpu_torch.examples import sac_anchors

ROOT = Path(__file__).resolve().parents[1]
ARTICULATED = [name for name, anchor in chip_smoke.ANCHORS.items()
               if anchor.source.startswith("results/r3_queue/j1")]


def test_twelve_articulated_anchors_and_the_maswarm_rows():
    assert len(ARTICULATED) == 12
    assert {"masac_maswarm_j200", "masac_maswarm_j200_band", "masac_mareacher",
            "isac_mareacher", "masac_maswarm"} <= set(chip_smoke.ANCHORS)
    assert chip_smoke.ANCHORS["masac_maswarm_j200_band"].seeds == 8
    assert round(chip_smoke.ANCHORS["masac_maswarm_j200"].rule, 1) == -137.3


@pytest.mark.parametrize("name", ARTICULATED)
def test_anchor_is_its_reference_job(name):
    anchor = chip_smoke.ANCHORS[name]
    job = ROOT / anchor.source.replace("results/r3_queue", "scripts/tpu_queue/r3").replace(
        ".log", ".sh")
    lines = [line for line in job.read_text().splitlines() if not line.startswith("#")]
    command = "\n".join(lines).replace("\\\n", " ")
    module = re.search(r"python -m mava_tpu\.systems\.sac\.(\w+)", command).group(1)
    overrides = [w for w in command.split() if "=" in w and not w.startswith("logger.")]
    assert (anchor.module, list(anchor.overrides)) == (module, overrides)
    run = sac_anchors.read_log((ROOT / anchor.source).read_text().splitlines())
    assert (anchor.random, anchor.jax) == (run.random, run.absolute)
    assert anchor.rule == pytest.approx(run.random + 0.8 * (run.absolute - run.random))
    assert len(run.evals) == int(anchor.overrides[-1].split("=")[1])  # arch.num_evaluation


LOG = """Setting num_updates = 30 from total_timesteps = 240.
\x1b[33m\x1b[1mMISC - Step: 40\x1b[0m
\x1b[36m\x1b[1mACTOR - Episode return mean: -31.751 | Steps per second: 10.0\x1b[0m
\x1b[35m\x1b[1mTRAINER - Actor loss: -0.481 | Q1 a vals: -0.106 | Q1 loss: 0.571\x1b[0m
\x1b[32m\x1b[1mEVALUATOR - Episode return mean: -28.510 | Episode return std: 2.236\x1b[0m
\x1b[33m\x1b[1mMISC - Time eval: 0.132 | Time learn: 0.782 | Timestep: 160\x1b[0m
\x1b[36m\x1b[1mACTOR - Episode return mean: -30.706\x1b[0m
\x1b[35m\x1b[1mTRAINER - Actor loss: -0.246 | Q1 a vals: 1.5e+03 | Q1 loss: 0.224\x1b[0m
\x1b[32m\x1b[1mEVALUATOR - Episode return mean: -33.003\x1b[0m
\x1b[33m\x1b[1mMISC - Time eval: 0.139 | Time learn: 0.766 | Timestep: 280\x1b[0m
\x1b[34m\x1b[1mABSOLUTE - Episode return mean: -34.641 | Episode return std: 12.923\x1b[0m
"""


def test_reader_takes_a_log_round_by_round(tmp_path):
    run = sac_anchors.read_log(LOG.splitlines())
    assert run.random == -31.751 and run.absolute == -34.641
    assert run.q1 == [-0.106, 1500.0] and run.evals == [-28.51, -33.003]
    assert run.steps == [160, 280]
    assert run.learn_s == pytest.approx(1.548) and run.eval_s == pytest.approx(0.271)
    assert run.diverged() == 280 and run.best() == (-28.51, 160)
    calm = sac_anchors.read_log(LOG.replace("1.5e+03", "-99.0").splitlines())
    assert calm.diverged() is None
    assert "|Q1| past 100 from 280" in run.summary() and "no round past" in calm.summary()
    path = tmp_path / "logs.txt"
    path.write_text("a preamble, read by no run\n== JAX package, CPU, seed 1\n" + LOG
                    + "== port, stacked seed 2\nTRAINER - Q1 a vals: nan\n"
                    "EVALUATOR - Episode return mean: -1.0\nMISC - Timestep: 10\n")
    runs = sac_anchors.read_sections(str(path))
    assert list(runs) == ["JAX package, CPU, seed 1", "port, stacked seed 2"]
    assert runs["JAX package, CPU, seed 1"].absolute == -34.641
    assert runs["port, stacked seed 2"].diverged() == 10  # NaN counts as diverged


def test_run_anchors_runs_the_stock_cli_and_reads_its_line(monkeypatch, capsys, tmp_path):
    tiny = ("+arch.device=cpu", "env.kwargs.time_limit=8", "system.explore_steps=16",
            "system.epochs=2", "system.policy_update_delay=2", "arch.num_eval_episodes=2",
            "arch.num_absolute_metric_eval_episodes=2", "system.total_timesteps=48",
            "arch.num_evaluation=2", "arch.num_envs=2",
            "network.actor_network.pre_torso.layer_sizes=[8]",
            "network.critic_network.pre_torso.layer_sizes=[8]")
    anchors = {"tiny_pass": chip_smoke.Anchor("ff_isac", tiny, -1e9, -1e9 + 1, "none"),
               "tiny_raises": chip_smoke.Anchor("ff_isac", tiny + ("system.epochs=x",), 0.0, 1.0,
                                                "none")}
    monkeypatch.setattr(chip_smoke, "ANCHORS", anchors)
    assert chip_smoke.run_anchors(list(anchors), "CPU", tmp_path) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("anchor tiny_pass (") and " pass; 2 rounds; absolute " in out[0]
    assert out[1].startswith("anchor tiny_raises (") and "FAILED, no absolute metric" in out[1]
    assert "ABSOLUTE" in (tmp_path / "tiny_pass.log").read_text()
