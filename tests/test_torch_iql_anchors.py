"""The rec-IQL learning anchors of `chip_smoke.py --anchors` and the log
reader's win rate (`mava_tpu_torch.examples.sac_anchors`), on the CPU.

Each anchor's overrides are its reference job's: j170-j172 from their scripts
(`scripts/tpu_queue/r3/`), j976 from its log (78,125 updates of 64 envs, 40
evaluations, on 2s3z); its JAX absolute win rate and first evaluation are read
from the committed logs by the port's reader, and its rule closes 80 % of the
gap from a win rate of 0. One tiny rec-IQL CLI on SMAX goes through
`run_anchors` in a process of its own.

`iql_vmap_j908` is the stacked program under j908's overrides
(`scripts/tpu_queue/r5/`): the reader takes its JAX seeds' final returns from
the log's per-seed line, and a tiny stacked CLI goes through `run_anchors`,
ruled seed by seed. The eight-seed band (`iql_3s_vs_5z_band`) is driven once
at a tiny size on the CPU and its sections read back.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
from mava_tpu_torch.examples import sac_anchors

ROOT = Path(__file__).resolve().parents[1]
IQL = {name: anchor for name, anchor in chip_smoke.ANCHORS.items()
       if anchor.module == "rec_iql" and not anchor.seeds}
JOBS = {"iql_3s_vs_5z": "j170_rec_iql_3s_vs_5z", "iql_3s_vs_5z_seed7": "j171_rec_iql_3s_vs_5z_seed7",
        "iql_3s_vs_5z_seed123": "j172_rec_iql_3s_vs_5z_seed123"}
FIRST_EVAL = {"iql_3s_vs_5z": 0.0, "iql_3s_vs_5z_seed7": 0.0, "iql_3s_vs_5z_seed123": 0.0,
              "iql_2s3z": 21.875}


def log_of(anchor) -> Path:
    return ROOT / anchor.source.split("; ")[-1]


def test_four_anchors_and_their_rules():
    assert sorted(IQL) == sorted(FIRST_EVAL)
    rules = {name: round(anchor.rule, 2) for name, anchor in IQL.items()}
    assert rules == {"iql_3s_vs_5z": 79.75, "iql_2s3z": 73.0, "iql_3s_vs_5z_seed7": 79.5,
                     "iql_3s_vs_5z_seed123": 80.0}
    for anchor in IQL.values():
        assert (anchor.system, anchor.random, anchor.seeds) == ("q_learning", 0.0, 0)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_anchor_is_its_reference_job(name):
    anchor = IQL[name]
    job = ROOT / "scripts" / "tpu_queue" / "r3" / f"{JOBS[name]}.sh"
    lines = [line for line in job.read_text().splitlines() if not line.startswith("#")]
    command = "\n".join(lines).replace("\\\n", " ")
    module = re.search(r"python -m mava_tpu\.systems\.q_learning\.(\w+)", command).group(1)
    overrides = [w for w in command.split() if "=" in w and not w.startswith("logger.")]
    assert (anchor.module, list(anchor.overrides)) == (module, overrides)
    assert log_of(anchor).name == f"{JOBS[name]}.log"


def test_j976_anchor_is_its_log():
    """j976 has no script: its log says 78,125 updates and holds 40
    evaluations, which 10M env-steps of 64 envs and rollout 2 give; its
    scenario is 2s3z (BASELINE.md:59, 300)."""
    anchor = IQL["iql_2s3z"]
    text = log_of(anchor).read_text()
    assert "Setting num_updates = 78125 from total_timesteps = 10000000." in text
    overrides = dict(o.split("=") for o in anchor.overrides)
    rollout = 2  # default_rec_iql's system.rollout_length, which the anchor keeps
    assert int(overrides["system.total_timesteps"]) // (
        int(overrides["arch.num_envs"]) * rollout) == 78125
    run = sac_anchors.read_log(text.splitlines())
    assert len(run.evals) == int(overrides["arch.num_evaluation"]) == 40
    assert (overrides["env"], overrides["env/scenario"]) == ("smax", "2s3z")
    assert "2s3z" in (ROOT / "BASELINE.md").read_text().splitlines()[58]


@pytest.mark.parametrize("name", sorted(FIRST_EVAL))
def test_jax_absolute_and_first_evaluation_from_the_log(name):
    anchor = IQL[name]
    run = sac_anchors.read_log(log_of(anchor).read_text().splitlines())
    assert run.absolute == anchor.jax
    assert run.evals[0] == FIRST_EVAL[name]
    assert len(run.evals) == 40 and run.q_name == "Q"
    assert anchor.rule == pytest.approx(0.8 * run.absolute)


LOG = """Setting num_updates = 4 from total_timesteps = 32.
\x1b[36m\x1b[1mACTOR - Episode return mean: 5.711 | Steps per second: 744.202\x1b[0m
\x1b[35m\x1b[1mTRAINER - Mean q: 2.244 | Mean target: 2.245 | Q loss: 0.044\x1b[0m
\x1b[32m\x1b[1mEVALUATOR - Episode return mean: 7.669 | Win rate: 0.000\x1b[0m
\x1b[33m\x1b[1mMISC - Epsilon: 0.050 | Time eval: 3.958 | Time learn: 335.930 | Timestep: 16\x1b[0m
\x1b[35m\x1b[1mTRAINER - Mean q: 3.267 | Mean target: 3.267 | Q loss: 0.054\x1b[0m
\x1b[32m\x1b[1mEVALUATOR - Episode return mean: 11.950 | Win rate: 53.125\x1b[0m
\x1b[33m\x1b[1mMISC - Epsilon: 0.050 | Time eval: 0.044 | Time learn: 7.941 | Timestep: 32\x1b[0m
\x1b[34m\x1b[1mABSOLUTE - Episode return mean: 19.986 | Win rate: 99.688\x1b[0m
"""


def test_reader_reads_the_win_rate(tmp_path):
    wins = sac_anchors.read_log(LOG.splitlines())
    assert wins.evals == [0.0, 53.125] and wins.absolute == 99.688
    assert wins.q1 == [2.244, 3.267] and wins.q_name == "Q" and wins.steps == [16, 32]
    assert "Q within [2.24, 3.27]; no round past |Q| 100" in wins.summary()
    returns = sac_anchors.read_log(re.sub(r" \| Win rate: [0-9.]+", "", LOG).splitlines())
    assert returns.evals == [7.669, 11.95] and returns.absolute == 19.986
    path = tmp_path / "logs.txt"
    path.write_text("== port, H100, iql_3s_vs_5z\n" + LOG + "== SAC\n"
                    "EVALUATOR - Episode return mean: -1.0\nMISC - Timestep: 10\n")
    runs = sac_anchors.read_sections(str(path))
    assert runs["port, H100, iql_3s_vs_5z"].absolute == 99.688
    assert runs["SAC"].evals == [-1.0]


def test_run_anchors_runs_the_rec_iql_cli_and_reads_its_win_rate(capsys, monkeypatch, tmp_path):
    tiny = ("+arch.device=cpu", "env=smax", "env/scenario=3s_vs_5z", "+env.kwargs.time_limit=6",
            "arch.num_envs=2", "system.total_timesteps=16", "arch.num_evaluation=2",
            "arch.num_eval_episodes=2", "arch.num_absolute_metric_eval_episodes=2",
            "system.sample_batch_size=2", "system.sample_sequence_length=3",
            "network.hidden_state_dim=8", "network.q_network.pre_torso.layer_sizes=[8]",
            "network.q_network.post_torso.layer_sizes=[8]")
    anchors = {"tiny_iql": chip_smoke.Anchor("rec_iql", tiny, 0.0, -1.0, "none",
                                             system="q_learning")}
    monkeypatch.setattr(chip_smoke, "ANCHORS", anchors)
    assert chip_smoke.run_anchors(list(anchors), "CPU", tmp_path) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("anchor tiny_iql (") and " pass; 2 rounds; absolute " in out[0]
    assert "Q within" in out[0]
    log = (tmp_path / "tiny_iql.log").read_text()
    assert "ABSOLUTE" in log and "Win rate" in log and "IDQN experiment completed." in log


# ------------------------------------------------------------------ j908 and the band
J908 = chip_smoke.ANCHORS["iql_vmap_j908"]
J908_LOG = ROOT / "results" / "r5_queue" / "j908_rec_iql_2seed_vmap_2m.log"
TINY = ("env=smax", "env/scenario=3s_vs_5z", "+env.kwargs.time_limit=6",
        "arch.num_envs=2", "system.total_timesteps=16", "arch.num_evaluation=2",
        "arch.num_eval_episodes=2", "arch.num_absolute_metric_eval_episodes=2",
        "system.sample_batch_size=2", "system.sample_sequence_length=3",
        "network.hidden_state_dim=8", "network.q_network.pre_torso.layer_sizes=[8]",
        "network.q_network.post_torso.layer_sizes=[8]")


def test_j908_anchor_is_its_reference_job():
    job = ROOT / "scripts" / "tpu_queue" / "r5" / "j908_rec_iql_2seed_vmap_2m.sh"
    lines = [line for line in job.read_text().splitlines() if not line.startswith("#")]
    command = "\n".join(lines).replace("\\\n", " ")
    module = re.search(r"python -m mava_tpu\.advanced_usage\.(\w+)", command).group(1)
    overrides = [w for w in command.split() if "=" in w]
    assert (J908.module, list(J908.overrides)) == (module, overrides)
    assert J908.program == "mava_tpu_torch.advanced_usage.rec_iql_vmap_seeds"
    assert J908.source.split("; ")[-1] == str(J908_LOG.relative_to(ROOT))


def test_j908_jax_figures_from_its_log():
    """Each JAX seed's final return from the per-seed line, the last
    evaluation's mean, 20 evaluations, and 15,625 updates of 2 seeds."""
    text = J908_LOG.read_text()
    run = sac_anchors.read_log(text.splitlines())
    assert run.per_seed == list(J908.jax_seeds) == [17.15, 17.54]
    assert run.evals[-1] == J908.jax and run.evals[0] == 14.821 and len(run.evals) == 20
    assert "Setting num_updates = 15625 from total_timesteps = 2000000." in text
    assert J908.seed_rules == pytest.approx(
        [J908.random + 0.8 * (jax - J908.random) for jax in (17.15, 17.54)])
    assert 0 < J908.random < min(J908.jax_seeds)


def test_reader_reads_the_per_seed_line():
    run = sac_anchors.read_log(LOG.splitlines() + [
        "vmap-seeds final eval returns per seed: 17.15, -2.50, 3.00",
        "vmap-seeds final eval win rates per seed: 10.0%, 0.0%, 5.0%"])
    assert run.per_seed == [17.15, -2.5, 3.0] and run.absolute == 99.688
    assert sac_anchors.read_log(LOG.splitlines()).per_seed == []


def test_run_anchors_runs_the_stacked_cli_and_rules_each_seed(capsys, monkeypatch, tmp_path):
    anchors = {"tiny_j908": chip_smoke.Anchor(
        "rec_iql_vmap_seeds", ("+arch.device=cpu", *TINY, "+system.num_seeds=2"), -1.0, 99.0,
        "none", system="advanced_usage", jax_seeds=(-2.0, 99.0))}
    monkeypatch.setattr(chip_smoke, "ANCHORS", anchors)
    assert chip_smoke.run_anchors(list(anchors), "CPU", tmp_path) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("anchor tiny_j908 (") and "final returns " in out[0]
    assert "(rule >= -1.80: JAX -2) pass" in out[0] and "(rule >= 79.00: JAX 99) miss" in out[0]
    assert out[0].count(": miss;") == 1
    log = (tmp_path / "tiny_j908.log").read_text()
    assert "vmap-seeds final eval returns per seed:" in log
    assert "rec-IQL vmap-seeds experiment completed." in log


def test_band_anchor_and_its_stacked_run(capsys, tmp_path):
    """The band's rule, and a tiny band driven on the CPU: a section a seed,
    each with a round's TRAINER, EVALUATOR (win rate) and MISC lines and the
    ABSOLUTE line, which the reader takes."""
    band = chip_smoke.ANCHORS["iql_3s_vs_5z_band"]
    assert (band.module, band.seeds, band.need, round(band.rule, 2)) == ("rec_iql", 8, 7, 79.75)
    assert band.overrides == IQL["iql_3s_vs_5z"].overrides
    chip_smoke.iql_seed_band(chip_smoke.Anchor("rec_iql", TINY, 0.0, 99.0, "none", seeds=2,
                                               system="q_learning", need=1), "cpu")
    path = tmp_path / "band.log"
    path.write_text(capsys.readouterr().out)
    runs = sac_anchors.read_sections(str(path))
    assert sorted(runs) == ["port, stacked seed 1", "port, stacked seed 2"]
    for run in runs.values():
        assert len(run.evals) == 2 and run.steps == [8, 16] and run.q_name == "Q"
        assert run.absolute is not None and len(run.q1) == 2
