"""The port's tools in `mava_tpu_torch/scripts/` on the CPU at tiny sizes, each
asked for the CPU (`--device cpu`, `+arch.device=cpu`): `run_seeds` against
`run_experiment` seed by seed; the lines of `bench_suite`, `bench_band`,
`bench_envs_sweep`, `bench_vmap_seeds` and `bench_mfu`; `bench_mfu`'s counts
against a hand reckoning; the one timing loop; and the port's marl-eval JSON
through the unchanged `scripts/plot_results.py`.

How the GRU kernels' FLOPs are checked here, where no kernel runs: on CPU
tensors the op takes its plain versions and launches nothing, so
`count_launches_as_the_card` wraps the op's entry points and counts, for each
call, the launches that its CUDA branch makes (`ops/gru.py`: one K1 a forward;
K2p on the resident route, K2a, K2b's two kernels a backward; the stacked ones
the same with the stack), by kernel and shape, into the op's own counters.
`bench_mfu`'s GRU FLOPs must then equal those launches times `kernel_work`,
and the launches per update those that `chip_smoke.py` holds the card to."""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench_torch
from mava_tpu_torch.envs.render import unwrap_env
from mava_tpu_torch.envs.wrappers import obs_shape
from mava_tpu_torch.ops import gru
from mava_tpu_torch.scripts import (
    bench_band,
    bench_envs_sweep,
    bench_mfu,
    bench_suite,
    bench_vmap_seeds,
    common,
    run_seeds,
)
from mava_tpu_torch.systems.ppo import ff_ippo
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PPO_TINY = ["system.rollout_length=4", "system.ppo_epochs=1", "system.num_minibatches=1"]
TINY = {
    "ff_ippo_rware": ["arch.num_envs=2", *PPO_TINY],
    "ff_mappo_rware4": ["arch.num_envs=2", *PPO_TINY],
    "ff_mappo_lbf": ["arch.num_envs=2", *PPO_TINY],
    "rec_ippo_smax": ["arch.num_envs=2", "system.recurrent_chunk_size=2",
                      "network.hidden_state_dim=16", *PPO_TINY],
    "rec_mappo_smax": ["arch.num_envs=2", "system.recurrent_chunk_size=2",
                       "network.hidden_state_dim=16", *PPO_TINY],
    "ff_ippo_cleaner_cnn": ["arch.num_envs=2", *PPO_TINY],
    "rec_iql_smax": ["arch.num_envs=2", "system.sample_batch_size=4",
                     "network.hidden_state_dim=16", "system.sample_sequence_length=6"],
    "ff_isac_maswarm": ["arch.num_envs=2", "system.explore_steps=40", "system.epochs=2",
                        "system.buffer_size=512"],
}
MATRAX = ["env=matrax", "env.scenario.task_name=Penalty-25-stateless-v0",
          "env.kwargs.time_limit=10",
          "system.num_updates=2", "arch.num_evaluation=1", "system.rollout_length=4",
          "arch.num_envs=2", "arch.num_eval_episodes=4", "arch.absolute_metric=False",
          "logger.use_console=False", "+arch.device=cpu"]
MFU_FIELDS = {"config", "env_steps_per_second", "step_ms", "matmul_flops_per_call",
              "gru_kernel_flops_per_call", "gru_launches_per_call", "achieved_tflops",
              "mfu_vs_fp32_peak", "device_busy_ms", "device_busy_share", "device"}


def lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


# ------------------------------------------------------------------ run_seeds
def test_run_seeds_equals_run_experiment_seed_by_seed(capsys):
    results = run_seeds.main(["ppo.ff_ippo", "default_ff_ippo", "3,11", *MATRAX])
    out = capsys.readouterr().out.splitlines()
    want = [ff_ippo.run_experiment(load_config("default_ff_ippo", MATRAX + [f"system.seed={s}"]))[0]
            for s in (3, 11)]
    assert results == want
    table = [x for x in out if x.startswith(("seed=", "mean="))]
    assert table[:2] == [f"seed={s}: episode_return={r:.4f}" for s, r in zip((3, 11), want)]
    mean = sum(want) / 2
    std = (sum((r - mean) ** 2 for r in want) / 1) ** 0.5
    assert table[2] == f"mean={mean:.4f} std={std:.4f} over 2 seeds"


def test_run_seeds_defaults_and_usage(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(ff_ippo, "run_experiment",
                        lambda cfg: (seen.append(cfg.system.seed), (1.0, None))[1])
    run_seeds.main(["ppo.ff_ippo", "default_ff_ippo", *MATRAX])
    assert seen == [42, 7, 123]
    assert capsys.readouterr().out.splitlines()[-1] == "mean=1.0000 std=0.0000 over 3 seeds"
    with pytest.raises(SystemExit):
        run_seeds.main(["ppo.ff_ippo"])


# ------------------------------------------------------------------ the timing loop
def test_every_bench_times_with_the_one_loop(monkeypatch):
    calls = []
    real = common.time_calls
    monkeypatch.setattr(common, "time_calls", lambda *a: (calls.append(a[2:4]), real(*a))[1])
    assert bench_torch.run(2, 4, 1, 1, 2, "cpu") > 0
    assert calls == [(1, 2)]


@pytest.mark.parametrize("main", [
    lambda: bench_suite.main(["rec_mappo_smax"]),
    lambda: bench_band.main(["2"]),
    lambda: bench_envs_sweep.main([]),
    lambda: bench_vmap_seeds.main(["2"]),
    lambda: bench_mfu.main(["rec_iql_smax"]),
    lambda: run_seeds.main(["ppo.ff_ippo", "default_ff_ippo", "1,2", *MATRAX[:-1]]),
], ids=["bench_suite", "bench_band", "bench_envs_sweep", "bench_vmap_seeds", "bench_mfu",
        "run_seeds"])
def test_tools_need_the_card_unless_asked_otherwise(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available; pass \\+arch.device=cpu"):
        main()
    assert not [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


# ------------------------------------------------------------------ the benches' lines
@pytest.mark.parametrize("name", list(bench_suite.CONFIGS))
def test_bench_suite_line(name, capsys):
    bench_suite.bench_one(name, "cpu", TINY[name], updates_per_call=1, warmup_calls=1,
                          timed_calls=1)
    (record,) = lines(capsys)
    assert set(record) == {"metric", "value", "unit", "device"}
    assert record["metric"] == f"torch_{name}_env_steps_per_second"
    assert record["value"] > 0 and record["unit"] == "env-steps/s" and record["device"] == "cpu"


def test_bench_suite_main_reads_its_constants(monkeypatch, capsys):
    default, overrides = bench_suite.CONFIGS["ff_mappo_lbf"]
    monkeypatch.setitem(bench_suite.CONFIGS, "ff_mappo_lbf",
                        (default, overrides + TINY["ff_mappo_lbf"]))
    for name, value in (("ROLLOUT", 4), ("UPDATES_PER_CALL", 1), ("TIMED_CALLS", 1)):
        monkeypatch.setattr(bench_suite, name, value)
    bench_suite.main(["ff_mappo_lbf", "--device", "cpu"])
    (record,) = lines(capsys)
    assert record["metric"] == "torch_ff_mappo_lbf_env_steps_per_second"
    with pytest.raises(SystemExit):
        bench_suite.main(["no_such_config", "--device", "cpu"])


def test_bench_band_line(capsys):
    record = bench_band.band(3, "cpu", num_envs=2, rollout_length=4, updates_per_call=1,
                             warmup_calls=1, timed_calls=1)
    assert len(record["repeats"]) == 3 and all(r > 0 for r in record["repeats"])
    assert record["min"] <= record["median"] <= record["max"]
    assert record["device"] == "cpu" and record["unit"] == "env-steps/s"
    # Its measurement is the headline bench's.
    assert (bench_band.NUM_ENVS, bench_band.TIMED_CALLS) == (bench_torch.NUM_ENVS,
                                                              bench_torch.TIMED_CALLS)


def test_bench_envs_sweep_lines_and_plot(tmp_path, capsys):
    points = bench_envs_sweep.sweep((2, 4), 1, "cpu", updates_per_call=1, warmup_calls=1, rollout=4)
    records = lines(capsys)
    assert [r["num_envs"] for r in records] == [2, 4] == [n for n, _ in points]
    assert all(r["metric"] == "torch_ff_ippo_sps_vs_envs" and r["value"] > 0
               and r["device"] == "cpu" for r in records)
    out = tmp_path / "sweep.png"
    bench_envs_sweep.plot(points, "cpu", str(out))
    assert out.stat().st_size > 1000
    assert bench_envs_sweep.ENV_COUNTS == (16, 64, 256, 512, 1024, 2048)


def test_bench_vmap_seeds_lines(capsys):
    stock, two = bench_vmap_seeds.compare([2], "cpu", num_envs=2, rollout=4, updates_per_call=1,
                                          timed_calls=1)
    assert lines(capsys) == [stock, two]
    assert set(stock) == {"config", "ms_per_call", "env_steps_per_second", "device"}
    assert set(two) == {"config", "ms_per_call", "env_steps_per_second_all_seeds",
                        "cost_vs_1_seed", "speedup_vs_sequential", "device"}
    assert two["cost_vs_1_seed"] == pytest.approx(two["ms_per_call"] / stock["ms_per_call"],
                                                  rel=1e-2)
    assert two["speedup_vs_sequential"] == pytest.approx(2 / two["cost_vs_1_seed"], rel=1e-2)


@pytest.mark.parametrize("name", list(bench_mfu.CONFIGS))
def test_bench_mfu_line(name, capsys):
    record = bench_mfu.measure(name, "cpu", TINY[name], updates_per_call=1, scan_steps=2,
                               timed_calls=1)
    assert lines(capsys) == [record] and set(record) == MFU_FIELDS
    assert record["matmul_flops_per_call"] > 0 and record["achieved_tflops"] > 0
    # On the CPU no kernel launches, and the card's fields are not measured.
    assert record["gru_kernel_flops_per_call"] == 0 and record["gru_launches_per_call"] == {}
    assert record["mfu_vs_fp32_peak"] is None and record["device_busy_share"] is None


# ------------------------------------------------------------------ bench_mfu's counts
def test_bench_mfu_counts_a_tiny_mlp_update_by_hand():
    """One ff-IPPO update on RWARE tiny-2ag, 2 envs, rollout 4, one epoch of one
    minibatch, the shipped [128, 128] MLPs: every matrix product reckoned from
    the shapes. A linear layer's forward is 2 * rows * in * out; its backward
    the weight's gradient (the same) and the input's (the same, except for the
    first layer, whose input needs none)."""
    call, state, _ = bench_mfu.build("ff_ippo_rware", "cpu", 3, TINY["ff_ippo_rware"], 1)
    matmul, gru_flops, launches, _ = bench_mfu.count_flops(call, call(state))

    cfg = load_config("default_ff_ippo", ["env=rware", "env/scenario=tiny-2ag"])
    wrapped = bench_mfu.environments.make(cfg, "cpu")[0]
    env, (d,) = unwrap_env(wrapped), obs_shape(wrapped)
    e, t, a, n = 2, 4, env.num_agents, env.action_dim
    k, s = env._window_offsets.shape[0], env.num_shelves  # cells of an agent's view; shelves

    def fwd(rows, sizes):
        return sum(2 * rows * i * o for i, o in zip(sizes[:-1], sizes[1:]))

    actor, critic = [d, 128, 128, n], [d, 128, 128, 1]
    rows = t * e * a
    # RWARE's view of each agent: two einsums over its k cells (the other agents'
    # directions, the shelves' requests), for the stepped state and for the
    # auto-reset's state, every step.
    view = 2 * e * a * k * a * 4 + 2 * e * a * k * s
    rollout = fwd(rows, actor) + t * 2 * view
    critic_pass = fwd(rows + e * a, critic)  # the stored steps and the bootstrap value
    epochs = sum(2 * fwd(rows, net) + fwd(rows, net[1:]) for net in (actor, critic))
    assert matmul == rollout + critic_pass + epochs
    assert gru_flops == 0 and launches == {}


def count_launches_as_the_card(monkeypatch):
    """Count into the op's counters the launches that its CUDA branch would make
    for each call of an entry point, then run the plain version."""
    def launch(name, work):
        gru.kernel_launches[name] += 1
        gru.launch_shapes[(name, *work)] += 1

    def backward(stacked, gates_i, keep, *rest):
        s = gates_i.shape[0] if stacked else 1
        t_len, b, h = gates_i.shape[-3], gates_i.shape[-2], gates_i.shape[-1] // 3
        tag = "_stacked" if stacked else ""
        if gru.kernel_route(t_len, b, h).route == "resident":
            launch("bwd_gates" + tag, (t_len, b, h, 1, s, True))
        slices = gru.reduce_split(t_len, b, h).slices
        launch("bwd_recurrence" + tag, (t_len, b, h, 1, s, True))
        launch("bwd_reduce" + tag, (t_len, b, h, slices, s, True))
        launch("bwd_reduce_sum" + tag, (0, 0, h, slices, s, True))

    for entry, count in (
        ("gru_sequence_forward", lambda g, k, *r: launch(
            "fwd", (*g.shape[:2], g.shape[2] // 3, 1, 1, True))),
        ("gru_sequence_stacked_forward", lambda g, k, *r: launch(
            "fwd_stacked", (*g.shape[1:3], g.shape[3] // 3, 1, g.shape[0], k.dim() == 3))),
        ("gru_sequence_backward", lambda *a: backward(False, *a)),
        ("gru_sequence_stacked_backward", lambda *a: backward(True, *a)),
    ):
        plain = getattr(gru, entry)
        monkeypatch.setattr(gru, entry, lambda *a, _p=plain, _c=count: (_c(*a), _p(*a))[1])


@pytest.mark.parametrize("name,per_update", [
    ("rec_ippo_smax", {"fwd": 17, "bwd_gates": 16, "bwd_recurrence": 16, "bwd_reduce": 16,
                       "bwd_reduce_sum": 16}),
    ("rec_iql_smax", {"fwd": 2, "fwd_stacked": 2, "bwd_gates": 2, "bwd_recurrence": 2,
                      "bwd_reduce": 2, "bwd_reduce_sum": 2}),
])
def test_bench_mfu_counts_gru_kernels_from_launches(name, per_update, monkeypatch):
    """The rec configs at the shipped epochs and minibatches (4 x 2 for PPO, 2
    epochs for rec-IQL), 2 updates a call, H = 128, through the op
    (`gru_impl=pallas`: on CPU tensors its plain versions; "auto" would take
    the plain scan here)."""
    overrides = ["arch.num_envs=2", "system.rollout_length=4", "system.recurrent_chunk_size=2"]
    if name == "rec_iql_smax":
        overrides = ["arch.num_envs=2", "system.sample_batch_size=4",
                     "system.sample_sequence_length=6"]
    overrides.append("network.gru_impl=pallas")
    call, state, _ = bench_mfu.build(name, "cpu", 3, overrides, updates_per_call=2, scan_steps=2)
    state = call(state)
    count_launches_as_the_card(monkeypatch)
    _, gru_flops, launches, _ = bench_mfu.count_flops(call, state)
    assert launches == {k: 2 * n for k, n in per_update.items()}
    assert sum(gru.launch_shapes.values()) == sum(launches.values())
    want = sum(n * gru.kernel_work(*key)[0] for key, n in gru.launch_shapes.items())
    assert gru_flops == want > 0
    # Every launch of the forward at its shape: (T, B) of the chunks and minibatches.
    assert all(key[3] == 128 for key in gru.launch_shapes)


# ------------------------------------------------------------------ marl-eval JSON
def test_json_logs_plot_through_plot_results(tmp_path):
    pytest.importorskip("matplotlib")
    base = str(tmp_path / "results")
    for task in ("Penalty-25-stateless-v0", "Climbing-stateless-v0"):
        cfg = load_config("default_ff_ippo", [
            *MATRAX, f"env.scenario.task_name={task}", "logger.use_json=True",
            f"logger.base_exp_path={base}"])
        ff_ippo.run_experiment(cfg)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "plot_results.py"),
                          os.path.join(base, "json"), "--out", str(tmp_path / "plots")],
                         capture_output=True, text=True, timeout=120, check=True)
    pngs = sorted(os.listdir(tmp_path / "plots"))
    assert len(pngs) == 2 and all(p.endswith("_mean_episode_return.png") for p in pngs)
    assert out.stdout.count("wrote ") == 2
