"""`bench_torch.py`, the port's bench, at a tiny size on the CPU."""

import json

import pytest
import torch

import bench
import bench_torch

torch.set_num_threads(1)


def test_run_returns_a_positive_rate():
    rate = bench_torch.run(2, 4, 1, 1, 1, "cpu")
    assert rate > 0 and rate == rate


def test_main_prints_one_json_line(monkeypatch, capsys):
    for name, value in (("NUM_ENVS", 2), ("ROLLOUT_LENGTH", 4), ("UPDATES_PER_CALL", 1),
                        ("WARMUP_CALLS", 1), ("TIMED_CALLS", 2)):
        monkeypatch.setattr(bench_torch, name, value)
    bench_torch.main(["--device", "cpu"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    record = json.loads(line)
    assert set(record) == {"metric", "value", "unit", "device"}
    assert record["metric"] == "torch_ff_ippo_rware_tiny2ag_env_steps_per_second"
    assert record["unit"] == "env-steps/s" and record["device"] == "cpu"
    assert record["value"] > 0


def test_main_needs_cuda_unless_asked_otherwise(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main([])
    assert capsys.readouterr().out == ""


def test_bench_times_the_program_bench_py_times():
    for name in ("NUM_ENVS", "ROLLOUT_LENGTH", "UPDATES_PER_CALL", "WARMUP_CALLS", "TIMED_CALLS"):
        assert getattr(bench_torch, name) == getattr(bench, name), name
    assert (bench_torch.NUM_ENVS, bench_torch.ROLLOUT_LENGTH) == (512, 128)
