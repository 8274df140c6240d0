"""The port stands on its own: a wheel built from the tree ships the port's
config tree, kernel source and notebook, and `mava_tpu_torch/` taken alone
from that wheel runs with `jax`, `jaxlib`, `flax`, `optax` and `mava_tpu`
unimportable (`chip_smoke.IMPORT_BLOCKER`): the ff-IPPO CLI, one rec-IPPO
update equal to the same update run from the repo, and `plot_results` on that
run's marl-eval JSON (one PNG a task; where matplotlib is not installed, one
series a task). Also where `ops.gru.kernel_build_dir()` builds the
kernels: the variable, a checkout, an installed copy.

The wheel is built in a copy of the packaging files under `tmp_path`, never in
the repo (setuptools writes `build/` and `*.egg-info` beside its sources). On
the CPU the rec-IPPO child's GRU takes the plain path (`network.gru_impl=pallas`
on CPU tensors), so it builds and launches no kernel; `chip_smoke.py
--standalone` makes the same run on the card."""

import importlib.util
import json
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mava_tpu_torch.ops import gru

ROOT = Path(__file__).resolve().parent.parent
JAX_CONFIGS = sorted(p.relative_to(ROOT / "mava_tpu").as_posix()
                     for p in (ROOT / "mava_tpu" / "configs").rglob("*.yaml"))
PPO_TINY = ["system.num_updates=2", "arch.num_evaluation=1", "system.rollout_length=4",
            "arch.num_envs=2", "arch.num_eval_episodes=8", "arch.absolute_metric=False",
            "system.ppo_epochs=1", "system.num_minibatches=2", "env.kwargs.time_limit=16",
            "+arch.device=cpu"]
REC_TINY = ["system.num_updates=1", "arch.num_evaluation=1", "arch.num_envs=2",
            "system.rollout_length=8", "system.recurrent_chunk_size=4", "system.ppo_epochs=2",
            "system.num_minibatches=2", "network.hidden_state_dim=16",
            "network.actor_network.pre_torso.layer_sizes=[16]",
            "network.actor_network.post_torso.layer_sizes=[16]",
            "network.critic_network.pre_torso.layer_sizes=[16]",
            "network.critic_network.post_torso.layer_sizes=[16]",
            "arch.num_eval_episodes=4", "arch.absolute_metric=False", "env.kwargs.time_limit=16",
            "logger.use_console=False", "network.gru_impl=pallas", "logger.use_json=True",
            "+arch.device=cpu"]


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> Path:
    pytest.importorskip("setuptools")
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(ROOT / name, src / name)
    for package in ("mava_tpu", "mava_tpu_torch"):
        shutil.copytree(ROOT / package, src / package,
                        ignore=shutil.ignore_patterns("__pycache__"))
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
                    "-q", "-w", str(src / "dist"), str(src)], cwd=src, check=True,
                   capture_output=True, text=True, timeout=300)
    (built,) = (src / "dist").glob("*.whl")
    return built


@pytest.fixture(scope="module")
def alone(wheel, tmp_path_factory) -> Path:
    """`mava_tpu_torch/` alone, extracted from the wheel."""
    dest = tmp_path_factory.mktemp("alone")
    with zipfile.ZipFile(wheel) as archive:
        archive.extractall(dest, [n for n in archive.namelist()
                                  if n.startswith("mava_tpu_torch/")])
    assert not (dest / "mava_tpu").exists()
    return dest


def test_the_wheel_ships_the_ports_data(wheel):
    with zipfile.ZipFile(wheel) as archive:
        names = set(archive.namelist())
    configs = sorted(n.removeprefix("mava_tpu_torch/") for n in names
                     if n.startswith("mava_tpu_torch/configs/") and n.endswith(".yaml"))
    assert len(JAX_CONFIGS) == 88 and configs == JAX_CONFIGS
    assert "mava_tpu_torch/csrc/gru_sequence.cu" in names
    assert "mava_tpu_torch/examples/Quickstart.ipynb" in names


def test_the_ff_ippo_cli_runs_alone(alone, tmp_path):
    code = ("import json\n"
            "from mava_tpu_torch.systems.ppo import ff_ippo\n"
            "print(json.dumps({'performance': ff_ippo.main()}))\n")
    proc = chip_smoke.run_alone(alone, code, PPO_TINY, tmp_path / "kernels", timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ff-IPPO experiment completed." in proc.stdout
    assert np.isfinite(json.loads(proc.stdout.strip().splitlines()[-1])["performance"])


def test_a_blocked_import_raises_alone(alone, tmp_path):
    """The blocker matches top-level names exactly: `mava_tpu_torch` imports,
    each blocked name raises."""
    code = ("import mava_tpu_torch\n"
            "for name in BLOCKED:\n"
            "    try:\n"
            "        __import__(name)\n"
            "    except ImportError:\n"
            "        continue\n"
            "    raise SystemExit(name + ' imported')\n")
    proc = chip_smoke.run_alone(alone, code, [], tmp_path / "kernels", timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-2000:]
    assert set(chip_smoke.BLOCKED) == {"jax", "jaxlib", "flax", "optax", "mava_tpu"}


@pytest.fixture(scope="module")
def standalone(alone, tmp_path_factory):
    """One rec-IPPO update run from the copy alone: (its report, a directory
    holding its saved update)."""
    out = tmp_path_factory.mktemp("standalone")
    child = chip_smoke.standalone_update(alone, "cpu", REC_TINY, out / "alone.pt", out / "kernels")
    return child, out


def test_rec_ippo_alone_equals_the_repo(alone, standalone, tmp_path):
    child, out = standalone
    assert Path(child["module"]).resolve().parent == (alone / "mava_tpu_torch").resolve()
    assert child["build_dir"] == str(out / "kernels")
    assert child["loaded"] == [] and child["libraries"] == [] and not (out / "kernels").exists()
    # On CPU tensors the op takes its plain versions: no kernel is launched.
    assert all(n == 0 for n in child["launches"].values())

    here = chip_smoke.rec_ippo_run(REC_TINY + [f"logger.base_exp_path={tmp_path / 'here'}"],
                                   tmp_path / "here.pt")
    assert here["env_steps_per_update"] == child["env_steps_per_update"] == 16
    assert chip_smoke.max_difference(torch.load(out / "alone.pt"),
                                     torch.load(tmp_path / "here.pt")) <= 1e-6


def test_plot_results_alone_draws_a_png_a_task(alone, standalone, tmp_path):
    pytest.importorskip("matplotlib")
    pngs = chip_smoke.plot_alone(alone, alone / "results" / "json", tmp_path / "plots",
                                 tmp_path / "kernels")
    assert pngs == ["RobotWarehouse_tiny-2ag_mean_episode_return.png"]


def test_plot_results_alone_without_matplotlib_reads_the_series(alone, standalone, tmp_path,
                                                                monkeypatch, capsys):
    """Where matplotlib is not installed, the check reads one series a task
    with the tool's own `collect` and `_series`."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    assert chip_smoke.plot_alone(alone, alone / "results" / "json", tmp_path / "plots",
                                 tmp_path / "kernels") == []
    assert "RobotWarehouse/tiny-2ag/rec_ippo': [1]" in capsys.readouterr().out.replace('"', "'")
    assert not (tmp_path / "plots").exists()


def load_gru_from(package: Path):
    """`ops/gru.py` of a copy of the port, loaded under another name."""
    spec = importlib.util.spec_from_file_location("copied_gru", package / "ops" / "gru.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("where", ["variable", "checkout", "xdg_cache_home", "home"])
def test_kernel_build_dir(where, tmp_path, monkeypatch):
    monkeypatch.delenv(gru.BUILD_DIR_VARIABLE, raising=False)
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if where == "variable":
        monkeypatch.setenv(gru.BUILD_DIR_VARIABLE, str(tmp_path / "chosen"))
        assert gru.kernel_build_dir() == tmp_path / "chosen"
        return
    if where == "checkout":
        assert gru.kernel_build_dir() == ROOT / "build" / "kernels"
        return
    installed = tmp_path / "site-packages"
    shutil.copytree(ROOT / "mava_tpu_torch", installed / "mava_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "configs", "examples"))
    copied = load_gru_from(installed / "mava_tpu_torch")
    if where == "xdg_cache_home":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
        assert copied.kernel_build_dir() == tmp_path / "cache" / "mava_tpu_torch" / "kernels"
    else:
        assert copied.kernel_build_dir() == (tmp_path / "home" / ".cache" / "mava_tpu_torch"
                                             / "kernels")
