"""The port's TensorBoard and Neptune loggers and `arch.profile`.

TensorBoard: the same scalars through `mava_tpu`'s tfevents writer and the
port's, directly and through each package's `MavaLogger`, give files of equal
records apart from the wall time. Neptune: the twins of
`tests/test_logger.py::test_neptune_logger_*` with the same stubbed client.
Profile: `+arch.profile=True` writes a Chrome trace of one learner round in
which the port's phase spans appear.
"""

import json
import os
import struct
import sys
import types
import zipfile

import numpy as np
import pytest

from mava_tpu.utils import logger as jlogger
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu.utils.tbwriter import TensorboardWriter as JaxWriter
from mava_tpu_torch.systems.ppo import rec_ippo
from mava_tpu_torch.utils import logger as tlogger
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.tbwriter import TensorboardWriter


def _records(path):
    """The TFRecord payloads of a tfevents file, each with its wall time
    (field 1, a double: tag byte 0x09 and 8 bytes) cut off; the framing's
    CRCs are checked."""
    from mava_tpu_torch.utils.tbwriter import _masked_crc

    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        (length,) = struct.unpack("<Q", data[i:i + 8])
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == _masked_crc(data[i:i + 8])
        payload = data[i + 12:i + 12 + length]
        assert struct.unpack("<I", data[i + 12 + length:i + 16 + length])[0] == \
            _masked_crc(payload)
        assert payload[0] == 0x09
        out.append(payload[9:])
        i += 16 + length
    return out


def _events_file(directory):
    (name,) = [n for n in os.listdir(directory) if n.startswith("events.out.tfevents.")]
    return os.path.join(directory, name)


SCALARS = [("evaluator/episode_return/mean", 1.5, 0), ("trainer/value_loss", -0.25, 128),
           ("misc/timestep", 4096, 4096), ("absolute/win_rate", 62.5, 10**7)]


def test_tb_writer_matches_jax_writer(tmp_path):
    writers = JaxWriter(str(tmp_path / "jax")), TensorboardWriter(str(tmp_path / "torch"))
    for writer in writers:
        for tag, value, step in SCALARS:
            writer.scalar(tag, value, step)
        writer.close()
    want = _records(_events_file(tmp_path / "jax"))
    assert len(want) == 1 + len(SCALARS)
    assert _records(_events_file(tmp_path / "torch")) == want


def _cfg(load, tmp_path, **logger_overrides):
    cfg = load("default_ff_ippo", ["logger.use_console=False"])
    cfg.logger.base_exp_path = str(tmp_path)
    for k, v in logger_overrides.items():
        cfg.logger[k] = v
    return cfg


def test_tb_logger_matches_jax_logger(tmp_path):
    """Both packages' `MavaLogger` with `use_tb`: the same metrics (an eval with
    a win rate, train losses, a misc line) give the same records."""
    metrics = [
        ({"episode_return": np.array([1.0, 3.0]), "won_episode": np.array([True, False])},
         64, 0, "EVAL"),
        ({"value_loss": np.array([[0.5, 0.25]]), "entropy": np.array([[1.0, 2.0]])}, 64, 0,
         "TRAIN"),
        ({"timestep": 64, "time_learn": 0.5}, 64, 0, "MISC"),
    ]
    for name, module, load in (("jax", jlogger, jax_load_config), ("torch", tlogger, load_config)):
        logger = module.MavaLogger(_cfg(load, tmp_path / name, use_tb=True))
        for data, t, t_eval, event in metrics:
            logger.log(dict(data), t, t_eval, getattr(module.LogEvent, event))
        logger.stop()
    (jdir,) = (tmp_path / "jax" / "tensorboard" / "ff_ippo").iterdir()
    (tdir,) = (tmp_path / "torch" / "tensorboard" / "ff_ippo").iterdir()
    want = _records(_events_file(jdir))
    assert len(want) == 1 + 5 + 2 + 2  # version; 4 return stats, win rate; 2 losses; misc
    assert _records(_events_file(tdir)) == want


class _FakeAttr:
    """Stands in for a neptune run attribute: supports append() and upload()."""

    def __init__(self):
        self.appended = []
        self.uploaded = []

    def append(self, value, step=None):
        self.appended.append((value, step))

    def upload(self, path):
        self.uploaded.append(path)


class _FakeRun:
    def __init__(self, project=None, tags=None):
        self.project = project
        self.tags = tags
        self.assigned = {}
        self.attrs = {}
        self.stopped = False

    def __getitem__(self, key):
        return self.attrs.setdefault(key, _FakeAttr())

    def __setitem__(self, key, value):
        self.assigned[key] = value

    def stop(self):
        self.stopped = True


def _install_fake_neptune(monkeypatch):
    mod = types.ModuleType("neptune")
    mod.runs = []

    def init_run(project=None, tags=None):
        run = _FakeRun(project, tags)
        mod.runs.append(run)
        return run

    mod.init_run = init_run
    monkeypatch.setitem(sys.modules, "neptune", mod)
    return mod


def test_neptune_logger_main_metric_filtering(tmp_path, monkeypatch):
    mod = _install_fake_neptune(monkeypatch)
    cfg = _cfg(load_config, tmp_path)
    cfg.logger.kwargs["neptune_project"] = "org/proj"
    cfg.logger.kwargs["neptune_tag"] = ["rware"]
    nl = tlogger.NeptuneLogger(cfg, unique_token="tok")
    run = mod.runs[0]
    assert run.project == "org/proj" and run.tags == ["rware"]
    assert "config" in run.assigned  # the config is uploaded at start

    # detailed_neptune_logging=False: only the main metrics pass the filter.
    LogEvent = tlogger.LogEvent
    nl.log_stat("episode_return/mean", 1.5, step=10, eval_step=0, event=LogEvent.EVAL)
    nl.log_stat("win_rate", 50.0, step=10, eval_step=0, event=LogEvent.EVAL)
    nl.log_stat("value_loss", 0.3, step=10, eval_step=0, event=LogEvent.TRAIN)
    assert run.attrs["evaluator/episode_return/mean"].appended == [(1.5, 10)]
    assert run.attrs["evaluator/win_rate"].appended == [(50.0, 10)]
    assert "trainer/value_loss" not in run.attrs

    # Detailed logging lets everything through.
    cfg.logger.kwargs["detailed_neptune_logging"] = True
    nl2 = tlogger.NeptuneLogger(cfg, unique_token="tok2")
    nl2.log_stat("value_loss", 0.3, step=10, eval_step=0, event=LogEvent.TRAIN)
    assert mod.runs[1].attrs["trainer/value_loss"].appended == [(0.3, 10)]


def test_neptune_logger_zip_upload_on_stop(tmp_path, monkeypatch):
    mod = _install_fake_neptune(monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    cfg = _cfg(load_config, tmp_path)
    cfg.logger.kwargs["upload_json_data"] = True
    jl = tlogger.JsonLogger(cfg, unique_token="tok")
    jl.log_dict({"win_rate": 10.0}, step=100, eval_step=0, event=tlogger.LogEvent.EVAL)
    jl.stop()

    nl = tlogger.NeptuneLogger(cfg, unique_token="tok")
    nl.stop()
    run = mod.runs[0]
    assert run.stopped
    uploads = run.attrs["metrics_json"].uploaded
    assert len(uploads) == 1 and os.path.exists(uploads[0])
    assert uploads[0].startswith(str(tmp_path / "tmp"))  # the run's own temp dir
    assert "metrics.json" in zipfile.ZipFile(uploads[0]).namelist()

    cfg.logger.kwargs["upload_json_data"] = False
    nl2 = tlogger.NeptuneLogger(cfg, unique_token="tok")
    nl2.stop()
    assert mod.runs[1].stopped and "metrics_json" not in mod.runs[1].attrs


def test_neptune_without_the_package_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "neptune", None)
    with pytest.raises(RuntimeError, match="neptune package is not installed"):
        tlogger.MavaLogger(_cfg(load_config, tmp_path, use_neptune=True))


CLI = ["system.num_updates=2", "arch.num_evaluation=2", "system.rollout_length=4",
       "arch.num_envs=2", "arch.num_eval_episodes=2", "arch.absolute_metric=False",
       "system.ppo_epochs=1", "system.num_minibatches=2", "env.kwargs.time_limit=16",
       "network.hidden_state_dim=16", "+arch.device=cpu", "logger.use_console=False"]


def test_cli_with_tb_neptune_and_profile(tmp_path, monkeypatch):
    """`logger.use_tb=True`, `logger.use_neptune=True` (stubbed) and
    `+arch.profile=True` on one rec-IPPO run: TB events, neptune appends, and
    a Chrome trace of round 1 that holds the rollout's span."""
    mod = _install_fake_neptune(monkeypatch)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["rec_ippo", *CLI, "logger.use_tb=True",
                                      "logger.use_neptune=True", "+arch.profile=True",
                                      f"+arch.profile_dir={tmp_path / 'prof'}"])
    assert np.isfinite(rec_ippo.main())
    (tb_dir,) = (tmp_path / "results" / "tensorboard" / "rec_ippo").iterdir()
    assert len(_records(_events_file(tb_dir))) > 10
    assert mod.runs[0].stopped and mod.runs[0].attrs["evaluator/episode_return/mean"].appended
    (trace,) = (tmp_path / "prof").iterdir()
    assert "round1" in trace.name
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "rec_ippo/rollout" in names and "rec_ippo/epochs" in names
