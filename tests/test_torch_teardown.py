"""The process group that a CLI brings up is taken down before the interpreter
exits, on every rank, as a user launches it:

    python -m torch.distributed.run --standalone --nproc-per-node=2 \\
        -m mava_tpu_torch.systems.ppo.ff_ippo +arch.device=cpu ...

Each rank runs the CLI's module as `-m` runs it, from a small runner that
registers, before the CLI starts, an exit hook printing whether a group is
still up. Exit hooks run last-registered first, so the runner's runs after the
hook that `parallel.distributed.initialize` registers when it brings the group
up: it sees what the interpreter's own teardown will find. A rank that raises
exits with its error and leaves the group to the interpreter, so that no
teardown waits on a peer.
"""

import re
import subprocess
import sys

import torch.distributed as dist

from mava_tpu_torch.parallel import distributed
from test_torch_parallel_workers import worker_env

WORLD = 2
RUNNER = r"""
import atexit, os, runpy, sys
import torch.distributed as dist
# One write a line: the ranks share torchrun's stdout.
atexit.register(lambda: os.write(1, f"rank {os.environ['RANK']} group up at exit: "
                                    f"{dist.is_initialized()}\n".encode()))
module = sys.argv[1]
sys.argv = [module, *sys.argv[2:]]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
TINY = ["+arch.device=cpu", "system.rollout_length=4", "arch.num_envs=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.ppo_epochs=1",
        "env.kwargs.time_limit=16"]


def torchrun_cli(tmp_path, module: str, args) -> subprocess.CompletedProcess:
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", str(runner), module, *args],
        capture_output=True, text=True, env=worker_env(), cwd=tmp_path, timeout=240)


def exit_states(stdout: str) -> dict:
    return {int(r): up for r, up in re.findall(r"rank (\d) group up at exit: (True|False)", stdout)}


def test_cli_over_two_ranks_tears_its_group_down_on_every_rank(tmp_path):
    proc = torchrun_cli(tmp_path, "mava_tpu_torch.systems.ppo.ff_ippo",
                        TINY + ["system.num_updates=2", "arch.num_evaluation=1"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("ff-IPPO experiment completed.") == WORLD
    assert exit_states(proc.stdout) == {0: "False", 1: "False"}


def test_a_rank_that_raises_exits_with_its_error(tmp_path):
    """Fewer updates than evaluations: both ranks raise once the group is up,
    and exit with the error, the group left up for the interpreter."""
    proc = torchrun_cli(tmp_path, "mava_tpu_torch.systems.ppo.ff_ippo",
                        TINY + ["system.num_updates=1", "arch.num_evaluation=2"])
    assert proc.returncode != 0
    assert "num_updates must be at least arch.num_evaluation" in proc.stderr
    assert exit_states(proc.stdout) == {0: "True", 1: "True"}


def test_shutdown_without_a_group_does_nothing():
    assert not dist.is_initialized()
    distributed.shutdown()
    assert not dist.is_initialized()
