"""The port's CLIs over two gloo ranks, launched as a user launches them:

    python -m torch.distributed.run --standalone --nproc-per-node=2 \\
        -m mava_tpu_torch.systems.ppo.rec_ippo +arch.device=cpu ...

rec-IPPO runs to its end; only rank 0 logs, and the logged env-step counts
are global (both ranks' envs). A run saved after two updates and resumed for
two more ends bitwise where the run that never stopped ends (the saved state
holds every rank's rows and generator). ff-ISAC counts its explore phase over
both ranks.
"""

import re
import subprocess
import sys

import torch

from mava_tpu_torch.utils.checkpointing import differences
from test_torch_parallel_workers import worker_env

torch.set_num_threads(1)
WORLD = 2
TINY = ["+arch.device=cpu", "system.rollout_length=4", "arch.num_envs=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.ppo_epochs=1",
        "system.num_minibatches=2", "env.kwargs.time_limit=16"]


def torchrun(module: str, args, cwd) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", module, *args],
        capture_output=True, text=True, env=worker_env(), cwd=cwd, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def rec_ippo(cwd, updates: int, evaluations: int, save: str, load: str = None):
    args = TINY + [f"system.num_updates={updates}", f"arch.num_evaluation={evaluations}",
                   "logger.checkpointing.save_model=True",
                   "logger.checkpointing.save_full_state=True",
                   "logger.checkpointing.save_args.max_to_keep=null",
                   f"logger.checkpointing.save_args.checkpoint_uid={save}"]
    if load:
        args += ["logger.checkpointing.load_full_state=True",
                 f"logger.checkpointing.load_args.checkpoint_uid={load}"]
    return torchrun("mava_tpu_torch.systems.ppo.rec_ippo", args, cwd)


def last_state(cwd, uid: str):
    steps = sorted((cwd / "checkpoints" / "rec_ippo" / uid).glob("[0-9]*"),
                   key=lambda p: int(p.name))
    return int(steps[-1].name), torch.load(steps[-1] / "state.pt", weights_only=True)


def test_rec_ippo_over_two_ranks_logs_once_with_global_steps_and_resumes_bitwise(tmp_path):
    straight = rec_ippo(tmp_path, 4, 2, "straight")
    assert straight.stdout.count("Recurrent IPPO experiment completed.") == WORLD
    log = straight.stderr
    # One line an event and round: rank 0's alone.
    assert log.count("EVALUATOR") == 2 and log.count("TRAINER") == 2
    round_steps = 2 * 4 * 2 * WORLD  # updates x rollout x envs x ranks
    steps = [int(s) for s in re.findall(r"MISC - .*Timestep: (\d+)", log)]
    assert steps == [round_steps, 2 * round_steps]

    rec_ippo(tmp_path, 2, 1, "half")
    rec_ippo(tmp_path, 2, 1, "resumed", load="half")
    step, want = last_state(tmp_path, "straight")
    resumed_step, got = last_state(tmp_path, "resumed")
    assert resumed_step == step == 2 * round_steps
    # The saved state is the global batch: both ranks' rows and generators.
    assert got[5].shape[0] == WORLD * 2  # dones, (W * num_envs, agents)
    assert got[2]["__generators__"].shape[0] == WORLD
    assert differences(got, want) == []


def test_isac_over_two_ranks_counts_the_explore_phase_over_both(tmp_path):
    proc = torchrun("mava_tpu_torch.systems.sac.ff_isac", [
        "+arch.device=cpu", "system.total_timesteps=400", "arch.num_evaluation=2",
        "arch.num_envs=4", "system.explore_steps=40", "system.epochs=4",
        "system.policy_update_delay=2", "env.kwargs.time_limit=16",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False"], tmp_path)
    assert proc.stdout.count("ISAC experiment completed.") == WORLD
    assert re.findall(r"MISC - Step: (\d+)", proc.stderr) == [str(40 * WORLD)]


def test_rec_iql_seed_program_sharded_over_two_ranks(tmp_path):
    """`seed_shards = 2` over two ranks: one entry a rank, each rank's
    evaluation gathered, so both ranks print every entry's return alike."""
    proc = torchrun("mava_tpu_torch.advanced_usage.rec_iql_vmap_seeds", [
        "+arch.device=cpu", "system.num_updates=2", "arch.num_evaluation=1", "arch.num_envs=2",
        "env.kwargs.time_limit=16", "+system.num_seeds=2", "+system.seed_shards=2",
        "system.sample_batch_size=4", "network.hidden_state_dim=16",
        "system.sample_sequence_length=6", "arch.num_eval_episodes=4"], tmp_path)
    assert proc.stdout.count("rec-IQL vmap-seeds experiment completed.") == WORLD
    lines = re.findall(r"final eval returns per seed: (-?[\d.]+, -?[\d.]+)", proc.stdout)
    assert len(lines) == WORLD and lines[0] == lines[1]
