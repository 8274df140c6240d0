"""What the measuring tools share: the headline program's sizes, the device and
its label, the learner of a PPO config, and the one timing loop (`time_calls`),
which `bench_torch.py`, `bench_suite`, `bench_band`, `bench_envs_sweep`,
`bench_vmap_seeds` and `bench_mfu` all time with.

A tool runs on the card unless its caller passes `--device cpu`. Without a
card it raises `start_experiment`'s error; it never falls back to the CPU. A
time read on the CPU is the CPU's, and every printed line names the device it
ran on (`device_label`)."""

from __future__ import annotations

import subprocess
import time
from typing import Any, Callable, Sequence, Tuple

import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch.systems.anakin import start_experiment
from mava_tpu_torch.systems.ppo import ff_ippo, rec_ippo
from mava_tpu_torch.utils.config import Config, load_config

# The headline program, `bench.py`'s and `bench_torch.py`'s: ff-IPPO on RWARE
# tiny-2ag (`default_ff_ippo`), 512 envs, a rollout of 128, 4 updates a call,
# 3 warm-up calls (they pay for the allocator's growth and cuBLAS's set-up),
# then 10 timed calls.
NUM_ENVS = 512
ROLLOUT_LENGTH = 128
UPDATES_PER_CALL = 4
WARMUP_CALLS = 3
TIMED_CALLS = 10


def device_label(device: str) -> str:
    """The card's name and power limit as `nvidia-smi` gives them; else the device."""
    if torch.device(device).type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bench_config(config_name: str, overrides: Sequence[str],
                 device: str) -> Tuple[Config, torch.device]:
    """`config_name` with `overrides` and the console off, on `device`; and the
    device as `start_experiment` gives it (it raises without a card unless the
    CPU was asked for, and turns TF32 off)."""
    config = load_config(config_name, [*overrides, "logger.use_console=False",
                                       f"+arch.device={device}"])
    return config, start_experiment(config)


def ppo_learner(config_name: str, overrides: Sequence[str], device: str,
                updates_per_call: int, calls: int) -> Tuple[Callable, Any, int]:
    """(learn, state, env-steps a call) of the PPO system of `config_name` (ff
    or rec, IPPO or MAPPO: a MAPPO critic reads the global state):
    `updates_per_call` updates a call, the lr schedule over `calls` calls, the
    envs reset from a generator seeded with 0."""
    config, device = bench_config(config_name, overrides, device)
    config.system.num_updates = updates_per_call * calls
    config.system.num_updates_per_eval = updates_per_call
    recurrent, centralised = config_name.startswith("default_rec_"), "mappo" in config_name
    if recurrent and config.system.get("recurrent_chunk_size") is None:
        config.system.recurrent_chunk_size = config.system.rollout_length
    env, _ = environments.make(config, device, add_global_state=centralised)
    generator = torch.Generator(device=device).manual_seed(0)
    module = rec_ippo if recurrent else ff_ippo
    learn, _, state = module.learner_setup(env, generator, config, device, centralised)
    steps = (updates_per_call * config.system.rollout_length * config.arch.num_envs
             * config.arch.n_devices)
    return learn, state, steps


def next_learner_state(learn: Callable) -> Callable[[Any], Any]:
    """A call of `learn` as `time_calls` takes it: state in, state out."""
    return lambda state: learn(state).learner_state


def synchronize(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_calls(call: Callable[[Any], Any], state: Any, warmup_calls: int, timed_calls: int,
               device: str) -> Tuple[float, Any]:
    """(seconds of `timed_calls` calls, the last state): each call takes the
    state that the one before returned; `warmup_calls` untimed calls come
    first, and the timed ones end in `torch.cuda.synchronize()`."""
    for _ in range(warmup_calls):
        state = call(state)
    synchronize(device)
    start = time.perf_counter()
    for _ in range(timed_calls):
        state = call(state)
    synchronize(device)
    return time.perf_counter() - start, state


def env_steps_per_second(config_name: str, overrides: Sequence[str], device: str,
                         updates_per_call: int, warmup_calls: int, timed_calls: int) -> float:
    """Env-steps/s of `timed_calls` learner calls of `updates_per_call` updates
    of a PPO config (`ppo_learner`), after `warmup_calls`."""
    learn, state, steps = ppo_learner(config_name, overrides, device, updates_per_call,
                                      warmup_calls + timed_calls)
    seconds, _ = time_calls(next_learner_state(learn), state, warmup_calls, timed_calls, device)
    return timed_calls * steps / seconds
