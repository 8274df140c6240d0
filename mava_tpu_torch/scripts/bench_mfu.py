"""The FLOPs, the MFU and the device's busy share of a whole training call in the
five configs of the JAX package's MFU table (port of `scripts/bench_mfu.py`).

    python -m mava_tpu_torch.scripts.bench_mfu [config ...] [--device cpu]

Configs: ff_ippo_rware (512 envs)  rec_ippo_smax (3s5z, 64 envs, chunks of 16)
         ff_ippo_cleaner_cnn (128 envs)  rec_iql_smax (2s3z, 64 envs, 32 updates a call)
         ff_isac_maswarm (64 envs, 32 updates a call, the buffer filled first)
The PPO configs run a rollout of 128 and 4 updates a call. For each config it
builds the real learner and, after one warm-up call,
  1. counts the FLOPs of one call, untimed: the matrix products and
     convolutions that run as aten ops, forward and backward, under
     `torch.utils.flop_counter.FlopCounterMode` (`matmul_flops_per_call`); and
     the GRU kernels', which that mode cannot see, because `ops/gru.py`
     launches them through ctypes and not through aten: the launches of that
     call by kernel and shape (`gru.launch_shapes`, set to 0 just before),
     each times the work of one launch, `gru.kernel_work`
     (`gru_kernel_flops_per_call`);
  2. times separate calls (5), with the loop the port's tools share: the
     counting call is not timed, since the mode slows it;
  3. builds the same learner with one update a call (a call of 32 SAC updates
     makes ~900,000 launches, more than a trace reads back in reasonable
     time), times one call of it after a warm-up, and runs one more under
     `torch.profiler`: the device's busy time in that update (the union of its
     kernels and copies, `device_busy_ms`) over the unprofiled update's time
     (`device_busy_share`; the profiler slows the host, not the kernels).
Each config prints one JSON line: config, env_steps_per_second, step_ms,
matmul_flops_per_call, gru_kernel_flops_per_call, gru_launches_per_call,
achieved_tflops (both counts over step_ms), mfu_vs_fp32_peak (against 67
TFLOP/s, an H100 SXM's fp32 rate outside the tensor cores: `start_experiment`
turns TF32 off, so every product runs in fp32), device_busy_ms,
device_busy_share, device (the card's name and power limit).

What the count leaves out. XLA's cost model, which the JAX script reads,
counts every operation of the compiled program, the elementwise ones too
(activations, the losses, Adam, the env step); this count takes only the
products. So the two packages' MFUs are not to be compared. The JAX script
also divides XLA's "bytes accessed" by the HBM rate for a roofline; no count
here gives an honest figure of the bytes that a chain of thousands of eager
launches moves, so there is no byte count and no roofline: the busy share
says instead how much of a call the card worked at all.

On the CPU (`--device cpu`, only when asked) the GRU op runs its plain
versions, whose products the mode does see (in matmul_flops_per_call; no
kernel is launched, so gru_kernel_flops_per_call is 0), and the device fields
(mfu_vs_fp32_peak, device_busy_ms, device_busy_share) are null: the peak and
the profiler's device time are the card's.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch.ops import gru
from mava_tpu_torch.scripts.common import (
    bench_config,
    device_label,
    next_learner_state,
    ppo_learner,
    synchronize,
    time_calls,
)
from mava_tpu_torch.systems.q_learning import rec_iql
from mava_tpu_torch.systems.sac import ff_isac

ROLLOUT = 128
UPDATES_PER_CALL = 4
OFFPOLICY_SCAN_STEPS = 32
WARMUP_CALLS = 1
TIMED_CALLS = 5

CONFIGS = {
    "ff_ippo_rware": ("default_ff_ippo",
                      ["env=rware", "env/scenario=tiny-2ag", "arch.num_envs=512"]),
    "rec_ippo_smax": ("default_rec_ippo",
                      ["env=smax", "env/scenario=3s5z", "arch.num_envs=64",
                       "system.recurrent_chunk_size=16"]),
    "ff_ippo_cleaner_cnn": ("default_ff_ippo",
                            ["env=cleaner", "network=cnn", "arch.num_envs=128"]),
    "rec_iql_smax": ("default_rec_iql", ["env=smax", "env/scenario=2s3z", "arch.num_envs=64"]),
    "ff_isac_maswarm": ("default_ff_isac", ["env=maswarm", "arch.num_envs=64"]),
}

Built = Tuple[Callable[[Any], Any], Any, int]  # (call: state -> state, state, env-steps a call)


def _build_rec_iql(overrides: Sequence[str], device: str, scan_steps: int) -> Built:
    config, dev = bench_config("default_rec_iql", overrides, device)
    config.system.num_updates_per_eval = scan_steps
    env, _ = environments.make(config, dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    learn, _, state = rec_iql.learner_setup(env, generator, config, dev)
    steps = scan_steps * config.system.rollout_length * config.arch.num_envs * config.arch.n_devices
    return next_learner_state(learn), state, steps


def _build_ff_isac(overrides: Sequence[str], device: str, scan_steps: int) -> Built:
    config, dev = bench_config("default_ff_isac", overrides, device)
    config.system.scan_steps = scan_steps
    explore, update, state = ff_isac.build_bench_learners(config, dev)
    state, _ = explore(state)  # fill the buffer past its minimum before counting or timing
    steps = scan_steps * config.system.rollout_length * config.arch.num_envs * config.arch.n_devices
    return next_learner_state(update), state, steps


def build(name: str, device: str, calls: int, overrides: Sequence[str] = (),
          updates_per_call: int = UPDATES_PER_CALL,
          scan_steps: int = OFFPOLICY_SCAN_STEPS) -> Built:
    """The learner of config `name` (`overrides` after its own); a PPO one's lr
    schedule spans `calls` calls."""
    default, config_overrides = CONFIGS[name]
    overrides = [*config_overrides, *overrides]
    if default == "default_rec_iql":
        return _build_rec_iql(overrides, device, scan_steps)
    if default == "default_ff_isac":
        return _build_ff_isac(overrides, device, scan_steps)
    learn, state, steps = ppo_learner(default, [f"system.rollout_length={ROLLOUT}", *overrides],
                                      device, updates_per_call, calls)
    return next_learner_state(learn), state, steps


def count_flops(call: Callable[[Any], Any], state: Any) -> Tuple[float, float, dict, Any]:
    """(aten matmul and convolution FLOPs, GRU kernel FLOPs, GRU launches by
    kernel, the state after) of one call of `call`."""
    from torch.utils.flop_counter import FlopCounterMode

    gru.reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        state = call(state)
    launches = {k: n for k, n in gru.kernel_launches.items() if n}
    return float(counter.get_total_flops()), gru.launched_flops(), launches, state


def device_busy_ms(call: Callable[[Any], Any], state: Any) -> Tuple[float, Any]:
    """(ms in which the card ran a kernel or a copy during one call, the state
    after): the union of the device's intervals in a `torch.profiler` trace.
    The device's mirror of a `record_function` span bears the span's name,
    which no kernel does; those are left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = call(state)
        torch.cuda.synchronize()
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name not in host_names]
    if not on_device:
        raise RuntimeError("bench_mfu: the profile shows no device work")
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in on_device):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3, state


def measure(name: str, device: str, overrides: Sequence[str] = (),
            updates_per_call: int = UPDATES_PER_CALL, scan_steps: int = OFFPOLICY_SCAN_STEPS,
            warmup_calls: int = WARMUP_CALLS, timed_calls: int = TIMED_CALLS) -> dict:
    """Config `name`'s record (see the module's docstring); printed and returned."""
    call, state, steps = build(name, device, warmup_calls + 1 + timed_calls, overrides,
                               updates_per_call, scan_steps)
    for _ in range(warmup_calls):
        state = call(state)
    synchronize(device)
    matmul_flops, gru_flops, launches, state = count_flops(call, state)
    seconds, state = time_calls(call, state, 0, timed_calls, device)
    step_s = seconds / timed_calls
    flops = matmul_flops + gru_flops
    record = {
        "config": name,
        "env_steps_per_second": round(steps / step_s, 1),
        "step_ms": round(step_s * 1e3, 2),
        "matmul_flops_per_call": matmul_flops,
        "gru_kernel_flops_per_call": gru_flops,
        "gru_launches_per_call": launches,
        "achieved_tflops": round(flops / step_s / 1e12, 6),
        "mfu_vs_fp32_peak": None,
        "device_busy_ms": None,
        "device_busy_share": None,
        "device": device_label(device),
    }
    if torch.device(device).type == "cuda":
        # The profile is of a learner of one update a call: a call of 32 SAC
        # updates makes ~900,000 launches, more events than a trace reads back
        # in reasonable time, and a call's updates are alike.
        one, one_state, _ = build(name, device, 3, overrides, 1, 1)
        one_s, one_state = time_calls(one, one_state, 1, 1, device)
        busy_ms, _ = device_busy_ms(one, one_state)
        record.update({
            "mfu_vs_fp32_peak": round(flops / step_s / gru.PEAK_FP32_FLOPS, 7),
            "device_busy_ms": round(busy_ms, 2),
            "device_busy_share": round(busy_ms / (one_s * 1e3), 4),
        })
    print(json.dumps(record), flush=True)
    return record


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("configs", nargs="*", help=" ".join(CONFIGS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        parser.error(f"no config {unknown}; the configs are {list(CONFIGS)}")
    for name in args.configs or CONFIGS:
        measure(name, args.device)


if __name__ == "__main__":
    main()
