#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of the repository. It
  1. prints the torch and CUDA versions and the card's name and power limit;
  2. builds the GRU kernels of `mava_tpu_torch/csrc/gru_sequence.cu` with nvcc;
  3. kernel phase: runs K1 (forward) and K2a + K2b (backward) against their
     plain PyTorch versions on the card at the shapes of the rec-IPPO slice
     (T=128, H=128, B=32 and B=16) and at ragged shapes, checks them to
     rtol = atol = 1e-4, checks that dWh and db_hn are bitwise equal across two
     backward runs, and times kernel against plain version with CUDA events;
  4. slice phase: trains rec-IPPO on RWARE tiny-2ag at the shipped network
     width (`default_rec_ippo`: 16 envs, rollout 128, 4 epochs x 2 minibatches)
     for 4 updates through `run_experiment`, and checks that every parameter is
     on the card, the losses are finite, the parameters changed and the main
     path launched the kernels (>= 17 forward and >= 16 backward launches per
     update); then runs one update through the kernels and one through the
     plain GRU from the same state and draws, and checks that they agree.
It prints one JSON line with the kernels' records, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

RTOL = ATOL = 1e-4  # fp32 kernel vs fp32 plain version: summation order differs
SLICE_OVERRIDES = [
    "system.num_updates=4",
    "arch.num_evaluation=2",
    "arch.num_eval_episodes=16",
    "arch.absolute_metric=False",
    "+arch.device=cuda",
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(t_len: int, b: int, h: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    resets = torch.rand(t_len, b, 1, generator=g, device="cuda") < 0.1
    keep = (1.0 - resets.float()).expand(t_len, b, h).contiguous()
    args = (rnd(t_len, b, 3 * h), keep, rnd(b, h), rnd(h, 3 * h) / h**0.5, 0.1 * rnd(h))
    return args, rnd(t_len, b, h)


def max_errs(got: torch.Tensor, want: torch.Tensor):
    diff = (got - want).abs()
    return diff.max().item(), (diff / want.abs().clamp(min=1e-6)).max().item()


def kernel_phase(gru) -> dict:
    """Kernel vs plain version at the slice's shapes and at ragged ones."""
    shapes = [(128, 32, 128), (128, 16, 128), (7, 5, 128), (9, 3, 256)]
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for t_len, b, h in shapes:
        args, g_hs = gru_inputs(t_len, b, h, seed=t_len * 1000 + b)
        hs = gru.gru_sequence_forward(*args)
        hs_ref = gru.gru_sequence_reference(*args)
        grads = gru.gru_sequence_backward(*args, hs, g_hs)
        grads_ref = gru.gru_sequence_backward_reference(*args, hs, g_hs)
        torch.cuda.synchronize()
        outs = [("hs", hs, hs_ref, "fwd")] + [
            (n, k, r, "bwd") for n, k, r in zip(("dgates_i", "dh0", "dWh", "db_hn"), grads, grads_ref)
        ]
        for name, got, want, which in outs:
            abs_err, rel_err = max_errs(got, want)
            errs[which] = max(errs[which], abs_err)
            print(f"  T={t_len} B={b} H={h} {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}")
            check(torch.isfinite(got).all().item(), f"{name} not finite at {(t_len, b, h)}")
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL), f"{name} disagrees at {(t_len, b, h)}")
        again = gru.gru_sequence_backward(*args, hs, g_hs)
        check(torch.equal(again[2], grads[2]) and torch.equal(again[3], grads[3]),
              f"dWh / db_hn not bitwise equal across runs at {(t_len, b, h)}")
        if t_len == 128:
            # Plain, kernel, kernel, plain: both orders on one card.
            fwd = lambda: gru.gru_sequence_forward(*args)  # noqa: E731
            fwd_ref = lambda: gru.gru_sequence_reference(*args)  # noqa: E731
            bwd = lambda: gru.gru_sequence_backward(*args, hs, g_hs)  # noqa: E731
            bwd_ref = lambda: gru.gru_sequence_backward_reference(*args, hs, g_hs)  # noqa: E731
            p1, k1, k2, p2 = time_ms(fwd_ref), time_ms(fwd), time_ms(fwd), time_ms(fwd_ref)
            bp1, bk1, bk2, bp2 = time_ms(bwd_ref), time_ms(bwd), time_ms(bwd), time_ms(bwd_ref)
            times[b] = {"fwd": (k1 + k2) / 2, "fwd_plain": (p1 + p2) / 2,
                        "bwd": (bk1 + bk2) / 2, "bwd_plain": (bp1 + bp2) / 2}
            print(f"  T={t_len} B={b} H={h} ms: fwd kernel {times[b]['fwd']:.4f} plain "
                  f"{times[b]['fwd_plain']:.4f} | bwd kernel {times[b]['bwd']:.4f} plain "
                  f"{times[b]['bwd_plain']:.4f}")
    return {"errs": errs, "times": times}


def slice_phase(gru, gpu: str) -> dict:
    """rec-IPPO through run_experiment, then kernel vs plain for one update."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.systems.ppo import rec_ippo
    from mava_tpu_torch.utils.config import load_config

    config = load_config("default_rec_ippo", SLICE_OVERRIDES)
    device = torch.device("cuda")
    env, _ = environments.make(config, device)
    initial = [p.detach().clone() for net in rec_ippo.make_networks(env, config, device, config.system.seed)
               for p in net.parameters()]

    gru.fwd_launches = gru.bwd_launches = 0
    start = time.perf_counter()
    performance, output = rec_ippo.run_experiment(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"fwd": gru.fwd_launches, "bwd": gru.bwd_launches}

    updates = config.system.num_updates
    actor, critic = output.learner_state.params
    final = [p.detach() for net in (actor, critic) for p in net.parameters()]
    check(all(p.device.type == "cuda" for p in final), "a parameter is not on the card")
    for name, values in output.train_metrics.items():
        check(torch.isfinite(values).all().item(), f"loss {name} not finite")
    changed = [not torch.equal(a, b) for a, b in zip(initial, final)]
    check(all(changed), f"parameters unchanged after training: {changed}")
    check(launches["fwd"] >= 17 * updates, f"forward kernel launched {launches['fwd']} times")
    check(launches["bwd"] >= 16 * updates, f"backward kernel launched {launches['bwd']} times")
    print(f"  run_experiment: {updates} updates, eval return {performance:.3f}, "
          f"{wall:.1f} s wall, launches {launches}")

    # One update through the kernels and one through the plain GRU, from the
    # same seed, generator stream and therefore the same rollout.
    results = {}
    for impl in ("pallas", "hoisted"):
        cfg = load_config("default_rec_ippo", SLICE_OVERRIDES + [f"network.gru_impl={impl}"])
        cfg.arch.n_devices = 1
        cfg.system.recurrent_chunk_size = cfg.system.rollout_length
        cfg.system.num_updates_per_eval = 1
        env, _ = environments.make(cfg, device)
        gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
        learn, _, state = rec_ippo.learner_setup(env, gen, cfg, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = learn(state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        params = [p.detach() for net in out.learner_state.params for p in net.parameters()]
        results[impl] = (seconds, params, out.train_metrics)
    steps = cfg.system.rollout_length * cfg.arch.num_envs
    param_err = max((a - b).abs().max().item() for a, b in zip(results["pallas"][1], results["hoisted"][1]))
    kernel_losses, plain_losses = results["pallas"][2], results["hoisted"][2]
    loss_err = max((kernel_losses[k] - plain_losses[k]).abs().max().item() for k in plain_losses)
    print(f"  one update, kernels vs plain GRU: max |param diff| {param_err:.3e}, "
          f"max |loss diff| {loss_err:.3e}")
    check(param_err <= 1e-3, "kernel and plain updates disagree on the parameters")
    check(all(torch.allclose(kernel_losses[k], plain_losses[k], rtol=1e-3, atol=1e-5)
              for k in plain_losses), "kernel and plain updates disagree on the losses")
    for impl, label in (("pallas", "kernels"), ("hoisted", "plain GRU")):
        seconds = results[impl][0]
        print(f"  update with {label}: {seconds * 1e3:.1f} ms, "
              f"{steps / seconds:.0f} env-steps/s on {gpu}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    try:
        from mava_tpu_torch.ops import gru
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e}).", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(gpu)

    start = time.perf_counter()
    gru.build_kernels()
    print(f"build: {time.perf_counter() - start:.1f} s")
    if gru.build_log:
        print(gru.build_log.strip())

    print("kernel phase:")
    kernels = kernel_phase(gru)
    print("slice phase:")
    sliced = slice_phase(gru, gpu)

    times = kernels["times"][16]
    record = {"kernels": [
        {"name": "gru_sequence_fwd (K1)", "route": "cuda",
         "source": "mava_tpu_torch/csrc/gru_sequence.cu",
         "replaces": "mava_tpu/ops/pallas_gru.py:69",
         "launches": sliced["launches"]["fwd"], "max_abs_err": kernels["errs"]["fwd"],
         "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "gru_sequence_bwd (K2a + K2b)", "route": "cuda",
         "source": "mava_tpu_torch/csrc/gru_sequence.cu",
         "replaces": "mava_tpu/ops/pallas_gru.py:88",
         "launches": sliced["launches"]["bwd"], "max_abs_err": kernels["errs"]["bwd"],
         "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]}
    print(gpu)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
