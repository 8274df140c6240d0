#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile | --seeds | --offpolicy | --distributed | --programs |
                           --dynamics]

Run from the root of the repository. It
  1. prints the torch and CUDA versions and the card's name and power limit;
  2. builds the GRU kernels of `mava_tpu_torch/csrc/gru_sequence.cu` with nvcc,
     twice in parallel: as the port runs them, and with per-phase clock marks;
  3. kernel phase: runs K1 (forward), K2p (gate recompute), K2a (reverse
     recurrence) and K2b (dWh / db_hn reduction: partial sums over slices of the
     rows, then their sum in slice order) against their plain PyTorch versions
     on the card at the shapes of the rec-IPPO slice (T=128, H=128, B=32 and
     B=16), at ragged shapes and at shapes of every route, checks them to rtol =
     atol = 1e-4, checks that every gradient is bitwise equal across runs, and
     prints which route and row split each shape took. K2p and K2b are checked
     and timed at two further shapes with 4x and 16x the rows, and K2b with one
     slice and with more slices than chunks of rows. The stacked K1 (a leading
     stack axis of inputs and weights, `keep` shared) is checked on both routes
     at rec-IQL's target pass (S=2, T=20, B=256) and a ragged B, and a stack of
     one against the unstacked K1 bitwise. Every kernel, plain
     version and library call (the cuDNN GRU through `torch.nn.GRU`, `torch.mm`
     for K2b, `torch.sum` for its second kernel; the port never calls them) is
     timed twice: device-only (`device_ms`: calls captured into a CUDA graph,
     replays timed with events) and host-inclusive (`time_ms`: eager calls), K1
     and K2a on the streaming route too. It computes each kernel's roofline
     bound from the shape and prints the cycles per step and phase of the
     resident K1 and K2a. The stacked K1 is timed beside its bound, two
     unstacked K1 calls and two cuDNN forwards; K1, K2p, K2a and K2b also at
     the shapes of the SMAX, rec-IQL and MaConnector rCNN paths (T=128 B=128,
     T=128 B=64, T=20 B=256; T=128 B=160, 80, 48 and 24), checked against their
     plain versions there, with the clusters each resident launch asks for and
     the card holds at once (`cudaOccupancyMaxActiveClusters`);
  4. slice phase: trains rec-IPPO on RWARE tiny-2ag at the shipped network
     width (`default_rec_ippo`: 16 envs, rollout 128, 4 epochs x 2 minibatches)
     for 4 updates through `run_experiment`, and checks that every parameter is
     on the card, the losses are finite, the parameters changed and the main
     path launched every kernel (>= 17 forward and >= 16 backward launches per
     update); then runs updates through the kernels and through the plain GRU
     from the same state and draws, checks that they agree, and reports
     env-steps/s of the update on the resident and on the streaming kernels;
  5. rec-MAPPO phase: the same for `default_rec_mappo` (a centralised recurrent
     critic on the global state) through `rec_mappo.run_experiment`, with the
     launch counts set to 0 just before: exactly 17 forward and 16 of each
     backward kernel per update; one update on the kernels against one on the
     plain GRU;
  6. SMAX phase: rec-MAPPO on SMAX 3s5z (`env=smax env/scenario=3s5z`: 8 agents,
     13 actions, 175 + 8 observation features, a 160-wide world state) through
     `rec_mappo.run_experiment`, 4 updates with exactly 17 forward and 16 of each
     backward kernel an update and its eval win rate; one update on the kernels
     against one on the plain GRU; env-steps/s; one update under
     `torch.profiler` (launches per rollout step, idle share);
  7. rec-IQL phase: `default_rec_iql` on SMAX 3s5z through
     `rec_iql.run_experiment`, 50 updates with exactly 2 stacked forwards (the
     fused double-DQN target pass, S = 2, T = 20, B = 256), 2 forwards and 2 of
     each backward kernel an update; the fused target pass against the unfused
     one on the same sampled sequences; env-steps/s and mean Q; one update under
     `torch.profiler`;
  8. grid phase: rec-MAPPO with `network=rcnn` (CNN [32, 32] 3x3 -> GRU H =
     128 -> MLP [128]) on MaConnector con-10x10x10a at the shipped system
     config, 2 updates through `rec_mappo.run_experiment` with exactly 17
     forward and 16 of each backward kernel an update (B = 160 on the critic
     pass, 80 in the losses), one update on the kernels against one on the
     plain GRU; then 2 updates each of ff-IPPO `network=cnn` on Cleaner
     clean-10x10x10a, ff-MAPPO on LBF 8x8-2p-2f-coop and ff-IPPO on Gigastep
     hide_and_seek_5_vs_5_fobs (no GRU kernel). Each: env-steps/s, launches per
     rollout step and idle share of one profiled update, peak memory on the card;
  9. SAC phase: `default_ff_isac` and `default_ff_masac` on MaSwarm spread-3ag as
     shipped (16 envs, rollout 2, 32 epochs, delay 4, batch 32, the
     1,000,000-item buffer on the card) through their `run_experiment`: the
     4,992-step explore phase and two rounds of 4 updates, every parameter
     changed, no GRU kernel launched (the SAC path runs only MLPs); then from a
     fresh state the explore phase, 4 timed updates and one under
     `torch.profiler` (spans `sac/act`, `sac/train`): env-steps/s, launches per
     update and per train step, the device's idle share; the same for one
     ff-ISAC update on MaReacher reacher-2x1 after one batch explored;
  10. articulated phase: for each of MaSwimmer swimmer-2x1, MaHopper hopper-3x1,
     MaCheetah halfcheetah-6x1, MaWalker walker2d-2x3, MaAnt ant-4x2 and
     MaHumanoid humanoid-9-8, one step of 16 envs on the card against the same
     step on the CPU (rtol = atol = 1e-4), the step's host ms, launches and host
     syncs (none allowed) and the trace time of its q̈; ff-ISAC on each through
     `run_experiment` (16 envs, rollout 2, 32 epochs, delay 4, batch 32, the
     1,000,000-item buffer on the card; cut in depth: one batch explored, one
     round of one update, episodes of 2 steps) with every parameter changed and
     no GRU launch and the run's peak memory; on MaHopper one more update,
     timed and profiled (launches per act and train step, idle share);
     ff-MASAC the same on MaHumanoid and MaHopper, without the timed update;
     continuous ff-IPPO on
     MaWalker (rollout cut to 8, 2 updates; one update of rollout 1 profiled
     for the launches per rollout step and the idle share);
  11. resume phase: rec-IPPO on SMAX 3s5z at the shipped width with 64 envs
     through `run_experiment`, 4 updates straight against 2 saved with
     `logger.checkpointing.save_full_state` and 2 resumed in a fresh run with
     `load_full_state`: parameters, optimizer moments, generators, env and
     hidden states bitwise equal, exactly 17 K1 and 16 of each backward kernel
     an update; one ff-ISAC update on MaSwarm resumed from a full state with a
     4,096-item buffer, bitwise; ff-IPPO on RWARE tiny-2ag with
     `arch.stagger_resets=True`: the spread of the envs' step counts after the
     burn-in, the setup's seconds, one update;
  12. seed phase: the stacked GRU kernels of the seed programs (the stacked K1
     with a keep per entry, K2p, K2a and K2b with the stack entry as one more
     grid dimension) against their plain versions at S = 4 and 8 on the SMAX
     3s5z path shapes (T = 128, B = 128 and 64), gradients bitwise repeatable,
     timed beside S unstacked calls, their bounds and S cuDNN backward calls;
     `rec_ippo_vmap_seeds.run_experiment` at S = 4 on SMAX 3s5z at the shipped
     width, 2 updates with exactly 17 stacked K1 and 16 of each stacked
     backward kernel an update (and no unstacked launch); one stacked update
     against 4 stock updates from the same draws (parameters within 1e-4); an
     ff-IPPO sweep of 4 lrs and a rec-IPPO PBT of 4 members with one exploit
     step, cut in depth; the launches of a whole stacked update at S = 8
     against S = 1 (at most 1.5x) and env-steps/s at S = 1, 4, 8 beside one
     stock update, at a rollout of 32;
  13. off-policy seed phase: the stacked K1 over 2S = 8 entries at rec-IQL's
     target pass (T = 20, B = 256, H = 128; each online/target pair with its
     seed's keep) and the stacked K1 and backward over S = 4 at its loss pass,
     against their plain versions, bitwise repeatable, timed beside their
     bounds, 2S (or S) unstacked calls, 2S cuDNN forwards or S cuDNN backwards,
     with the clusters asked against those held; `rec_iql_vmap_seeds` through
     `run_experiment` at S = 4 on SMAX 3s5z, 2 updates with exactly 4 stacked
     K1 and 2 of each stacked backward kernel an update (no unstacked launch);
     one stacked update against 4 stock ones from the same draws (1e-4);
     `ff_isac_vmap_seeds` (S = 4) and `ff_masac_vmap_sweep` (4 lrs) on MaSwarm
     through `run_experiment`, cut in depth (`SAC_VMAP_CUTS`); env-steps/s at
     S = 1, 4, 8 and the launches of an update at S = 8 against S = 1 (at most
     1.5x) for rec-IQL and ff-ISAC, beside one stock update; the ring
     writes' share of a stacked act step's host ms; the ring's bytes an entry
     and the peak memory; `ff_ippo_store_experience` writing a vault (under
     `build/`) and `examples.bc_from_vault` cloning from it;
  14. feed-forward phase: `default_ff_ippo` and `default_ff_mappo` as shipped, 4
     updates each through their `run_experiment` with the same health checks
     (they reach no hand-written kernel), three timed ff-IPPO updates, ff-IPPO on
     Matrax Penalty-25 for 30 updates with its eval return, and a short run of
     the bench program (`bench_torch.run` at 512 envs);
  15. programs phase: the quickstart (`examples/quickstart.py`'s `main()` at
     its defaults, LBF 2s-8x8-2p-2f-coop at 128 envs, cut in depth to 131,072
     env-steps and 2 evaluations: its final eval return finite), then the
     tools of `mava_tpu_torch/scripts/`: `bench_suite` on rec_mappo_smax (1
     update a call, 1 warm-up and 1 timed call; exactly 17 K1 and 16 of each
     backward kernel an update), `bench_mfu` on rec_ippo_smax and
     rec_iql_smax (1 update and 8 updates a call, 1 timed; the launches of its counting
     call exact, GRU and matmul FLOPs > 0, 0 < MFU <= 1, the busy share),
     `bench_envs_sweep` at 16 and 64 envs, `bench_vmap_seeds` at S = 2 and
     `run_seeds` over 2 seeds of ff-IPPO on Matrax, each number beside the
     card's name and power limit;
  16. distributed phase (data parallelism over ranks, `parallel/`): rec-IPPO
     on RWARE tiny-2ag at the shipped width through `python -m
     torch.distributed.run --standalone --nproc-per-node=1` (a subprocess: 2
     updates and one evaluation under NCCL; its exit code and "completed"
     line); then in this process a world-1 NCCL group (`tcp://localhost`, a
     free port): one data-parallel update against one stock update from the
     same state and draws (parameters and losses bitwise equal), exactly 17
     K1, 16 of each backward kernel and 8 all-reduces (one a minibatch step,
     counted with `torch.profiler`) an update, the all-reduces' device and
     host ms an update and both updates' env-steps/s; the recording program
     (`ff_ippo_store_experience`, RWARE tiny-2ag as shipped, 2 updates in 2
     rounds) through torchrun at world 1, whose vault, read back, equals the
     same learner's trajectories gathered in this process by
     `gather_env_rows` (bitwise, else within 1e-6, with one gather a round
     and the vault's bytes a round); one stacked `ff_ippo_vmap_sweep` update
     of 2 lrs with `arch.stagger_resets=True`, whose entries start from
     bitwise-equal staggered envs (a seed group of one rank: no all-reduce);
     the group is destroyed
     after it, so it runs last;
  17. with `--profile`: one full-width rec-IPPO update and one ff-IPPO update at
     512 envs under `torch.profiler`: host ms, launches and kernel ms per span,
     launches per rollout step, per-kernel totals and the device's idle share.
`--seeds` builds the kernels and runs only the seed phase, `--offpolicy` only
the off-policy seed phase, `--distributed` only the distributed phase,
`--programs` only the programs phase. `--dynamics` runs
only two measurements of `envs/_dynamics.py` and exits:
MaReacher with the checked solve of the parent against the unchecked one, and
tracing a whole RK4 substep against tracing q̈ alone (`dynamics_ab`).
It prints one JSON line with the kernels' records, then, as its last line,
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import torch
from torch.utils import _pytree as pytree

# The work of a kernel launch and the card's peaks are reckoned in the op's
# module, which the MFU bench shares; re-exported here under their old names.
from mava_tpu_torch.ops.gru import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, kernel_work

RTOL = ATOL = 1e-4  # fp32 kernel vs fp32 plain version: summation order differs
SLICE_OVERRIDES = [
    "system.num_updates=4",
    "arch.num_evaluation=1",
    "arch.num_eval_episodes=16",
    "arch.absolute_metric=False",
    "+arch.device=cuda",
]
SOURCE = "mava_tpu_torch/csrc/gru_sequence.cu"
SLICE_SHAPES = [(128, 16, 128), (128, 32, 128)]
# rec-MAPPO on SMAX 3s5z (16 envs x 8 agents): the critic pass and the losses;
# rec-IQL's loss pass (32 sequences of 20 steps x 8 agents); rec-MAPPO with rCNN
# on MaConnector con-10x10x10a (16 envs x 10 agents) and con-5x5x3a (16 x 3: 24
# rows fill half of a cluster's 16).
PATH_SHAPES = [(128, 128, 128), (128, 64, 128), (20, 256, 128),
               (128, 160, 128), (128, 80, 128), (128, 48, 128), (128, 24, 128)]
# The stacked K1 of rec-IQL's fused target pass (S, T, B, H), and a ragged B.
STACKED_SHAPES = [(2, 20, 256, 128), (2, 20, 250, 128)]
SMAX = ["env=smax", "env/scenario=3s5z"]
# The grid phase: rec-MAPPO with rCNN (CNN [32, 32] 3x3 -> GRU H = 128 -> MLP
# [128]) on MaConnector, then the feed-forward paths of the other new envs.
CONNECTOR = ["env=connector", "env/scenario=con-10x10x10a", "network=rcnn"]
GRID_FF = [
    ("ff-IPPO cnn on Cleaner clean-10x10x10a", "ff_ippo",
     ["env=cleaner", "env/scenario=clean-10x10x10a", "network=cnn"]),
    ("ff-MAPPO on LBF 8x8-2p-2f-coop", "ff_mappo", ["env=lbf", "env/scenario=8x8-2p-2f-coop"]),
    ("ff-IPPO on Gigastep hide_and_seek_5_vs_5_fobs", "ff_ippo",
     ["env=gigastep", "env/scenario=hide_and_seek_5_vs_5_fobs"]),
]
# Each grid run trains 2 updates through run_experiment (4 before the off-policy
# seed phase came), then times 2 more and profiles one.
GRID_CUT = ["system.num_updates=2"]
IQL_UPDATES = 50  # 200 until PR 8, cut to make room for the articulated phase
SHAPES = SLICE_SHAPES + [(7, 5, 128), (9, 3, 256), (33, 17, 128), (5, 40, 256), (6, 4, 72),
                         (3, 2, 512)]
# K2p and K2b alone, to show how the tiles and the row split scale: 16x and 4x the rows.
TILE_SHAPES = [(128, 256, 128), (128, 64, 256)]
# name in the record, counter in `gru.kernel_launches`, reference kernel, launches per
# rec-IPPO / rec-MAPPO update
KERNELS = [
    ("gru_sequence_fwd (K1)", "fwd", "mava_tpu/ops/pallas_gru.py:69", 17),
    ("gru_sequence_bwd_gates (K2p)", "bwd_gates", "mava_tpu/ops/pallas_gru.py:88", 16),
    ("gru_sequence_bwd_recurrence (K2a)", "bwd_recurrence", "mava_tpu/ops/pallas_gru.py:88", 16),
    ("gru_sequence_bwd_reduce (K2b)", "bwd_reduce", "mava_tpu/ops/pallas_gru.py:88", 16),
    ("gru_sequence_bwd_reduce_sum (K2b, sum of the slices)", "bwd_reduce_sum",
     "mava_tpu/ops/pallas_gru.py:88", 16),
    ("gru_sequence_fwd_stacked (K1 over a stack axis)", "fwd_stacked",
     "mava_tpu/ops/pallas_gru.py:69 (vmapped at mava_tpu/systems/q_learning/rec_iql.py:183)", 0),
]
# launches per rec-IQL update (epochs = 2): the fused target pass and the loss pass
IQL_PER_UPDATE = {"fwd": 2, "bwd_gates": 2, "bwd_recurrence": 2, "bwd_reduce": 2,
                  "bwd_reduce_sum": 2, "fwd_stacked": 2}
# K2p and K2b as they stood before their redesign (one block per 32x32 tile), read
# with `device_ms` / `time_ms` of this script on that tree: NVIDIA H100 80GB HBM3,
# 700.00 W, T=128, H=128, ms at B=16 / B=32. Those kernels are gone from the source.
BEFORE_REDESIGN_MS = {
    "bwd_gates": {"device": (0.0228, 0.0375), "host": (0.0734, 0.0641)},
    "bwd_reduce": {"device": (0.1904, 0.3794), "host": (0.1962, 0.3863)},
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Host-inclusive ms of one eager call: what a caller pays who launches from
    Python, one call after the other. For a kernel shorter than the wrapper's
    host work this reads the host's rate."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 10, stream=None) -> float:
    """Device-only ms of one call of `fn`: `iters` calls are captured into one CUDA
    graph on a side stream (`stream`, where `fn` needs a particular one) and the
    graph's replays are timed with events, so no host work sits between the
    launches. Inputs and outputs stay in L2 from call to call, as they do for the
    op's real caller. The same method times kernels, plain versions and library
    calls."""
    stream = stream or torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def abba_ms(a, b, timer=time_ms):
    """Times of `a` and `b`, each the mean of two turns taken as a, b, b, a."""
    a1, b1, b2, a2 = timer(a), timer(b), timer(b), timer(a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def on_streaming(gru, fn):
    """`fn` with every call of the op sent to the streaming kernels."""
    def run():
        gru.forced_route = gru.STREAMING
        try:
            return fn()
        finally:
            gru.forced_route = None
    return run


def gru_inputs(t_len: int, b: int, h: int, seed: int, resets: float = 0.1, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    reset = torch.rand(t_len, b, 1, generator=g, device=device) < resets
    keep = (1.0 - reset.float()).expand(t_len, b, h).contiguous()
    args = (rnd(t_len, b, 3 * h), keep, rnd(b, h), rnd(h, 3 * h) / h**0.5, 0.1 * rnd(h))
    return args, rnd(t_len, b, h)


# ------------------------------------------------------------------ bounds
def bound_ms(kernel: str, t_len: int, b: int, h: int, slices: int = 1, stack: int = 1,
             shared_keep: bool = True):
    """(least ms the card could take, which resource sets it)."""
    flop, nbytes = kernel_work(kernel, t_len, b, h, slices, stack, shared_keep)
    by_flop, by_bytes = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_flop, "operations") if by_flop >= by_bytes else (by_bytes, "bytes")


def serial_floor_ms(t_len: int, h: int, cluster: int, sm_mhz: float, chain_cycles: float):
    """T times the shortest step of a design that splits H over `cluster` SMs:
    the FMA issue of one SM's share of 16 rows x H x 3H (128 FMA a cycle), plus
    `chain_cycles` for what cannot overlap it (the gate math's transcendentals
    and one hand-off between the SMs). Returns (ms, FMA cycles per step)."""
    fma_cycles = 16 * h * 3 * h / cluster / 128
    return t_len * (fma_cycles + chain_cycles) / (sm_mhz * 1e3), fma_cycles


# ------------------------------------------------------------------ yardstick
def cudnn_gru(w_h: torch.Tensor, b_hn: torch.Tensor) -> torch.nn.GRU:
    """`torch.nn.GRU` computing `gru_sequence` at keep == 1 on input gates_i:
    gate order (r, z, n), b_hn inside r * (...), h' = (1-z) n + z h are shared;
    weight_ih = I(3H), bias_ih = 0, weight_hh = Wh^T, bias_hh = [0, 0, b_hn]. On
    a CUDA device it runs cuDNN. A yardstick only: the port never calls it."""
    h = w_h.shape[0]
    rnn = torch.nn.GRU(input_size=3 * h, hidden_size=h).to(w_h.device)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(3 * h))
        rnn.bias_ih_l0.zero_()
        rnn.weight_hh_l0.copy_(w_h.T)
        rnn.bias_hh_l0.zero_()
        rnn.bias_hh_l0[2 * h:] = b_hn
    rnn.weight_ih_l0.requires_grad_(False)
    rnn.bias_ih_l0.requires_grad_(False)
    return rnn


def cudnn_gru_backward(rnn: torch.nn.GRU, gates_i, h0, g_hs):
    """(hs, (dgates_i, dh0, dWh, db_hn)) through `rnn` and autograd; the last
    element is a function that runs the backward alone again."""
    h = h0.shape[-1]
    gates_i, h0 = gates_i.detach().requires_grad_(), h0.detach().requires_grad_()
    hs, _ = rnn(gates_i, h0[None])
    leaves = [gates_i, h0, rnn.weight_hh_l0, rnn.bias_hh_l0]
    backward = lambda: torch.autograd.grad(hs, leaves, g_hs, retain_graph=True)  # noqa: E731
    dg, dh0, dw_hh, db_hh = backward()
    return hs.detach(), (dg, dh0, dw_hh.T, db_hh[2 * h:]), backward


# ------------------------------------------------------------------ kernel phase
def compare(name: str, got, want, shape, errs: dict, key: str, atol: float = ATOL) -> None:
    diff = (got - want).abs()
    abs_err = diff.max().item()
    rel_err = (diff / want.abs().clamp(min=1e-6)).max().item()
    errs[key] = max(errs.get(key, 0.0), abs_err)
    print(f"  T={shape[0]} B={shape[1]} H={shape[2]} {name}: max_abs_err={abs_err:.3e} "
          f"max_rel_err={rel_err:.3e}")
    check(torch.isfinite(got).all().item(), f"{name} not finite at {shape}")
    check(torch.allclose(got, want, rtol=RTOL, atol=atol), f"{name} disagrees at {shape}")


def check_reduce(gru, keep, h0, hs, dgh, shape, errs: dict, tag: str, slices=None) -> None:
    """K2b's two kernels, each against its plain version, and the two together
    against the plain product; dWh and db_hn bitwise equal over three runs."""
    h = shape[2]
    split = gru.reduce_split(*shape, slices)
    tag = f"{tag} S={split.slices}"
    # A slice is one running fp32 sum, whose rounding error grows with its length.
    # The rule's slices stay under 2048 rows at every shape here and are held to
    # ATOL; a forced single slice over 16x the rows gets 16x the room.
    atol = ATOL * max(1.0, min(shape[0] * shape[1], split.rows_per_slice) / 2048)
    check(slices is not None or atol == ATOL, f"the rule's slices are too long at {shape}")
    partials = gru.gru_backward_reduce_partials(keep, h0, hs, dgh, slices)
    partials_ref = gru.gru_backward_reduce_partials_reference(keep, h0, hs, dgh, split)
    key = "bwd_reduce" if slices is None else "bwd_reduce_forced_slices"
    compare("K2b partials" + tag, partials, partials_ref, shape, errs, key, atol)
    for name, g, w in zip(("dWh", "db_hn"), gru.gru_backward_reduce_sum(partials_ref, h),
                          gru.gru_backward_reduce_sum_reference(partials_ref, h)):
        compare(f"K2b sum {name}{tag}", g, w, shape, errs, "bwd_reduce_sum")
    runs = [gru.gru_backward_reduce(keep, h0, hs, dgh, slices) for _ in range(3)]
    for name, g, w in zip(("dWh", "db_hn"), runs[0],
                          gru.gru_backward_reduce_reference(keep, h0, hs, dgh)):
        compare(f"K2b {name}{tag}", g, w, shape, errs, key, atol)
    check(all(torch.equal(a, g) for run in runs[1:] for a, g in zip(run, runs[0])),
          f"K2b not bitwise equal across three runs at {shape}{tag}")


def check_tile_shape(gru, shape, errs: dict) -> None:
    """K2p and K2b alone at a shape with many rows, on what the kernels before
    them produce: hs from K1, dgh from K2a (both checked at `SHAPES`). K2b with
    its own row split, with one slice and with more slices than chunks of rows."""
    t_len, b, h = shape
    args, g_hs = gru_inputs(*shape, seed=t_len * 1000 + b)
    hs = gru.gru_sequence_forward(*args)
    gates_ref = gru.gru_backward_gates_reference(*args, hs)
    compare("gates", gru.gru_backward_gates(*args, hs), gates_ref, shape, errs, "bwd_gates")
    dgh = gru.gru_backward_recurrence(*args, hs, g_hs, gates_ref)[1]
    chunks = -(-t_len * b // gru.REDUCE_CHUNK)
    for slices in (None, 1, chunks + 3):
        check_reduce(gru, args[1], args[2], hs, dgh, shape, errs, "", slices)
    torch.cuda.synchronize()


def check_shape(gru, shape, errs: dict) -> None:
    """Every kernel against its plain version on the same inputs, on `shape`'s route."""
    t_len, b, h = shape
    route = gru.kernel_route(*shape)
    built = gru.built_route(h)
    split = gru.reduce_split(*shape)
    print(f"  T={t_len} B={b} H={h} route: {route.route}, cluster {route.cluster}, "
          f"{route.blocks} blocks; K1 {route.fwd_threads} threads {route.fwd_smem} B shared, "
          f"K2a {route.bwd_threads} threads {route.bwd_smem} B shared; K2b {split.tiles} tiles x "
          f"{split.slices} slices of {split.rows_per_slice} rows")
    check(route.fwd_smem <= gru.SMEM_LIMIT and route.bwd_smem <= gru.SMEM_LIMIT, "shared memory")
    if route.route == "resident":
        check(built == (route.cluster, route.fwd_threads, route.fwd_smem, route.bwd_threads,
                        route.bwd_smem), f"kernel_route and the library disagree at H={h}: {built}")
    else:
        check(built is None, f"the library has resident kernels for H={h}, kernel_route does not")
    for resets in (0.1, 0.0):
        args, g_hs = gru_inputs(*shape, seed=t_len * 1000 + b, resets=resets)
        tag = "" if resets else " keep==1"
        hs_ref = gru.gru_sequence_reference(*args)
        compare("hs" + tag, gru.gru_sequence_forward(*args), hs_ref, shape, errs, "fwd")
        gates_ref = gru.gru_backward_gates_reference(*args, hs_ref)
        compare("gates" + tag, gru.gru_backward_gates(*args, hs_ref), gates_ref, shape, errs,
                "bwd_gates")
        got = gru.gru_backward_recurrence(*args, hs_ref, g_hs, gates_ref)
        want = gru.gru_backward_recurrence_reference(gates_ref, args[1], args[2], args[3], hs_ref,
                                                     g_hs)
        for name, g, w in zip(("dgates_i", "dgh", "dh0"), got, want):
            compare(f"K2a {name}{tag}", g, w, shape, errs, "bwd_recurrence")
        check_reduce(gru, args[1], args[2], hs_ref, want[1], shape, errs, tag)
        # The whole backward as the op runs it, against the plain reverse loop.
        grads = gru.gru_sequence_backward(*args, hs_ref, g_hs)
        grads_ref = gru.gru_sequence_backward_reference(*args, hs_ref, g_hs)
        for name, g, w in zip(("dgates_i", "dh0", "dWh", "db_hn"), grads, grads_ref):
            compare(name + tag, g, w, shape, errs, "bwd")
        again = gru.gru_sequence_backward(*args, hs_ref, g_hs)
        check(all(torch.equal(a, g) for a, g in zip(again, grads)),
              f"gradients not bitwise equal across runs at {shape}")
    torch.cuda.synchronize()


def time_shape(gru, shape) -> dict:
    """ms of every kernel, plain version and library call at one of the slice's
    shapes: `name` is the device-only time (`device_ms`), `name_host` the
    host-inclusive time of eager calls (`time_ms`)."""
    t_len, b, h = shape
    out = {}

    def both(name, fn, iters=20):
        out[name] = device_ms(fn, iters=iters)
        out[name + "_host"] = time_ms(fn, iters=iters)

    for resets, tag in ((0.1, ""), (0.0, "_keep1")):
        args, g_hs = gru_inputs(*shape, seed=t_len * 1000 + b, resets=resets)
        hs = gru.gru_sequence_forward(*args)
        gates = gru.gru_backward_gates(*args, hs)
        dgh = gru.gru_backward_recurrence(*args, hs, g_hs, gates)[1]
        fwd = lambda: gru.gru_sequence_forward(*args)  # noqa: E731
        recurrence = lambda: gru.gru_backward_recurrence(*args, hs, g_hs, gates)  # noqa: E731
        bwd = lambda: gru.gru_sequence_backward(*args, hs, g_hs)  # noqa: E731
        for name, fn in (("fwd", fwd), ("bwd_recurrence", recurrence), ("bwd", bwd)):
            streamed = on_streaming(gru, fn)
            out[name + tag], out[f"{name}_streaming{tag}"] = abba_ms(fn, streamed, device_ms)
            out[f"{name}{tag}_host"], out[f"{name}_streaming{tag}_host"] = abba_ms(fn, streamed)
        both("bwd_gates" + tag, lambda: gru.gru_backward_gates(*args, hs))
        both("bwd_reduce" + tag, lambda: gru.gru_backward_reduce(args[1], args[2], hs, dgh))
        partials = gru.gru_backward_reduce_partials(args[1], args[2], hs, dgh)
        both("bwd_reduce_partials" + tag,
             lambda: gru.gru_backward_reduce_partials(args[1], args[2], hs, dgh))
        both("bwd_reduce_sum" + tag, lambda: gru.gru_backward_reduce_sum(partials, h))
        if resets:
            # What K2b is made of: other counts of slices than the rule's, and its
            # first kernel with the FMAs or the loads taken out (device-only).
            chosen = gru.reduce_split(*shape).slices
            for slices in (11, 22, 44, 64):
                out[f"bwd_reduce_S{slices}"] = device_ms(
                    lambda: gru.gru_backward_reduce(args[1], args[2], hs, dgh, slices))
            out[f"bwd_reduce_S{chosen}"] = out["bwd_reduce"]
            for probe, what in ((1, "reads_no_fma"), (2, "first_loads_only")):
                out["bwd_reduce_partials_" + what] = device_ms(
                    lambda: gru.gru_backward_reduce_probe(probe, args[1], args[2], hs, dgh))
            both("fwd_plain", lambda: gru.gru_sequence_reference(*args), iters=3)
            both("bwd_plain", lambda: gru.gru_sequence_backward_reference(*args, hs, g_hs), iters=3)
            both("bwd_gates_plain", lambda: gru.gru_backward_gates_reference(*args, hs))
            both("bwd_recurrence_plain",
                 lambda: gru.gru_backward_recurrence_reference(gates, args[1], args[2], args[3], hs,
                                                               g_hs), iters=3)
            both("bwd_reduce_plain",
                 lambda: gru.gru_backward_reduce_reference(args[1], args[2], hs, dgh))
            # The library call for K2b, with its left operand given and with the
            # elementwise pass that forms it (the kernel forms it on the way in).
            form_hk = lambda: (torch.cat([args[2][None], hs[:-1]]) * args[1]).reshape(-1, h)  # noqa: E731
            hk, flat = form_hk(), dgh.reshape(-1, 3 * h)
            both("mm", lambda: torch.mm(hk.T, flat))
            both("form_hk", form_hk)
            both("mm_with_hk", lambda: torch.mm(form_hk().T, flat))
            both("bwd_reduce_sum_plain", lambda: gru.gru_backward_reduce_sum_reference(partials, h))
            both("sum", lambda: torch.sum(partials, dim=0))
        else:
            # The library's GRU cannot reset its carry: it is timed, and held
            # against the kernels, at keep == 1. Its forward runs on the stream
            # that the backward is captured on: autograd sends a backward to its
            # forward's stream.
            rnn = cudnn_gru(args[3], args[4])
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                hs_lib, grads_lib, backward = cudnn_gru_backward(rnn, args[0], args[2], g_hs)
            torch.cuda.synchronize()
            grads = gru.gru_sequence_backward(*args, hs, g_hs)
            check(torch.allclose(hs_lib, hs, rtol=RTOL, atol=ATOL), "cuDNN GRU and K1 disagree")
            for name, g, w in zip(("dgates_i", "dh0", "dWh", "db_hn"), grads, grads_lib):
                check(torch.allclose(g, w, rtol=1e-3, atol=1e-3), f"cuDNN GRU and K2 disagree: {name}")
            with torch.no_grad():
                both("cudnn_fwd", lambda: rnn(args[0], args[2][None]))
            out["cudnn_bwd"] = device_ms(backward, stream=side)
            with torch.cuda.stream(side):
                out["cudnn_bwd_host"] = time_ms(backward)
    print(f"  T={t_len} B={b} H={h} ms: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def time_tile_shape(gru, shape) -> None:
    """Device-only ms of K2p and K2b beside their bounds and `torch.mm` at a shape
    with many rows (inputs no longer fit the 50 MB L2 at 16x)."""
    t_len, b, h = shape
    args, g_hs = gru_inputs(*shape, seed=t_len * 1000 + b)
    hs = gru.gru_sequence_forward(*args)
    dgh = gru.gru_backward_recurrence(*args, hs, g_hs, gru.gru_backward_gates(*args, hs))[1]
    split = gru.reduce_split(*shape)
    partials = gru.gru_backward_reduce_partials(args[1], args[2], hs, dgh)
    form_hk = lambda: (torch.cat([args[2][None], hs[:-1]]) * args[1]).reshape(-1, h)  # noqa: E731
    hk, flat = form_hk(), dgh.reshape(-1, 3 * h)
    out = {
        "bwd_gates": device_ms(lambda: gru.gru_backward_gates(*args, hs)),
        "bwd_gates bound": bound_ms("bwd_gates", *shape)[0],
        "bwd_reduce": device_ms(lambda: gru.gru_backward_reduce(args[1], args[2], hs, dgh)),
        "its partials": device_ms(
            lambda: gru.gru_backward_reduce_partials(args[1], args[2], hs, dgh)),
        "its sum": device_ms(lambda: gru.gru_backward_reduce_sum(partials, h)),
        "its partials, reads but no FMAs": device_ms(
            lambda: gru.gru_backward_reduce_probe(1, args[1], args[2], hs, dgh)),
        "bwd_reduce bound": bound_ms("bwd_reduce", *shape)[0],
        "mm": device_ms(lambda: torch.mm(hk.T, flat)),
        "mm_with_hk": device_ms(lambda: torch.mm(form_hk().T, flat)),
    }
    print(f"  T={t_len} B={b} H={h}, K2b {split.tiles} tiles x {split.slices} slices, device-only ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))


def stacked_inputs(stack: int, t_len: int, b: int, h: int, seed: int, resets: float = 0.1):
    """Per-entry gates_i, h0, Wh, b_hn stacked on a leading axis; one shared keep."""
    entries = [gru_inputs(t_len, b, h, seed=seed + s, resets=resets)[0] for s in range(stack)]
    gates, h0, w_h, b_hn = (torch.stack([e[i] for e in entries]).contiguous() for i in (0, 2, 3, 4))
    return gates, entries[0][1], h0, w_h, b_hn


def check_stacked(gru, errs: dict) -> None:
    """The stacked K1 against its plain version on both routes, and a stack of one
    against the unstacked K1 bitwise."""
    for shape in STACKED_SHAPES:
        args = stacked_inputs(*shape, seed=shape[2])
        want = gru.gru_sequence_stacked_reference(*args)
        for route in ("resident", gru.STREAMING):
            run = lambda: gru.gru_sequence_stacked(*args)  # noqa: E731
            got = run() if route == "resident" else on_streaming(gru, run)()
            compare(f"stacked hs, {route}", got, want, shape[1:], errs, "fwd_stacked")
        one = [a[:1] if i != 1 else a for i, a in enumerate(args)]
        check(torch.equal(gru.gru_sequence_stacked(*one)[0],
                          gru.gru_sequence_forward(*(a[0] if i != 1 else a for i, a in enumerate(one)))),
              f"a stack of one is not the unstacked K1 bitwise at {shape}")
    torch.cuda.synchronize()


def clusters(gru, kernel: str, b: int, h: int, stack: int = 1) -> dict:
    """Clusters a resident launch asks for, how many the card holds at once, waves."""
    asked = stack * -(-b // gru.CLUSTER_ROWS)
    held = gru.max_active_clusters(h, kernel, b, stack)
    return {"clusters": asked, "max_active": held, "waves": -(-asked // held)}


def time_stacked(gru) -> dict:
    """The stacked K1 at rec-IQL's target pass, device-only and host-inclusive,
    beside its bound, its plain version, two unstacked K1 calls and two cuDNN
    forwards (keep == 1: the library GRU cannot reset)."""
    stack, t_len, b, h = STACKED_SHAPES[0]
    args = stacked_inputs(*STACKED_SHAPES[0], seed=b)
    out = {}

    def both(name, fn, iters=20):
        out[name] = device_ms(fn, iters=iters)
        out[name + "_host"] = time_ms(fn, iters=iters)

    both("fwd_stacked", lambda: gru.gru_sequence_stacked(*args))
    entries = [[a[s] if i != 1 else a for i, a in enumerate(args)] for s in range(stack)]
    both("two_fwd", lambda: [gru.gru_sequence_forward(*e) for e in entries])
    both("fwd_stacked_plain", lambda: gru.gru_sequence_stacked_reference(*args), iters=3)
    rnns = [cudnn_gru(e[3], e[4]) for e in entries]
    with torch.no_grad():
        both("two_cudnn_fwd", lambda: [rnn(e[0], e[2][None]) for rnn, e in zip(rnns, entries)])
    out["bound"], out["bound_by"] = bound_ms("fwd_stacked", t_len, b, h, stack=stack)
    out.update(clusters(gru, "fwd", b, h, stack))
    print(f"  stacked K1 S={stack} T={t_len} B={b} H={h}: "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()))
    return out


def time_path_shape(gru, shape) -> dict:
    """K1, K2p, K2a and K2b at one shape of the SMAX or rec-IQL path, device-only
    and host-inclusive, beside their bounds, their plain versions (checked
    against them at `PATH_SHAPES` in `check_shape`) and the library calls (cuDNN's GRU
    at keep == 1; `torch.mm` on hprev*keep formed beforehand), with the clusters
    of the resident launches."""
    t_len, b, h = shape
    args, g_hs = gru_inputs(*shape, seed=t_len * 1000 + b)
    hs = gru.gru_sequence_forward(*args)
    gates = gru.gru_backward_gates(*args, hs)
    dgh = gru.gru_backward_recurrence(*args, hs, g_hs, gates)[1]
    out = {}

    def both(name, fn, iters=20):
        out[name] = device_ms(fn, iters=iters)
        out[name + "_host"] = time_ms(fn, iters=iters)

    both("fwd", lambda: gru.gru_sequence_forward(*args))
    both("bwd_gates", lambda: gru.gru_backward_gates(*args, hs))
    both("bwd_recurrence", lambda: gru.gru_backward_recurrence(*args, hs, g_hs, gates))
    both("bwd_reduce", lambda: gru.gru_backward_reduce(args[1], args[2], hs, dgh))
    both("fwd_plain", lambda: gru.gru_sequence_reference(*args), iters=3)
    both("bwd_gates_plain", lambda: gru.gru_backward_gates_reference(*args, hs))
    both("bwd_recurrence_plain",
         lambda: gru.gru_backward_recurrence_reference(gates, args[1], args[2], args[3], hs, g_hs),
         iters=3)
    both("bwd_reduce_plain", lambda: gru.gru_backward_reduce_reference(args[1], args[2], hs, dgh))
    hk = (torch.cat([args[2][None], hs[:-1]]) * args[1]).reshape(-1, h)
    flat = dgh.reshape(-1, 3 * h)
    both("mm", lambda: torch.mm(hk.T, flat))
    keep1, _ = gru_inputs(*shape, seed=t_len * 1000 + b, resets=0.0)
    rnn = cudnn_gru(keep1[3], keep1[4])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _, _, backward = cudnn_gru_backward(rnn, keep1[0], keep1[2], g_hs)
    torch.cuda.synchronize()
    with torch.no_grad():
        both("cudnn_fwd", lambda: rnn(keep1[0], keep1[2][None]))
    out["cudnn_bwd"] = device_ms(backward, stream=side)
    with torch.cuda.stream(side):
        out["cudnn_bwd_host"] = time_ms(backward)
    for kernel in ("fwd", "bwd_gates", "bwd_recurrence", "bwd_reduce"):
        out[kernel + "_bound"] = bound_ms(kernel, *shape)[0]
    k1, k2a = clusters(gru, "fwd", b, h), clusters(gru, "bwd_recurrence", b, h)
    out.update({"fwd_clusters": k1["clusters"], "fwd_max_active": k1["max_active"],
                "fwd_waves": k1["waves"], "bwd_recurrence_max_active": k2a["max_active"],
                "bwd_recurrence_waves": k2a["waves"]})
    print(f"  T={t_len} B={b} H={h} (path shape): "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()))
    return out


def kernel_phase(gru) -> dict:
    errs: dict = {}
    check(gru.built_reduce_config() == (gru.REDUCE_TILE, gru.REDUCE_CHUNK),
          f"reduce_split and the library disagree on K2b's tile: {gru.built_reduce_config()}")
    for shape in SHAPES:
        check_shape(gru, shape, errs)
    for shape in TILE_SHAPES:
        check_tile_shape(gru, shape, errs)
    check_stacked(gru, errs)
    path_errs = {}
    for shape in PATH_SHAPES:
        path_errs[shape] = {}
        check_shape(gru, shape, path_errs[shape])
        for key, err in path_errs[shape].items():
            errs[key] = max(errs.get(key, 0.0), err)
    for shape, want in zip(SHAPES, ["resident"] * 6 + ["streaming"] * 2):
        check(gru.kernel_route(*shape).route == want, f"{shape} is not on the {want} route")
    times = {shape[1]: time_shape(gru, shape) for shape in SLICE_SHAPES}
    for shape in TILE_SHAPES:
        time_tile_shape(gru, shape)
    stacked = time_stacked(gru)
    path = {shape: time_path_shape(gru, shape) for shape in PATH_SHAPES}
    for counter, before in BEFORE_REDESIGN_MS.items():
        print(f"  {counter} at T=128 H=128, B=16 / B=32, before its redesign -> now: device-only "
              + " / ".join(f"{x:.4f} -> {times[bb][counter]:.4f}"
                           for x, bb in zip(before["device"], (16, 32)))
              + "; host-inclusive "
              + " / ".join(f"{x:.4f} -> {times[bb][counter + '_host']:.4f}"
                           for x, bb in zip(before["host"], (16, 32))))

    sm_mhz = float(card("clocks.max.sm").split()[0])
    args, g_hs = gru_inputs(*SLICE_SHAPES[0], seed=1, resets=0.0)
    clocks = gru.measure_step_clocks(*args, g_hs)
    for name, phases in clocks.items():
        total = sum(phases.values())
        print(f"  {name} resident, T=128 B=16 H=128, cycles per step at {sm_mhz:.0f} MHz: "
              + ", ".join(f"{k} {v:.0f}" for k, v in phases.items())
              + f" | step {total:.0f} = {total / sm_mhz:.3f} us (with the clock marks in)")
    # The chain a step cannot hide behind its product: the gate math, and the
    # shortest phase in which a block waits for its peers.
    chain = clocks["fwd"]["gates"] + clocks["fwd"]["wait"]
    floor, fma = serial_floor_ms(128, 128, 8, sm_mhz, chain)
    print(f"  serial-chain floor at T=128 H=128, 8 SMs a cluster: {fma:.0f} FMA issue cycles + "
          f"{chain:.0f} chain cycles a step -> {floor:.4f} ms a launch")
    return {"errs": errs, "times": times, "clocks": clocks, "serial_floor_ms": floor,
            "stacked": stacked, "path": path, "path_errs": path_errs}


# ------------------------------------------------------------------ slice phases
def port():
    """The port's modules that the phases below drive."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.systems.ppo import ff_ippo, ff_mappo, rec_ippo, rec_mappo
    from mava_tpu_torch.systems.q_learning import rec_iql
    from mava_tpu_torch.utils.config import load_config

    return environments, load_config, {
        # system: (entry point, module of its learner, default config, centralised critic)
        "rec_ippo": (rec_ippo, rec_ippo, "default_rec_ippo", False),
        "rec_mappo": (rec_mappo, rec_ippo, "default_rec_mappo", True),
        "ff_ippo": (ff_ippo, ff_ippo, "default_ff_ippo", False),
        "ff_mappo": (ff_mappo, ff_ippo, "default_ff_mappo", True),
        "rec_iql": (rec_iql, rec_iql, "default_rec_iql", False),
    }


def networks(system: str, module, env, config, device, centralised: bool):
    """The networks `system` starts from, as its learner_setup makes them."""
    if system == "rec_iql":  # the target network starts as a copy of the online one
        online = module.make_q_network(env, config, device, config.system.seed)
        return online, online
    return module.make_networks(env, config, device, config.system.seed, centralised)


def learner(system: str, overrides):
    """(learn, state, env-steps an update) of `system` at `SLICE_OVERRIDES` plus
    `overrides`, one update a call, from the seed's state."""
    environments, load_config, systems = port()
    _, module, config_name, centralised = systems[system]
    cfg = load_config(config_name, SLICE_OVERRIDES + list(overrides))
    cfg.arch.n_devices = 1
    if cfg.system.get("recurrent_chunk_size", "no such key") is None:
        cfg.system.recurrent_chunk_size = cfg.system.rollout_length
    cfg.system.num_updates_per_eval = 1
    device = torch.device("cuda")
    env, _ = environments.make(cfg, device, add_global_state=centralised)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    if system == "rec_iql":
        learn, _, state = module.learner_setup(env, gen, cfg, device)
    else:
        learn, _, state = module.learner_setup(env, gen, cfg, device, centralised)
    return learn, state, cfg.system.rollout_length * cfg.arch.num_envs


def one_update(system: str, overrides, repeats: int):
    """`repeats` timed updates from the seed's state; returns (seconds, params and losses
    of the first, env-steps an update)."""
    learn, state, steps = learner(system, overrides)
    seconds, first = [], None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = learn(state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if first is None:
            params = [p.detach().clone() for net in out.learner_state.params for p in net.parameters()]
            first = (params, out.train_metrics)
        state = out.learner_state
    return seconds, first[0], first[1], steps


def print_updates(label: str, seconds, steps: int, gpu: str) -> None:
    mean = sum(seconds) / len(seconds)
    print(f"  update with {label}: " + " ".join(f"{x * 1e3:.1f}" for x in seconds)
          + f" ms; mean {mean * 1e3:.1f} ms, {steps / mean:.1f} env-steps/s "
          f"(range {steps / max(seconds):.1f}-{steps / min(seconds):.1f}) on {gpu}")


def train(system: str, gru, overrides=()):
    """`system` through its `run_experiment` at the shipped width, with the launch
    counts set to 0 just before and read just after: every parameter on the card
    and changed, every loss finite. Returns (config, launches)."""
    environments, load_config, systems = port()
    entry, module, config_name, centralised = systems[system]
    config = load_config(config_name, SLICE_OVERRIDES + list(overrides))
    device = torch.device("cuda")
    env, _ = environments.make(config, device, add_global_state=centralised)
    nets = networks(system, module, env, config, device, centralised)
    initial = [p.detach().clone() for net in nets for p in net.parameters()]

    gru.reset_launch_counts()
    start = time.perf_counter()
    performance, output = entry.run_experiment(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(gru.kernel_launches, fwd_calls=gru.fwd_launches, bwd_calls=gru.bwd_launches)

    final = [p.detach() for net in output.learner_state.params for p in net.parameters()]
    check(len(final) == len(initial), f"{system}: the networks changed shape")
    check(all(p.device.type == "cuda" for p in final), f"{system}: a parameter is not on the card")
    for name, values in output.train_metrics.items():
        check(torch.isfinite(values).all().item(), f"{system}: loss {name} not finite")
    changed = [not torch.equal(a, b) for a, b in zip(initial, final)]
    check(all(changed), f"{system}: parameters unchanged after training: {changed}")
    check(performance == performance, f"{system}: the eval {config.env.eval_metric} is not a number")
    print(f"  {system} run_experiment: {config.system.num_updates} updates, eval "
          f"{config.env.eval_metric} {performance:.3f}, {wall:.1f} s wall, launches {launches}")
    return config, launches


def kernels_against_plain(system: str, repeats: int, overrides=()):
    """Updates of `system` through the kernels and through the plain GRU, from the
    same seed, generator stream and therefore the same first rollout. Returns the
    kernel run's (seconds, params, env-steps an update) and the plain run's seconds."""
    overrides = list(overrides)
    k_s, k_params, k_losses, steps = one_update(
        system, overrides + ["network.gru_impl=pallas"], repeats)
    p_s, p_params, p_losses, _ = one_update(system, overrides + ["network.gru_impl=hoisted"], 1)
    param_err = max((a - b).abs().max().item() for a, b in zip(k_params, p_params))
    loss_err = max((k_losses[k] - p_losses[k]).abs().max().item() for k in p_losses)
    print(f"  one {system} update, kernels vs plain GRU: max |param diff| {param_err:.3e}, "
          f"max |loss diff| {loss_err:.3e}")
    check(param_err <= 1e-3, f"{system}: kernel and plain updates disagree on the parameters")
    check(all(torch.allclose(k_losses[k], p_losses[k], rtol=1e-3, atol=1e-5)
              for k in p_losses), f"{system}: kernel and plain updates disagree on the losses")
    return k_s, k_params, steps, p_s


def slice_phase(gru, gpu: str) -> dict:
    """rec-IPPO through run_experiment, then kernel vs plain for one update."""
    config, launches = train("rec_ippo", gru)
    updates = config.system.num_updates
    check(launches["fwd_calls"] >= 17 * updates, f"forward launched {launches['fwd_calls']} times")
    check(launches["bwd_calls"] >= 16 * updates, f"backward launched {launches['bwd_calls']} times")
    for _, counter, _, per_update in KERNELS:
        check(launches[counter] >= per_update * updates,
              f"{counter} launched {launches[counter]} times on the main path")

    k_s, k_params, steps, p_s = kernels_against_plain("rec_ippo", repeats=2)
    # The same updates on the streaming kernels: every call of the op is sent
    # there for the length of these runs.
    s_s, s_params, _, _ = on_streaming(
        gru, lambda: one_update("rec_ippo", ["network.gru_impl=pallas"], repeats=2))()
    stream_err = max((a - b).abs().max().item() for a, b in zip(k_params, s_params))
    check(stream_err <= 1e-3, "resident and streaming updates disagree on the parameters")
    for label, seconds in (("resident kernels", k_s), ("streaming kernels", s_s), ("plain GRU", p_s)):
        print_updates(label, seconds, steps, gpu)
    return {"launches": launches}


def mappo_phase(gru, gpu: str) -> dict:
    """rec-MAPPO, the centralised recurrent critic: the path of the CTDE systems
    that runs the kernels. Per update exactly the launches of rec-IPPO: the
    evaluator's and the rollout's T = 1 actor steps reach no kernel."""
    config, launches = train("rec_mappo", gru)
    updates = config.system.num_updates
    for _, counter, _, per_update in KERNELS:
        check(launches[counter] == per_update * updates,
              f"rec_mappo: {counter} launched {launches[counter]} times in {updates} updates, "
              f"not {per_update} an update")
    check(launches["fwd_calls"] == 17 * updates and launches["bwd_calls"] == 16 * updates,
          f"rec_mappo: {launches['fwd_calls']} forward and {launches['bwd_calls']} backward calls")
    k_s, _, steps, p_s = kernels_against_plain("rec_mappo", repeats=2)
    for label, seconds in (("rec-MAPPO, resident kernels", k_s), ("rec-MAPPO, plain GRU", p_s)):
        print_updates(label, seconds, steps, gpu)
    return {"launches": launches}


def smax_phase(gru, gpu: str) -> dict:
    """rec-MAPPO on SMAX 3s5z: the centralised critic on the env's world state, 8
    agents, 13 actions and masks that change every step. Exactly the launches of
    rec-IPPO an update; its eval win rate; kernels against the plain GRU; where
    an update's time goes."""
    config, launches = train("rec_mappo", gru, SMAX)
    updates = config.system.num_updates
    for _, counter, _, per_update in KERNELS:
        check(launches[counter] == per_update * updates,
              f"rec_mappo on SMAX: {counter} launched {launches[counter]} times in {updates} "
              f"updates, not {per_update} an update")
    k_s, _, steps, p_s = kernels_against_plain("rec_mappo", 2, SMAX)
    for label, seconds in (("rec-MAPPO on SMAX 3s5z, resident kernels", k_s),
                           ("rec-MAPPO on SMAX 3s5z, plain GRU", p_s)):
        print_updates(label, seconds, steps, gpu)
    profile = profile_phase("rec_mappo", SMAX, 128)
    return {"launches": launches, "profile": profile}


def grid_run(gru, gpu: str, label: str, system: str, overrides) -> dict:
    """`system` with `overrides` through its `run_experiment` (the counts set
    to 0 just before and read just after; the card's peak memory over the
    run, above what was allocated before it), then timed updates and one
    profiled: env-steps/s, launches per rollout step, the device's idle share."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    config, launches = train(system, gru, overrides)
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    if system == "rec_mappo":
        seconds, _, steps, plain = kernels_against_plain(system, 2, overrides)
        print_updates(f"{label}, plain GRU", plain, steps, gpu)
    else:
        check(not any(launches.values()), f"{label} launched a GRU kernel: {launches}")
        seconds, _, _, steps = one_update(system, overrides, repeats=2)
    print_updates(label, seconds, steps, gpu)
    prof = profile_phase(system, overrides, config.system.rollout_length)
    rate = steps * len(seconds) / sum(seconds)
    print(f"  {label}: {rate:.1f} env-steps/s, {prof['launches_per_rollout_step']:.1f} launches "
          f"a rollout step, idle share {prof['idle_share']:.3f}, peak memory {peak_gb:.3f} GB "
          f"above the {before / 1e9:.3f} GB allocated before the run, on {gpu}")
    return {"launches": launches, "updates": config.system.num_updates,
            "env_steps_per_s": rate, "peak_gb": peak_gb,
            "launches_per_rollout_step": prof["launches_per_rollout_step"],
            "idle_share": prof["idle_share"]}


def grid_phase(gru, gpu: str) -> dict:
    """rec-MAPPO with rCNN on MaConnector con-10x10x10a at the shipped system
    config: the CNN pre-torsos on (10, 10, 5) views and the (10, 10, 3) grid
    state, the GRU kernels at B = 160 (critic pass) and 80 (losses), exactly
    17 K1 and 16 of each backward kernel an update, one update on the kernels
    against one on the plain GRU. Then ff-IPPO cnn on Cleaner, ff-MAPPO on LBF
    and ff-IPPO on Gigastep, which reach no GRU kernel."""
    out = {"connector": grid_run(gru, gpu, "rec-MAPPO rcnn on MaConnector con-10x10x10a",
                                 "rec_mappo", CONNECTOR + GRID_CUT)}
    updates = out["connector"]["updates"]
    for _, counter, _, per_update in KERNELS:
        got = out["connector"]["launches"][counter]
        check(got == per_update * updates,
              f"rec_mappo rcnn on MaConnector: {counter} launched {got} times in {updates} "
              f"updates, not {per_update} an update")
    for label, system, overrides in GRID_FF:
        out[label] = grid_run(gru, gpu, label, system, overrides + GRID_CUT)
    return out


def iql_phase(gru, gpu: str) -> dict:
    """rec-IQL on SMAX 3s5z at the shipped config: the stacked K1 on the fused
    target pass, K1 and the backward kernels on the loss pass. Then the fused
    target pass against the unfused pair on the same sequences, and the loss
    pass and its gradient against the plain GRU."""
    from mava_tpu_torch.systems.q_learning import rec_iql

    overrides = SMAX + [f"system.num_updates={IQL_UPDATES}"]
    config, launches = train("rec_iql", gru, overrides)
    updates = config.system.num_updates
    for counter, per_update in IQL_PER_UPDATE.items():
        check(launches[counter] == per_update * updates,
              f"rec_iql: {counter} launched {launches[counter]} times in {updates} updates, "
              f"not {per_update} an update")

    learn, state, steps = learner("rec_iql", overrides)
    seconds, losses = [], []
    for _ in range(40):  # fills the buffer past one sampled sequence, then times
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = learn(state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        state = out.learner_state
        losses.append(out.train_metrics["mean_q"])
    print_updates("rec-IQL on SMAX 3s5z (the last 30)", seconds[10:], steps, gpu)
    print(f"  rec-IQL mean_q over the 40 updates: first {losses[0].mean().item():.4f}, "
          f"last {losses[-1].mean().item():.4f}")
    buffer = rec_iql.make_buffer(config)
    data = buffer.sample(state.buffer_state, *buffer.sample_indices(state.buffer_state, state.key))
    gru.reset_launch_counts()
    fused = rec_iql.q_targets(state.params, data, config.system.gamma, fused=True)
    check(gru.kernel_launches["fwd_stacked"] == 1 and gru.kernel_launches["fwd"] == 0,
          f"the fused target pass launched {gru.kernel_launches}")
    unfused = rec_iql.q_targets(state.params, data, config.system.gamma, fused=False)
    err = (fused - unfused).abs().max().item()
    print(f"  fused against unfused target pass, {tuple(fused.shape)} targets: max |diff| {err:.3e}")
    check(torch.allclose(fused, unfused, rtol=1e-5, atol=1e-5),
          "the fused and unfused target passes disagree")
    iql_against_plain(gru, rec_iql, state.params, data, config.system.gamma)
    profile = profile_phase("rec_iql", overrides, config.system.rollout_length)
    return {"launches": launches, "profile": profile}


def iql_against_plain(gru, rec_iql, params, data, gamma: float) -> None:
    """rec-IQL's loss pass and its gradient on sampled sequences (the stacked K1
    on the target pass; K1, K2p, K2a and K2b on the loss pass at T = 20, B = 256)
    against the same pass on the plain GRU, from the same parameters and data.
    The gradients are compared, not the parameters after an Adam step: Adam's
    step does not change when its gradient is scaled."""
    rnns = (params.online.rnn, params.target.rnn)
    impl = rnns[0].gru_impl
    runs = {}
    try:
        for name in ("pallas", "hoisted"):
            for rnn in rnns:
                rnn.gru_impl = name
            gru.reset_launch_counts()
            loss, _, target = rec_iql.q_loss_pass(params, data, gamma, fused=True)
            grads = torch.autograd.grad(loss, list(params.online.parameters()))
            torch.cuda.synchronize()
            runs[name] = (loss.detach(), target, grads, dict(gru.kernel_launches))
    finally:
        for rnn in rnns:
            rnn.gru_impl = impl
    (k_loss, k_target, k_grads, k_counts), (p_loss, p_target, p_grads, p_counts) = (
        runs["pallas"], runs["hoisted"])
    check(k_counts == {**dict.fromkeys(gru.KERNELS, 0), "fwd": 1, "bwd_gates": 1,
                       "bwd_recurrence": 1, "bwd_reduce": 1, "bwd_reduce_sum": 1,
                       "fwd_stacked": 1},
          f"rec_iql's loss pass on the kernels launched {k_counts}")
    check(not any(p_counts.values()), f"rec_iql's loss pass on the plain GRU launched {p_counts}")
    # Each gradient's error relative to its largest entry.
    grad_err = max(((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                   for g, w in zip(k_grads, p_grads))
    print(f"  rec-IQL loss pass, kernels vs plain GRU: q_loss {k_loss.item():.6e} vs "
          f"{p_loss.item():.6e}, max |target diff| {(k_target - p_target).abs().max().item():.3e}, "
          f"max gradient error / its largest entry {grad_err:.3e}")
    check(torch.allclose(k_loss, p_loss, rtol=1e-4, atol=0.0), "rec_iql: q_loss disagrees")
    check(torch.allclose(k_target, p_target, rtol=RTOL, atol=ATOL), "rec_iql: targets disagree")
    check(grad_err <= 1e-4, "rec_iql: the kernel and plain gradients disagree")


def feedforward_phase(gru, gpu: str) -> None:
    """ff-IPPO and ff-MAPPO on RWARE, ff-IPPO on Matrax, and the bench program,
    short. None of them reaches a hand-written kernel, and the counts say so."""
    import bench_torch

    for system in ("ff_ippo", "ff_mappo"):
        _, launches = train(system, gru)
        check(not any(launches.values()), f"{system} launched a GRU kernel: {launches}")
    seconds, _, _, steps = one_update("ff_ippo", [], repeats=3)
    print_updates("ff-IPPO, 16 envs", seconds, steps, gpu)

    train("ff_ippo", gru, [
        "env=matrax", "env.scenario.task_name=Penalty-25-stateless-v0", "env.kwargs.time_limit=10",
        "arch.num_envs=16", "system.rollout_length=128", "system.num_updates=30",
        "arch.num_eval_episodes=32",
    ])

    start = time.perf_counter()
    rate = bench_torch.run(bench_torch.NUM_ENVS, bench_torch.ROLLOUT_LENGTH,
                           bench_torch.UPDATES_PER_CALL, warmup_calls=1, timed_calls=1,
                           device="cuda")
    check(rate > 0, "the bench program reports no rate")
    print(f"  bench program, short (ff-IPPO, {bench_torch.NUM_ENVS} envs, 1 warm-up and 1 timed "
          f"calls of {bench_torch.UPDATES_PER_CALL} updates): {rate:.1f} env-steps/s on {gpu} "
          f"({time.perf_counter() - start:.1f} s wall)")


# ------------------------------------------------------------------ programs phase
# The quickstart and the user tools of `mava_tpu_torch/scripts/`, each through
# the function its CLI calls, at its configs' widths and cut in depth only: the
# quickstart at 131,072 env-steps (8 updates at 128 envs) and 2 evaluations;
# the suite and the MFU bench at fewer updates a call and fewer calls; the
# sweeps at two points and S = 2; the seed table at 2 seeds of 2 updates.
QUICKSTART_CUT = ["system.total_timesteps=131072", "arch.num_evaluation=2"]
MFU_CUT = {"updates_per_call": 1, "scan_steps": 8, "timed_calls": 1}
SEED_TABLE = ["ppo.ff_ippo", "default_ff_ippo", "42,7", "env=matrax",
              "env.scenario.task_name=Penalty-25-stateless-v0", "env.kwargs.time_limit=10",
              "system.num_updates=2", "arch.num_evaluation=1", "arch.num_eval_episodes=32",
              "logger.use_console=False"]


def programs_phase(gru, gpu: str) -> dict:
    """The quickstart's `main()`, then `bench_suite` on rec_mappo_smax with its
    exact launches, `bench_mfu` on rec_ippo_smax and rec_iql_smax (GRU and
    matmul FLOPs counted, 0 < MFU <= 1), `bench_envs_sweep` at two points,
    `bench_vmap_seeds` at S = 2 and `run_seeds` over two seeds, each number
    beside the card's name and power limit."""
    import math

    from mava_tpu_torch.examples import quickstart
    from mava_tpu_torch.scripts import (
        bench_envs_sweep,
        bench_mfu,
        bench_suite,
        bench_vmap_seeds,
        run_seeds,
    )

    argv, sys.argv = sys.argv, ["quickstart", *QUICKSTART_CUT]
    try:
        start = time.perf_counter()
        value = quickstart.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        sys.argv = argv
    check(isinstance(value, float) and math.isfinite(value),
          f"the quickstart returned {value!r}, not a finite float")
    print(f"  quickstart (LBF 2s-8x8-2p-2f-coop, 128 envs, 131,072 env-steps, 2 evaluations): "
          f"final eval return {value:.3f}, {131072 / wall:.1f} env-steps/s over {wall:.1f} s "
          f"wall (set-up and evaluations included) on {gpu}")

    updates = 2  # 1 warm-up and 1 timed call of 1 update
    gru.reset_launch_counts()
    suite = bench_suite.bench_one("rec_mappo_smax", "cuda", updates_per_call=1, warmup_calls=1,
                                  timed_calls=1)
    launches = dict(gru.kernel_launches)
    for _, counter, _, per_update in KERNELS:
        check(launches[counter] == per_update * updates,
              f"bench_suite rec_mappo_smax: {counter} launched {launches[counter]} times in "
              f"{updates} updates, not {per_update} an update")
    print(f"  bench_suite rec_mappo_smax (1 update a call, 1 warm-up, 1 timed): "
          f"{suite['value']} env-steps/s, launches {launches} on {gpu}")

    mfu = {}
    for name, per_update, per_call in (
            ("rec_ippo_smax", {c: n for _, c, _, n in KERNELS}, MFU_CUT["updates_per_call"]),
            ("rec_iql_smax", IQL_PER_UPDATE, MFU_CUT["scan_steps"])):
        record = bench_mfu.measure(name, "cuda", **MFU_CUT)
        want = {c: n * per_call for c, n in per_update.items() if n}
        check(record["gru_launches_per_call"] == want,
              f"bench_mfu {name}: launches {record['gru_launches_per_call']}, not {want}")
        check(record["gru_kernel_flops_per_call"] > 0 and record["matmul_flops_per_call"] > 0,
              f"bench_mfu {name}: a FLOP count is 0")
        check(0 < record["mfu_vs_fp32_peak"] <= 1,
              f"bench_mfu {name}: MFU {record['mfu_vs_fp32_peak']}")
        check(0 < record["device_busy_share"] <= 1.05,
              f"bench_mfu {name}: busy share {record['device_busy_share']}")
        mfu[name] = record

    sweep = bench_envs_sweep.sweep((16, 64), 1, "cuda", updates_per_call=1, warmup_calls=1)
    check(all(rate > 0 for _, rate in sweep), f"bench_envs_sweep: {sweep}")
    vmap = bench_vmap_seeds.compare([2], "cuda", updates_per_call=1, timed_calls=1)
    check(vmap[1]["env_steps_per_second_all_seeds"] > 0, f"bench_vmap_seeds: {vmap}")

    seeds = run_seeds.main(SEED_TABLE)
    check(len(seeds) == 2 and all(math.isfinite(x) for x in seeds), f"run_seeds: {seeds}")
    print(f"  run_seeds (ff-IPPO on Matrax Penalty, 2 updates a seed): {seeds} on {gpu}")
    return {"suite": suite, "launches": launches, "mfu": mfu, "sweep": sweep, "vmap": vmap}


# ------------------------------------------------------------------ SAC phase
SAC_SYSTEMS = [("ff_isac", "default_ff_isac", False), ("ff_masac", "default_ff_masac", True)]
# run_experiment at the shipped config (MaSwarm spread-3ag, 16 envs, rollout 2, 32
# epochs, delay 4, batch 32, a 1,000,000-item buffer): the 4,992-step explore phase,
# then rounds of 5120 // 40 = 128 env-steps (4 updates) from 4,992 to 5,120, which are
# two (the reference's range(4992, 5121, 128)), each with an evaluation.
SAC_RUN = ["system.total_timesteps=5120", "arch.num_evaluation=40", "arch.num_eval_episodes=16",
           "arch.absolute_metric=False", "+arch.device=cuda"]
SAC_TIMED_UPDATES = 4  # 8 until PR 8, cut to make room for the articulated phase


def sac_learner(config_name: str, centralised: bool, overrides=()):
    """(config, explore, learn, state) of SAC at the shipped config plus
    `overrides`, one update a `learn` call, from the seed's state
    (`ff_isac.build_bench_learners`)."""
    from mava_tpu_torch.systems.sac import ff_isac
    from mava_tpu_torch.utils.config import load_config

    cfg = load_config(config_name, ["+arch.device=cuda", *overrides])
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = 1
    explore, learn, state = ff_isac.build_bench_learners(cfg, torch.device("cuda"), centralised)
    return cfg, explore, learn, state


def sac_params(params) -> list:
    nets = (params.actor, *params.q.online, *params.q.targets)
    return [p.detach() for net in nets for p in net.parameters()] + [params.log_alpha.detach()]


def sac_run(gru, system: str, config_name: str, centralised: bool, run=tuple(SAC_RUN),
            updates: int = 8, label: str = "") -> float:
    """`run_experiment` of `system` as a user calls it, with the GRU counts set to
    0 just before and read just after: the SAC path launches no hand kernel.
    Every parameter on the card and changed, every loss finite, the buffer of
    1,000,000 items on the card, written up to the explore phase and `updates`
    updates. Returns the peak memory of the run above what was allocated
    before it, in GB."""
    from mava_tpu_torch.systems.sac import ff_isac, ff_masac
    from mava_tpu_torch.utils.config import load_config

    entry = ff_masac if centralised else ff_isac
    config = load_config(config_name, list(run))
    cfg, _, _, state = sac_learner(config_name, centralised, [x for x in run if x != "+arch.device=cuda"])
    initial = [p.clone() for p in sac_params(state.params)]
    del state
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gru.reset_launch_counts()
    start = time.perf_counter()
    performance, output = entry.run_experiment(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    launches = dict(gru.kernel_launches, fwd_calls=gru.fwd_launches, bwd_calls=gru.bwd_launches)
    check(not any(launches.values()), f"{system} launched a GRU kernel: {launches}")
    final = sac_params(output.learner_state.params)
    check(all(p.device.type == "cuda" for p in final), f"{system}: a parameter is not on the card")
    check(all(not torch.equal(a, b) for a, b in zip(initial, final)),
          f"{system}: a parameter did not change")
    for name, values in output.train_metrics.items():
        check(torch.isfinite(values).all().item(), f"{system}: loss {name} not finite")
    check(performance == performance, f"{system}: the eval return is not a number")
    buffer = output.learner_state.buffer_state
    leaves = pytree.tree_leaves(buffer.experience)
    explored = cfg.system.explore_steps // cfg.arch.num_envs * cfg.arch.num_envs
    written = explored + updates * cfg.arch.num_envs * cfg.system.rollout_length
    check(all(x.shape[0] == 1_000_000 and x.device.type == "cuda" for x in leaves),
          f"{system}: the buffer is not 1,000,000 items on the card")
    check(buffer.current_index == written and output.learner_state.t == written,
          f"{system}: {buffer.current_index} items written, t = {output.learner_state.t}")
    print(f"  {system}{label} run_experiment: explore {explored} env-steps + {updates} updates, "
          f"eval return {performance:.3f}, {wall:.1f} s wall, peak memory {peak_gb:.3f} GB above "
          f"the {before / 1e9:.3f} GB allocated before, GRU launches {launches}")
    return peak_gb


def sac_updates(label: str, config_name: str, centralised: bool, overrides, gpu: str,
                timed: int, profiled: bool = True) -> dict:
    """The explore phase, then `timed` updates after a warm-up one, timed on the
    host clock; then, if `profiled`, one update under torch.profiler. Returns
    what was read."""
    torch.cuda.reset_peak_memory_stats()
    cfg, explore, learn, state = sac_learner(config_name, centralised, overrides)
    leaves = pytree.tree_leaves(state.buffer_state.experience)
    buffer_gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = explore(state)
    torch.cuda.synchronize()
    explore_s = time.perf_counter() - t0
    seconds, q_vals = [], []
    for _ in range(timed + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = learn(state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        state = out.learner_state
        q_vals.append(out.train_metrics["q1_a_vals"].mean().item())
        check(all(torch.isfinite(v).all().item() for v in out.train_metrics.values()),
              f"{label}: a loss is not finite")
    steps = cfg.system.rollout_length * cfg.arch.num_envs
    print(f"  {label}: buffer of {cfg.system.buffer_size} items, {buffer_gb:.3f} GB on the card "
          f"(peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB); explore "
          f"{state.t - steps * len(seconds)} env-steps in {explore_s:.1f} s; mean Q "
          f"{q_vals[0]:.3f} -> {q_vals[-1]:.3f}")
    print_updates(f"{label} (after one warm-up)", seconds[1:] or seconds, steps, gpu)
    mean = sum(seconds[1:] or seconds) / len(seconds[1:] or seconds)
    if not profiled:
        return {"env_steps_per_s": steps / mean, "buffer_gb": buffer_gb}
    prof = profile_update(label, lambda: learn(state), steps, cfg.system.rollout_length)
    train_launches = prof["span_launches"].get("sac/train", 0)
    per_train_step = train_launches / cfg.system.epochs
    print(f"  {label}: {prof['launches']} launches an update, {per_train_step:.1f} a train step "
          f"({cfg.system.epochs} a update, actor and alpha on every "
          f"{cfg.system.policy_update_delay}th), {steps / mean:.1f} env-steps/s, idle share "
          f"{prof['idle_share']:.3f} on {gpu}")
    return {"env_steps_per_s": steps / mean, "launches": prof["launches"],
            "launches_per_train_step": per_train_step, "idle_share": prof["idle_share"],
            "launches_per_act_step": prof["span_launches"].get("sac/act", 0)
            / cfg.system.rollout_length, "buffer_gb": buffer_gb}


def sac_phase(gru, gpu: str) -> dict:
    """ff-ISAC and ff-MASAC on MaSwarm spread-3ag at the shipped config with the
    1,000,000-item buffer on the card: through `run_experiment` (no GRU kernel
    launched), then timed and profiled updates; one ff-ISAC update on MaReacher
    reacher-2x1. The SAC path runs only MLPs: no hand kernel is owed."""
    out = {}
    for system, config_name, centralised in SAC_SYSTEMS:
        sac_run(gru, system, config_name, centralised)
        out[system] = sac_updates(f"{system} on MaSwarm spread-3ag", config_name, centralised, [],
                                  gpu, SAC_TIMED_UPDATES)
    out["ff_isac_mareacher"] = sac_updates("ff_isac on MaReacher reacher-2x1", "default_ff_isac",
                                           False, ["env=mareacher", "system.explore_steps=32"],
                                           gpu, 1)
    return out


# ------------------------------------------------------------------ articulated phase
ARTICULATED = [("maswimmer", "swimmer-2x1"), ("mahopper", "hopper-3x1"),
               ("macheetah", "halfcheetah-6x1"), ("mawalker", "walker2d-2x3"),
               ("maant", "ant-4x2"), ("mahumanoid", "humanoid-9-8")]
# Cut in depth only (an env step costs 0.1-2.9 s of host at 16 envs): episodes
# of 2 steps, so an evaluation of 16 episodes is 2 steps; SAC explores one batch
# (32 items) and runs one round of one update (two rounds until the programs
# phase came); ff-IPPO rolls out 8 steps. An update is timed apart from the
# run and profiled on MaHopper only (every env until the programs phase came;
# PERF.md §5 keeps their rates), for ff-ISAC only since the recording program
# came to the distributed phase (ff-MASAC's there made 55,039 launches against
# ff-ISAC's 54,779), and ff-IPPO's with a rollout of 1 step:
# processing the profile of an update takes ~0.3 ms an event, over two minutes
# for MaHumanoid's 240,000 launches (PERF.md §5 has every env's, from a run of
# this phase that profiled them all).
ARTICULATED_CUT = ["env.kwargs.time_limit=2", "arch.num_eval_episodes=16",
                   "arch.absolute_metric=False"]
ARTICULATED_SAC = ["system.explore_steps=32", "system.total_timesteps=32",
                   "arch.num_evaluation=1", "+arch.device=cuda"]
ARTICULATED_SAC_UPDATES = 1
ARTICULATED_MASAC = ["mahumanoid", "mahopper"]
ARTICULATED_PROFILED = [("ff_isac", "mahopper")]
ARTICULATED_PPO = ["env=mawalker", "env/scenario=walker2d-2x3", "network=continuous_mlp",
                   "system.rollout_length=8", "system.num_updates=2", *ARTICULATED_CUT]


def inner_env(env):
    while hasattr(env, "_env"):
        env = env._env
    return env


def launches_and_syncs(fn) -> dict:
    """`fn()` under torch.profiler: kernel launches, host syncs (stream, device
    and event synchronizes beyond those of profiling nothing) and
    device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile

    def read(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = list(prof.events())
        names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        return {"launches": sum("launch" in n.lower() and n.startswith(("cuda", "cu"))
                                for n in names),
                "syncs": sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                   "cudaEventSynchronize") for n in names),
                "dtoh": sum(e.device_type == torch.autograd.DeviceType.CUDA and "DtoH" in e.name
                            for e in events)}

    nothing, got = read(lambda: None), read(fn)
    return {k: got[k] - nothing[k] for k in got}


def articulated_step(env_name: str, scenario: str, gpu: str) -> dict:
    """One step of 16 envs on the card against the same step on the CPU, from a
    state and actions made on the CPU (the shipped reset, the bodies moving at
    up to 1 unit/s into and off the ground): states, views, rewards, discounts
    and step types to rtol = atol = 1e-4. Then what a step costs: host ms,
    launches and host syncs (none allowed), and the trace of the 16-env q̈."""
    from mava_tpu_torch import envs
    from mava_tpu_torch.envs._dynamics import BodyState
    from mava_tpu_torch.utils.config import load_config

    cfg = load_config("default_ff_isac", [f"env={env_name}", f"env/scenario={scenario}",
                                          *ARTICULATED_CUT])
    cpu = inner_env(envs.make(cfg, "cpu")[0])
    card = inner_env(envs.make(cfg, torch.device("cuda"))[0])
    gen = torch.Generator().manual_seed(0)
    state, _ = cpu.reset(cpu.reset_noise(16, gen))
    state = state._replace(qd=torch.rand(state.q.shape, generator=gen) * 2 - 1)
    action = torch.rand(16, cpu.num_agents, cpu.action_dim, generator=gen) * 2.4 - 1.2
    want, want_ts = cpu.step(state, action)
    on_card, action = BodyState(*(x.cuda() for x in state)), action.cuda()
    torch.cuda.synchronize()
    start = time.perf_counter()
    got, got_ts = card.step(on_card, action)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    pairs = {"q": (got.q, want.q), "qd": (got.qd, want.qd),
             "agents_view": (got_ts.observation.agents_view, want_ts.observation.agents_view),
             "reward": (got_ts.reward, want_ts.reward)}
    errs = {k: (a.cpu() - b).abs().max().item() for k, (a, b) in pairs.items()}
    for k, (a, b) in pairs.items():
        check(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4),
              f"{env_name}: the card's {k} is {errs[k]:.2e} off the CPU's")
    for k in ("discount", "step_type"):
        check(torch.equal(getattr(got_ts, k).cpu(), getattr(want_ts, k)),
              f"{env_name}: the card's {k} differs from the CPU's")
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        card.step(got, action)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    costs = launches_and_syncs(lambda: card.step(got, action))
    check(costs["syncs"] == 0 and costs["dtoh"] == 0,
          f"{env_name}: an env step reads back to the host: {costs}")
    trace_s = {str(tuple(k[0][0])) + " " + str(k[0][2]): round(v, 2)
               for k, v in card.integrate.trace_seconds().items()}
    ms = sum(seconds) / len(seconds) * 1e3
    print(f"  {env_name} {scenario}: card vs CPU max |err| "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; an env step of 16 envs {ms:.1f} ms host ("
          + " ".join(f"{x * 1e3:.1f}" for x in seconds) + f"), {costs['launches']} launches, "
          f"{costs['syncs']} host syncs, {costs['dtoh']} device-to-host copies; q̈ traced in "
          f"{trace_s} s (the first step {first_s:.1f} s) on {gpu}")
    return {"step_ms": ms, **costs, "trace_s": trace_s, "errs": errs}


def articulated_phase(gru, gpu: str, start: float) -> dict:
    """The articulated suite at its shipped scenarios: each env's step on the
    card against the CPU and its costs; ff-ISAC on each through
    `run_experiment` (the 1,000,000-item buffer on the card, no GRU launch)
    with env-steps/s, and a profiled update on MaHopper; ff-MASAC on
    MaHumanoid and MaHopper the same, unprofiled; continuous ff-IPPO on
    MaWalker."""
    out = {}
    for env_name, scenario in ARTICULATED:
        out[env_name] = articulated_step(env_name, scenario, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    sac = [("ff_isac", "default_ff_isac", False, env_name, scenario)
           for env_name, scenario in ARTICULATED]
    sac += [("ff_masac", "default_ff_masac", True, env_name, scenario)
            for env_name, scenario in ARTICULATED if env_name in ARTICULATED_MASAC]
    for system, config_name, centralised, env_name, scenario in sac:
        env = [f"env={env_name}", f"env/scenario={scenario}", *ARTICULATED_CUT]
        label = f"{system} on {env_name} {scenario}"
        peak = sac_run(gru, system, config_name, centralised, [*env, *ARTICULATED_SAC],
                       ARTICULATED_SAC_UPDATES, f" on {env_name}")
        out[label] = {"peak_gb": peak}
        if (system, env_name) in ARTICULATED_PROFILED:
            out[label].update(sac_updates(label, config_name, centralised,
                                          [*env, "system.explore_steps=32"], gpu, 0))
        print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    label = "continuous ff-IPPO on MaWalker walker2d-2x3"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, launches = train("ff_ippo", gru, ARTICULATED_PPO)
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    check(not any(launches.values()), f"{label} launched a GRU kernel: {launches}")
    learn, state, steps = learner("ff_ippo", ARTICULATED_PPO)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    state = learn(state).learner_state
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - begin)
    learn, state, steps = learner("ff_ippo", [*ARTICULATED_PPO, "system.rollout_length=1"])
    state = learn(state).learner_state  # warm-up
    prof = profile_update(label + ", rollout 1", lambda: learn(state), steps, 1)
    print(f"  {label}: {rate:.1f} env-steps/s, {prof['launches_per_rollout_step']:.1f} launches a "
          f"rollout step, idle share {prof['idle_share']:.3f}, peak memory {peak_gb:.3f} GB above "
          f"the {before / 1e9:.3f} GB allocated before the run, on {gpu}")
    out[label] = {"env_steps_per_s": rate, "idle_share": prof["idle_share"], "peak_gb": peak_gb,
                  "launches_per_rollout_step": prof["launches_per_rollout_step"]}
    return out


def dynamics_ab(gpu: str) -> None:
    """`--dynamics`: two choices of `envs/_dynamics.py` measured on the card.
    (1) MaReacher's solve as it stood until PR 8, `torch.linalg.solve` with its
    error check, against `solve_ex` without it, run A B B A in one process:
    an env step's launches, host syncs and ms, and an ff-ISAC update's
    env-steps/s. (2) A whole RK4 substep traced as one graph against RK4 over
    the traced q̈ (what a step runs) on MaHopper and MaCheetah: trace s and
    ms a substep."""
    import mava_tpu_torch.envs.mareacher as reacher
    from mava_tpu_torch.envs import _dynamics
    from mava_tpu_torch.envs.mahopper import MaHopper
    from mava_tpu_torch.envs.macheetah import MaCheetah

    solvers = {"linalg.solve (checked)": lambda m, b: torch.linalg.solve(m, b),
               "solve_ex (unchecked)": _dynamics.solve}
    for name in ("linalg.solve (checked)", "solve_ex (unchecked)", "solve_ex (unchecked)",
                 "linalg.solve (checked)"):
        reacher.solve = solvers[name]
        try:
            env = reacher.MaReacher(2, 1, device="cuda")
            state, _ = env.reset(env.reset_noise(16, torch.Generator(device="cuda").manual_seed(0)))
            action = torch.zeros(16, 2, 1, device="cuda")
            env.step(state, action)  # traces q̈
            seconds = []
            for _ in range(5):
                torch.cuda.synchronize()
                begin = time.perf_counter()
                env.step(state, action)
                torch.cuda.synchronize()
                seconds.append((time.perf_counter() - begin) * 1e3)
            costs = launches_and_syncs(lambda: env.step(state, action))
            cfg, explore, learn, sac = sac_learner("default_ff_isac", False,
                                                   ["env=mareacher", "system.explore_steps=32"])
            sac, _ = explore(sac)
            rates = []
            for _ in range(4):
                torch.cuda.synchronize()
                begin = time.perf_counter()
                sac = learn(sac).learner_state
                torch.cuda.synchronize()
                rates.append(32 / (time.perf_counter() - begin))
        finally:
            reacher.solve = _dynamics.solve
        print(f"  MaReacher reacher-2x1 with {name}: an env step of 16 envs "
              + " ".join(f"{x:.1f}" for x in seconds) + f" ms, {costs['launches']} launches, "
              f"{costs['syncs']} host syncs, {costs['dtoh']} device-to-host copies; ff-ISAC "
              "updates after the first " + " ".join(f"{x:.1f}" for x in rates[1:])
              + f" env-steps/s on {gpu}")
    for cls in (MaHopper, MaCheetah):
        env = cls(device="cuda")
        state, _ = env.reset(env.reset_noise(16, torch.Generator(device="cuda").manual_seed(0)))
        tau = torch.zeros_like(state.q)
        integ = env.integrate
        runs = {"q̈ traced": lambda: integ.substep(state.q, state.qd, tau),
                "substep traced": lambda: integ.traced_substep(state.q, state.qd, tau)}
        traces = {}
        for name, run in runs.items():
            torch.cuda.synchronize()
            begin = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traces[name] = time.perf_counter() - begin
        err = max((a - b).abs().max().item() for a, b in zip(runs["q̈ traced"](),
                                                            runs["substep traced"]()))
        ms = {name: [] for name in runs}
        for name in ("q̈ traced", "substep traced", "q̈ traced", "substep traced"):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            for _ in range(10):
                runs[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - begin) * 1e2)
        print(f"  {cls.__name__}: first call (the trace) " + ", ".join(
            f"{k} {v:.1f} s" for k, v in traces.items()) + "; ms a substep " + ", ".join(
            f"{k} " + " ".join(f"{x:.2f}" for x in v) for k, v in ms.items())
            + f"; max |diff| {err:.1e} on {gpu}")


# ------------------------------------------------------------------ profile
def profile_phase(system: str, overrides, rollout_length: int) -> dict:
    """One full-width update of `system` under torch.profiler: where its time goes."""
    learn, state, steps = learner(system, overrides)
    state = learn(state).learner_state  # warm-up
    return profile_update(system, lambda: learn(state), steps, rollout_length)


def profile_update(label: str, run, steps: int, rollout_length: int) -> dict:
    """`run()` (one update, warmed up) under torch.profiler: host ms, launches and
    kernel ms of each span, the GRU kernels by name, the device's busy time and
    idle share. Returns them, with the launches of each span."""
    from torch.profiler import ProfilerActivity, profile

    span_prefix = ("ff_ippo/", "rec_ippo/", "rec_iql/", "sac/", "gru/", "rec_iql_vmap/",
                   "sac_vmap/")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    # The spans are mirrored on the device's timeline as annotations: not work.
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(span_prefix)]
    kernels = [e for e in on_device if not e.name.lower().startswith(("memcpy", "memset"))]
    check(len(kernels) > 0, "the profile shows no kernel: time with CUDA events instead")
    launches = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and "launch" in e.name.lower() and e.name.startswith(("cuda", "cu"))]
    spans = [e for e in events if e.name.startswith(span_prefix)
             and e.device_type == torch.autograd.DeviceType.CPU]
    print(f"  {label} update of {steps} env-steps: {wall_ms:.1f} ms host, {len(launches)} "
          f"launches, {len(kernels)} kernels")
    def launched_in(span):
        return [e for e in launches if span.time_range.start <= e.time_range.start
                <= span.time_range.end]

    # The stacked K1 is K1's kernel function; its launches sit in the wrapper's span.
    stacked_ids = {e.id for span in spans if span.name == "gru/fwd_stacked"
                   for e in launched_in(span)}
    span_launches, span_ms = {}, {}
    for span in sorted(spans, key=lambda e: e.time_range.start):
        if span.name.startswith("gru/"):
            continue
        lo, hi = span.time_range.start, span.time_range.end
        span_ms[span.name] = span_ms.get(span.name, 0.0) + (hi - lo) / 1e3
        if span.name == "sac_vmap/ring_write":  # one a step: summed below, not printed
            continue
        # A kernel belongs to the span whose host interval holds the launch
        # call it is correlated with (the two share an id).
        inside = launched_in(span)
        span_launches[span.name] = span_launches.get(span.name, 0) + len(inside)
        ids = {e.id for e in inside}
        ms = sum(k.time_range.end - k.time_range.start for k in kernels if k.id in ids) / 1e3
        per_step = (f" ({len(inside) / rollout_length:.1f} a rollout step)"
                    if span.name.endswith(("/rollout", "/act")) else "")
        print(f"  {span.name}: {(hi - lo) / 1e3:.1f} ms host, {len(inside)} launches{per_step}, "
              f"{ms:.2f} ms of kernels")
    for _, counter, _, _ in KERNELS:
        stacked = counter == "fwd_stacked"
        base = "fwd" if stacked else counter
        mine = [k for k in kernels
                if (f"gru_{base}_kernel" in k.name or f"gru_{base}_resident_kernel" in k.name)
                and (k.id in stacked_ids) == stacked]
        ms = sum(k.time_range.end - k.time_range.start for k in mine) / 1e3
        print(f"  gru_{counter}*: {len(mine)} launches, {ms:.3f} ms")
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in on_device):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    idle = 1.0 - busy / 1e3 / wall_ms
    print(f"  device busy {busy / 1e3:.1f} ms of {wall_ms:.1f} ms: idle share {idle:.3f}")
    rollout = [e for e in spans if e.name.endswith(("/rollout", "/act"))]
    per_step = (len([e for e in launches if rollout[0].time_range.start <= e.time_range.start
                     <= rollout[0].time_range.end]) / rollout_length) if rollout else None
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3, "idle_share": idle,
            "launches": len(launches), "launches_per_rollout_step": per_step,
            "span_launches": span_launches, "span_ms": span_ms}


# ------------------------------------------------------------------ resume phase
# rec-IPPO on SMAX 3s5z at its shipped width (GRU H = 128, the shipped torsos)
# with 64 envs: 4 updates in two rounds of 2, against 2 updates saved with their
# full state, then a fresh run that restores it and trains 2 more.
RESUME = SMAX + ["arch.num_envs=64", "arch.num_eval_episodes=16", "arch.absolute_metric=False",
                 "+arch.device=cuda", "logger.use_console=False"]
RESUME_SAC = ["env=maswarm", "system.explore_steps=64", "system.buffer_size=4096",
              "system.epochs=4"]


def check_bitwise(label: str, got, want) -> None:
    from mava_tpu_torch.utils.checkpointing import differences, to_host

    diffs = differences(to_host(got), to_host(want))
    for path, diff in sorted(diffs, key=lambda d: -d[1] if d[1] == d[1] else -float("inf"))[:10]:
        print(f"  {label}: {path} differs by {diff:.3e}")
    check(not diffs, f"{label}: the resumed run is not bitwise equal to the uninterrupted one "
                     f"({len(diffs)} tensors differ)")


def resume_phase(gru, gpu: str) -> dict:
    """The checkpoint path: rec-IPPO on SMAX 3s5z through `run_experiment` as a
    user resumes it (`save_full_state`, then `load_full_state` with the same
    uid), bitwise against the uninterrupted run, every kernel launched exactly
    17 / 16 times an update; one ff-ISAC resume on MaSwarm (the item buffer's
    save and restore on the card); one ff-IPPO update on RWARE after the
    staggered-reset burn-in, with the spread of the envs' step counts."""
    import os
    import tempfile

    from mava_tpu_torch.systems.ppo import rec_ippo
    from mava_tpu_torch.utils.checkpointing import Checkpointer
    from mava_tpu_torch.utils.config import load_config

    here = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            gru.reset_launch_counts()
            start = time.perf_counter()
            _, straight = rec_ippo.run_experiment(load_config("default_rec_ippo", RESUME + [
                "system.num_updates=4", "arch.num_evaluation=2"]))
            saving = ["system.num_updates=2", "arch.num_evaluation=1",
                      "logger.checkpointing.save_model=True",
                      "logger.checkpointing.save_full_state=True",
                      "logger.checkpointing.save_args.checkpoint_uid=resume"]
            rec_ippo.run_experiment(load_config("default_rec_ippo", RESUME + saving))
            _, resumed = rec_ippo.run_experiment(load_config("default_rec_ippo", RESUME + [
                "system.num_updates=2", "arch.num_evaluation=1",
                "logger.checkpointing.load_full_state=True",
                "logger.checkpointing.load_args.checkpoint_uid=resume"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = dict(gru.kernel_launches)
            (saved,) = [int(d) for d in os.listdir("checkpoints/rec_ippo/resume") if d.isdigit()]
            size = sum(os.path.getsize(os.path.join("checkpoints/rec_ippo/resume", str(saved), f))
                       for f in ("model.pt", "state.pt"))
            for _, counter, _, per_update in KERNELS:
                check(launches[counter] == per_update * 8,
                      f"resume: {counter} launched {launches[counter]} times in 8 updates, "
                      f"not {per_update} an update")
            check(resumed.learner_state.params.actor_params.rnn.wh.device.type == "cuda",
                  "resume: the restored parameters are not on the card")
            check_bitwise("rec-IPPO SMAX 3s5z resume", resumed.learner_state,
                          straight.learner_state)
            print(f"  rec-IPPO on SMAX 3s5z, 64 envs: 2 + 2 updates resumed from the full state "
                  f"saved at env-step {saved} ({size / 1e6:.1f} MB) bitwise equal to 4 "
                  f"uninterrupted updates; 3 runs {wall:.1f} s wall; launches {launches}")
            out["launches"] = launches

            # ff-ISAC on MaSwarm, cut: the explore phase and an update, saved; one
            # more against a fresh learner restored.
            start = time.perf_counter()
            _, explore, learn, state = sac_learner("default_ff_isac", False, RESUME_SAC)
            state = learn(explore(state)[0]).learner_state
            ckpt = Checkpointer(model_name="ff_isac", checkpoint_uid="sac")
            check(ckpt.save(1, state, full_state=True), "ff-ISAC: the save was skipped")
            straight_sac = learn(state).learner_state
            _, _, fresh_learn, fresh = sac_learner("default_ff_isac", False, RESUME_SAC)
            restored = Checkpointer(model_name="ff_isac", checkpoint_uid="sac").restore_full_state(fresh)
            check(restored.buffer_state.experience.reward.device.type == "cuda",
                  "ff-ISAC: the restored buffer is not on the card")
            check_bitwise("ff-ISAC MaSwarm resume", fresh_learn(restored).learner_state,
                          straight_sac)
            print(f"  ff-ISAC on MaSwarm: an update resumed with its buffer of "
                  f"{restored.buffer_state.experience.reward.shape[0]} items and env-step count "
                  f"{restored.t} bitwise equal to the uninterrupted update "
                  f"({time.perf_counter() - start:.1f} s wall)")
        finally:
            os.chdir(here)

    # ff-IPPO on RWARE tiny-2ag as shipped (16 envs, time limit 500), staggered.
    start = time.perf_counter()
    learn, state, steps = learner("ff_ippo", ["arch.stagger_resets=True"])
    torch.cuda.synchronize()
    setup = time.perf_counter() - start
    counts = state.env_state.env_state.step_count.cpu()
    out_ff = learn(state)
    check(all(torch.isfinite(v).all().item() for v in out_ff.train_metrics.values()),
          "ff-IPPO with stagger_resets: a loss is not finite")
    print(f"  ff-IPPO on RWARE tiny-2ag with stagger_resets: step counts after the burn-in "
          f"min {counts.min().item()}, max {counts.max().item()}, "
          f"{len(set(counts.tolist()))} distinct of {counts.numel()} envs; setup with the "
          f"burn-in {setup:.1f} s on {gpu}")
    out["stagger_counts"] = counts.tolist()
    return out


# ------------------------------------------------------------------ seed phase
# The stacked GRU kernels of the seed programs (`advanced_usage/*_vmap_seeds.py`)
# at the SMAX 3s5z path shapes of the shipped rec-IPPO config (16 envs x 8
# agents: B = 128 on the critic pass, 64 in the losses), S entries each with its
# own keep: (S, T, B, H).
SEED_SHAPES = [(4, 128, 128, 128), (4, 128, 64, 128), (8, 128, 128, 128), (8, 128, 64, 128)]
# name in the record, counter, launches per stacked rec-IPPO update
SEED_KERNELS = [
    ("gru_sequence_fwd, stacked over seeds (K1, per-entry keep)", "fwd_stacked", 17),
    ("gru_sequence_bwd_gates_stacked (K2p over a stack axis)", "bwd_gates_stacked", 16),
    ("gru_sequence_bwd_recurrence_stacked (K2a over a stack axis)", "bwd_recurrence_stacked", 16),
    ("gru_sequence_bwd_reduce_stacked (K2b over a stack axis)", "bwd_reduce_stacked", 16),
    ("gru_sequence_bwd_reduce_sum_stacked (K2b's sum over a stack axis)",
     "bwd_reduce_sum_stacked", 16),
]
SEED_REPLACES = "mava_tpu/ops/pallas_gru.py:{} under jax.vmap " \
                "(mava_tpu/advanced_usage/rec_ippo_vmap_seeds.py:181)"
SEED_RUN = SMAX + ["arch.num_eval_episodes=16", "arch.absolute_metric=False",
                   "+arch.device=cuda", "logger.use_console=False"]
# The launches and env-steps/s at S = 1, 4, 8 and of a stock update, cut in depth.
SEED_RATE_CUT = ["system.rollout_length=32"]


def seed_inputs(stack: int, t_len: int, b: int, h: int, seed: int, shared_keep: bool = False):
    """Per-entry gates_i, keep, h0, Wh, b_hn stacked on a leading axis (keep
    shared where `shared_keep`), and g_hs."""
    entries = [gru_inputs(t_len, b, h, seed=seed + s) for s in range(stack)]
    args = [torch.stack([e[0][i] for e in entries]).contiguous() for i in range(5)]
    if shared_keep:
        args[1] = entries[0][0][1]
    return args, torch.stack([e[1] for e in entries]).contiguous()


def check_seed_shape(gru, shape, errs: dict, shared_keep: bool = False) -> None:
    """Every stacked kernel against its plain version (the unstacked plain
    versions entry by entry) on the same inputs; the whole stacked backward
    bitwise equal across two calls."""
    stack, t_len, b, h = shape
    args, g_hs = seed_inputs(*shape, seed=stack * 1000 + b, shared_keep=shared_keep)
    tag = " shared keep" if shared_keep else ""
    where = (t_len, b, h)
    hs_ref = gru.gru_sequence_stacked_reference(*args)
    compare(f"S={stack} stacked hs{tag}", gru.gru_sequence_stacked_forward(*args), hs_ref, where,
            errs, "fwd_stacked")
    gates_ref = gru.gru_backward_gates_stacked_reference(*args, hs_ref)
    compare(f"S={stack} stacked gates{tag}", gru.gru_backward_gates_stacked(*args, hs_ref),
            gates_ref, where, errs, "bwd_gates_stacked")
    got = gru.gru_backward_recurrence_stacked(*args, hs_ref, g_hs, gates_ref)
    want = gru.gru_backward_recurrence_stacked_reference(gates_ref, args[1], args[2], args[3],
                                                         hs_ref, g_hs)
    for name, g, w in zip(("dgates_i", "dgh", "dh0"), got, want):
        compare(f"S={stack} stacked K2a {name}{tag}", g, w, where, errs, "bwd_recurrence_stacked")
    split = gru.reduce_split(t_len, b, h)
    partials = gru.gru_backward_reduce_partials_stacked(args[1], args[2], hs_ref, want[1])
    partials_ref = gru.gru_backward_reduce_partials_stacked_reference(
        args[1], args[2], hs_ref, want[1], split)
    compare(f"S={stack} stacked K2b partials{tag}", partials, partials_ref, where, errs,
            "bwd_reduce_stacked")
    for name, g, w in zip(("dWh", "db_hn"), gru.gru_backward_reduce_sum_stacked(partials_ref, h),
                          gru.gru_backward_reduce_sum_stacked_reference(partials_ref, h)):
        compare(f"S={stack} stacked K2b sum {name}{tag}", g, w, where, errs,
                "bwd_reduce_sum_stacked")
    grads = gru.gru_sequence_stacked_backward(*args, hs_ref, g_hs)
    grads_ref = gru.gru_sequence_stacked_backward_reference(*args, hs_ref, g_hs)
    for name, g, w in zip(("dgates_i", "dh0", "dWh", "db_hn"), grads, grads_ref):
        compare(f"S={stack} stacked backward {name}{tag}", g, w, where, errs, "bwd_stacked")
    again = gru.gru_sequence_stacked_backward(*args, hs_ref, g_hs)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          f"stacked gradients not bitwise equal across runs at {shape}")
    torch.cuda.synchronize()


def time_seed_shape(gru, shape, plain: bool = True) -> dict:
    """Each stacked kernel at one seed-path shape, device-only and host-inclusive,
    beside S calls of the unstacked kernel, its plain version (where `plain`),
    its bound (`bound_ms(..., stack=S)`) and, for the backward, S cuDNN backward
    calls (keep == 1) as the library's yardstick; the clusters of the resident
    launches and their waves."""
    stack, t_len, b, h = shape
    args, g_hs = seed_inputs(*shape, seed=stack * 1000 + b)
    hs = gru.gru_sequence_stacked_forward(*args)
    gates = gru.gru_backward_gates_stacked(*args, hs)
    dgh = gru.gru_backward_recurrence_stacked(*args, hs, g_hs, gates)[1]
    partials = gru.gru_backward_reduce_partials_stacked(args[1], args[2], hs, dgh)
    entries = [[a[s] for a in args] for s in range(stack)]
    per = [(e, hs[s], g_hs[s], gates[s], dgh[s], partials[s]) for s, e in enumerate(entries)]
    out = {}

    def both(name, fn, iters=20):
        out[name] = device_ms(fn, iters=iters)
        out[name + "_host"] = time_ms(fn, iters=iters)

    both("fwd_stacked", lambda: gru.gru_sequence_stacked_forward(*args))
    both("bwd_gates_stacked", lambda: gru.gru_backward_gates_stacked(*args, hs))
    both("bwd_recurrence_stacked",
         lambda: gru.gru_backward_recurrence_stacked(*args, hs, g_hs, gates))
    both("bwd_reduce_stacked",
         lambda: gru.gru_backward_reduce_partials_stacked(args[1], args[2], hs, dgh))
    both("bwd_reduce_sum_stacked", lambda: gru.gru_backward_reduce_sum_stacked(partials, h))
    both("fwd_unstacked", lambda: [gru.gru_sequence_forward(*e) for e, *_ in per])
    both("bwd_gates_unstacked", lambda: [gru.gru_backward_gates(*e, x) for e, x, *_ in per])
    both("bwd_recurrence_unstacked",
         lambda: [gru.gru_backward_recurrence(*e, x, g, q) for e, x, g, q, *_ in per])
    both("bwd_reduce_unstacked",
         lambda: [gru.gru_backward_reduce_partials(e[1], e[2], x, d) for e, x, _, _, d, _ in per])
    both("bwd_reduce_sum_unstacked",
         lambda: [gru.gru_backward_reduce_sum(p, h) for *_, p in per])
    split = gru.reduce_split(t_len, b, h)
    plain_fns = {
        "fwd_stacked_plain": lambda: gru.gru_sequence_stacked_reference(*args),
        "bwd_gates_stacked_plain": lambda: gru.gru_backward_gates_stacked_reference(*args, hs),
        "bwd_recurrence_stacked_plain": lambda: gru.gru_backward_recurrence_stacked_reference(
            gates, args[1], args[2], args[3], hs, g_hs),
        "bwd_reduce_stacked_plain": lambda: gru.gru_backward_reduce_partials_stacked_reference(
            args[1], args[2], hs, dgh, split),
        "bwd_reduce_sum_stacked_plain":
            lambda: gru.gru_backward_reduce_sum_stacked_reference(partials, h),
    }
    for name, fn in plain_fns.items():
        if plain:
            both(name, fn, iters=2)
        else:
            out[name] = out[name + "_host"] = None
    # The library's yardstick: S cuDNN GRU backward calls at keep == 1 (it cannot
    # reset), against the whole stacked backward.
    keep1 = [gru_inputs(t_len, b, h, seed=stack * 1000 + b + s, resets=0.0)[0]
             for s in range(stack)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        backwards = [cudnn_gru_backward(cudnn_gru(k[3], k[4]), k[0], k[2], g_hs[s])[2]
                     for s, k in enumerate(keep1)]
    torch.cuda.synchronize()
    run_all = lambda: [bw() for bw in backwards]  # noqa: E731
    out["cudnn_bwd_x_stack"] = device_ms(run_all, stream=side)
    with torch.cuda.stream(side):
        out["cudnn_bwd_x_stack_host"] = time_ms(run_all)
    hk = (torch.cat([args[2][:, None], hs[:, :-1]], dim=1) * args[1]).reshape(stack, -1, h)
    flat = dgh.reshape(stack, -1, 3 * h)
    both("bmm", lambda: torch.bmm(hk.transpose(1, 2), flat))
    both("sum", lambda: partials.sum(1))
    out["bwd_stacked_total"] = sum(out[k] for k in ("bwd_gates_stacked", "bwd_recurrence_stacked",
                                                    "bwd_reduce_stacked", "bwd_reduce_sum_stacked"))
    for _, counter, _ in SEED_KERNELS:
        out[counter + "_bound"], out[counter + "_bound_by"] = bound_ms(
            counter, t_len, b, h, split.slices, stack, shared_keep=False)
    for kernel in ("fwd", "bwd_recurrence"):
        c = clusters(gru, kernel, b, h, stack)
        out.update({f"{kernel}_clusters": c["clusters"], f"{kernel}_max_active": c["max_active"],
                    f"{kernel}_waves": c["waves"]})
    print(f"  S={stack} T={t_len} B={b} H={h} (seed path): "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in out.items()))
    return out


def seed_learner(stack: int, overrides=(), draws: bool = False, device: str = "cuda"):
    """(config, env, learn, state, draws) of a stacked rec-IPPO learner of
    `stack` seeds on SMAX 3s5z at the shipped width, one update a call; with
    `draws`, every draw of the update made here and handed in (for the stock
    comparison)."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.advanced_usage import common, rec_ippo_vmap_seeds
    from mava_tpu_torch.distributions import gumbel
    from mava_tpu_torch.utils.config import load_config

    cfg = rec_ippo_vmap_seeds.prepare(load_config("default_rec_ippo", SEED_RUN + list(overrides)))
    cfg.arch.n_devices = 1
    cfg.system.num_updates_per_eval = 1
    device = torch.device(device)
    env, _ = environments.make(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    inject = {}
    if draws:
        cfg.system.num_agents = env.num_agents
        d = common.Draws(stack, False, torch.Generator(device=device).manual_seed(7), device)
        e, t_len = cfg.arch.num_envs, cfg.system.rollout_length
        inject = dict(
            noise=d(gumbel, (t_len, e, env.num_agents, env.action_dim))[None],
            permutations=d.permutations(cfg.system.ppo_epochs,
                                        e * t_len // cfg.system.recurrent_chunk_size)[None],
            env_noise=[[d.env(env, e) for _ in range(t_len)]],
        )
    learn, _, state = rec_ippo_vmap_seeds.learner_setup(env, gen, cfg, device, stack, **inject)
    return cfg, env, learn, state, inject


def stacked_against_stock(stack: int, overrides=(), device: str = "cuda") -> float:
    """One stacked update of `stack` seeds against `stack` stock rec-IPPO updates,
    each from its entry's slice of the parameters and envs and its slice of the
    draws; returns the largest parameter difference."""
    from mava_tpu_torch.systems.ppo import rec_ippo

    cfg, env, learn, state, inject = seed_learner(stack, overrides, draws=True, device=device)
    e = cfg.arch.num_envs
    initial = [[p[s].detach().clone() for p in net.parameters()] for net in state.params
               for s in range(stack)]
    rows = lambda tree, s: pytree.tree_map(  # noqa: E731
        lambda x: x[s * e:(s + 1) * e].clone() if isinstance(x, torch.Tensor) and x.dim() else x,
        tree)
    slices = [(rows(state.env_state, s), rows(state.timestep, s)) for s in range(stack)]
    out = learn(state)
    worst = 0.0
    for s in range(stack):
        stock_learn, _, stock = rec_ippo.learner_setup(
            env, torch.Generator(device=device).manual_seed(0), cfg, torch.device(device),
            noise=inject["noise"][:, s], permutations=inject["permutations"][:, s],
            env_noise=[[rows(x, s) for x in inject["env_noise"][0]]])
        with torch.no_grad():
            for net, start in zip(stock.params, initial[s::stack]):
                for p, q in zip(net.parameters(), start):
                    p.copy_(q)
        stock = stock._replace(env_state=slices[s][0], timestep=slices[s][1])
        got = stock_learn(stock)
        for net, stacked in zip(got.learner_state.params, out.learner_state.params):
            for p, q in zip(net.parameters(), stacked.parameters()):
                worst = max(worst, (p.detach() - q[s].detach()).abs().max().item())
    check(worst <= 1e-4, f"the stacked update of {stack} seeds disagrees with the stock "
                         f"updates: max |param diff| {worst:.3e}")
    return worst


def seed_phase(gru, gpu: str) -> dict:
    """The seed axis: the stacked kernels against their plain versions at the
    seed path's shapes and timed; rec_ippo_vmap_seeds through run_experiment at
    S = 4 with the exact launch counts; one stacked update against 4 stock ones;
    an ff-IPPO lr sweep and a rec-IPPO PBT, cut in depth; the launches of a
    whole update at S = 8 against S = 1; env-steps/s beside one stock update."""
    from mava_tpu_torch.advanced_usage import ff_ippo_vmap_sweep, rec_ippo_pbt, rec_ippo_vmap_seeds
    from mava_tpu_torch.utils.config import load_config

    start = time.perf_counter()
    errs: dict = {}
    for shape in SEED_SHAPES:
        check_seed_shape(gru, shape, errs)
    check_seed_shape(gru, SEED_SHAPES[0], errs, shared_keep=True)
    # The plain versions are timed at S = 4; at S = 8 they take twice as long.
    times = {shape: time_seed_shape(gru, shape, plain=shape[0] == 4) for shape in SEED_SHAPES}
    print(f"  ({time.perf_counter() - start:.1f} s into the seed phase)")

    # The main path: two updates of 4 seeds through run_experiment.
    gru.reset_launch_counts()
    performance = rec_ippo_vmap_seeds.run_experiment(load_config("default_rec_ippo", SEED_RUN + [
        "system.num_updates=2", "arch.num_evaluation=1", "+system.num_seeds=4"]))
    torch.cuda.synchronize()
    launches = dict(gru.kernel_launches)
    check(performance == performance, "rec_ippo_vmap_seeds: the eval return is not a number")
    for _, counter, per_update in SEED_KERNELS:
        check(launches[counter] == 2 * per_update,
              f"rec_ippo_vmap_seeds: {counter} launched {launches[counter]} times in 2 updates, "
              f"not {per_update} an update")
    for _, counter, _, _ in KERNELS:
        check(counter == "fwd_stacked" or launches[counter] == 0,
              f"rec_ippo_vmap_seeds launched the unstacked {counter}")
    print(f"  rec_ippo_vmap_seeds run_experiment, S = 4, 2 updates on SMAX 3s5z: eval return "
          f"{performance:.3f}, launches {launches}")

    print(f"  ({time.perf_counter() - start:.1f} s into the seed phase)")
    worst = stacked_against_stock(4)
    print(f"  one stacked update of 4 seeds against 4 stock updates from the same draws: "
          f"max |param diff| {worst:.3e} ({time.perf_counter() - start:.1f} s into the phase)")

    sweep = ff_ippo_vmap_sweep.run_experiment(load_config("default_ff_ippo", [
        "system.num_updates=2", "arch.num_evaluation=1", "arch.num_eval_episodes=16",
        "arch.absolute_metric=False", "+arch.device=cuda", "logger.use_console=False",
        "+system.sweep_lrs=[1e-4, 2.5e-4, 5e-4, 1e-3]"]))
    check(sweep == sweep, "ff_ippo_vmap_sweep: the eval return is not a number")
    gru.reset_launch_counts()
    pbt = rec_ippo_pbt.run_experiment(load_config("default_rec_ippo", SEED_RUN + [
        "system.num_updates=2", "arch.num_evaluation=2", "+system.pbt_population=4"]))
    check(pbt == pbt, "rec_ippo_pbt: the best member's win rate is not a number")
    check(gru.kernel_launches["fwd_stacked"] == 2 * 17, "rec_ippo_pbt: stacked K1 launches")
    print(f"  ff_ippo_vmap_sweep, 4 lrs, 2 updates: mean eval return {sweep:.3f}; rec_ippo_pbt, "
          f"4 members, 2 rounds with one exploit step: best win rate {pbt:.3f} "
          f"({time.perf_counter() - start:.1f} s into the phase)")

    # Launches of a whole update (the profiler's launch calls) and env-steps/s,
    # at a rollout cut to 32 steps (128 until the programs phase came).
    rates, counts = {}, {}
    for stack in (1, 4, 8):
        cfg, _, learn, state, _ = seed_learner(stack, SEED_RATE_CUT)
        state = learn(state).learner_state  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = learn(state).learner_state
        torch.cuda.synchronize()
        steps = stack * cfg.system.rollout_length * cfg.arch.num_envs
        rates[stack] = steps / (time.perf_counter() - t0)
        if stack in (1, 8):
            counts[stack] = launches_and_syncs(lambda: learn(state))["launches"]
    stock_s, _, _, steps = one_update("rec_ippo", SMAX + SEED_RATE_CUT, repeats=2)
    ratio = counts[8] / counts[1]
    check(ratio <= 1.5, f"a stacked update launches {ratio:.2f}x at S = 8 what it does at S = 1")
    print(f"  a stacked rec-IPPO update, rollout 32: {counts[1]} launches at S = 1, {counts[8]} "
          f"at S = 8 "
          f"({ratio:.3f}x); env-steps/s S = 1 {rates[1]:.1f}, S = 4 {rates[4]:.1f}, S = 8 "
          f"{rates[8]:.1f}; one stock update {steps / stock_s[-1]:.1f} on {gpu}")
    print(f"  seed phase: {time.perf_counter() - start:.1f} s")
    return {"errs": errs, "times": times, "launches": launches, "launch_counts": counts,
            "rates": rates, "stacked_vs_stock": worst}


# ------------------------------------------------------------------ off-policy seed phase
# rec-IQL's stacked GRU path on SMAX 3s5z (`rec_iql_vmap_seeds`: 32 sampled sequences
# of 20 steps x 8 agents): the fused target pass is the stacked K1 over 2S entries,
# each (online, target) pair with its seed's keep; the loss pass the stacked K1 and
# the stacked backward over S. Timed at S = 4.
OFF_POLICY_SEEDS = 4
OFF_POLICY_SHAPE = (20, 256, 128)
# launches of a stacked rec-IQL update (epochs = 2), at any S
IQL_VMAP_PER_UPDATE = {"fwd_stacked": 4, "bwd_gates_stacked": 2, "bwd_recurrence_stacked": 2,
                       "bwd_reduce_stacked": 2, "bwd_reduce_sum_stacked": 2}
IQL_VMAP_RUN = SMAX + ["system.num_updates=2", "arch.num_evaluation=1",
                       "arch.num_eval_episodes=16", "arch.absolute_metric=False",
                       "+arch.device=cuda", "logger.use_console=False"]
# The SAC seed programs on MaSwarm at the shipped width (16 envs, rollout 2, batch 32,
# delay 4), cut in depth: a 64-step explore phase, a 65,536-item ring an entry, 8
# epochs an update (the rates and the profiled update too), and 2 rounds of 1
# update (total 96 = 3 rounds of 32 env-steps, the first of which the explore
# phase takes).
SAC_VMAP_CUTS = ["system.explore_steps=64", "system.buffer_size=65536", "system.epochs=8",
                 "system.total_timesteps=96", "arch.num_evaluation=3"]
SAC_VMAP_RUN = SAC_VMAP_CUTS + ["arch.num_eval_episodes=16", "arch.absolute_metric=False",
                                "+arch.device=cuda", "logger.use_console=False"]


def pair_inputs(seeds: int, t_len: int, b: int, h: int, seed: int):
    """rec-IQL's target pass: 2S entries (the online networks, then the targets),
    each pair with its seed's keep."""
    args, _ = seed_inputs(2 * seeds, t_len, b, h, seed)
    args[1] = torch.cat([args[1][:seeds]] * 2).contiguous()
    return args


def offpolicy_kernels(gru, errs: dict) -> dict:
    """The stacked K1 over 2S with the per-pair keep and the stacked backward over
    S at rec-IQL's shape: against their plain versions, bitwise repeatable,
    timed beside their bounds, 2S (or S) unstacked calls and the library."""
    seeds, (t_len, b, h) = OFF_POLICY_SEEDS, OFF_POLICY_SHAPE
    args = pair_inputs(seeds, t_len, b, h, seed=4242)
    hs = gru.gru_sequence_stacked_forward(*args)
    compare(f"2S={2 * seeds} target pass hs", hs, gru.gru_sequence_stacked_reference(*args),
            OFF_POLICY_SHAPE, errs, "fwd_stacked")
    check(torch.equal(hs, gru.gru_sequence_stacked_forward(*args)),
          "the stacked K1 over 2S is not bitwise repeatable")
    check_seed_shape(gru, (seeds, *OFF_POLICY_SHAPE), errs)
    pair = {}
    entries = [[a[s] for a in args] for s in range(2 * seeds)]
    for name, fn, iters in (
            ("fwd_stacked_2s", lambda: gru.gru_sequence_stacked_forward(*args), 20),
            ("fwd_unstacked_x_2s", lambda: [gru.gru_sequence_forward(*e) for e in entries], 20),
            ("fwd_stacked_2s_plain", lambda: gru.gru_sequence_stacked_reference(*args), 2)):
        pair[name], pair[name + "_host"] = device_ms(fn, iters=iters), time_ms(fn, iters=iters)
    keep1 = [gru_inputs(t_len, b, h, seed=4242 + s, resets=0.0)[0] for s in range(2 * seeds)]
    rnns = [cudnn_gru(k[3], k[4]) for k in keep1]
    with torch.no_grad():
        run = lambda: [rnn(k[0], k[2][None]) for rnn, k in zip(rnns, keep1)]  # noqa: E731
        pair["cudnn_fwd_x_2s"], pair["cudnn_fwd_x_2s_host"] = device_ms(run), time_ms(run)
    pair["bound"], pair["bound_by"] = bound_ms("fwd_stacked", t_len, b, h, stack=2 * seeds,
                                               shared_keep=False)
    pair.update(clusters(gru, "fwd", b, h, 2 * seeds))
    print(f"  stacked K1 over 2S = {2 * seeds}, T={t_len} B={b} H={h}, per-pair keep: "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in pair.items()))
    return {"pair": pair, "loss": time_seed_shape(gru, (seeds, *OFF_POLICY_SHAPE))}


def iql_vmap_learner(stack: int, draws: bool = False, overrides=(), device: str = "cuda"):
    """(config, env, learn, state, draws) of a stacked rec-IQL learner of `stack`
    seeds on SMAX 3s5z at the shipped config, one update a call; with `draws`,
    every draw of the update made here and handed in."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.advanced_usage import common, rec_iql_vmap_seeds
    from mava_tpu_torch.distributions import gumbel
    from mava_tpu_torch.systems.q_learning.types import Draws
    from mava_tpu_torch.utils.config import load_config

    cfg = load_config("default_rec_iql", IQL_VMAP_RUN + list(overrides))
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = cfg.system.num_updates_per_eval = 1  # stacked; stock
    device = torch.device(device)
    env, _ = environments.make(cfg, device)
    cfg.system.num_agents = env.num_agents
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    inject = None
    if draws:
        d = common.Draws(stack, False, torch.Generator(device=device).manual_seed(7), device)
        e, sys_cfg = cfg.arch.num_envs, cfg.system
        randint = lambda high: lambda shape, g, dev: torch.randint(  # noqa: E731
            0, high, shape, generator=g, device=dev)
        shape = (sys_cfg.epochs, sys_cfg.sample_batch_size)
        inject = Draws(
            action_noise=d(gumbel, (sys_cfg.rollout_length, e, env.num_agents, env.action_dim)),
            env_noise=[d.env(env, e) for _ in range(sys_cfg.rollout_length)],
            rows=d(randint(e), shape),
            # one start: the ring holds the update's own 2 steps, fewer than a sequence
            starts=d(randint(1), shape))
    learn, _, state = rec_iql_vmap_seeds.learner_setup(
        env, gen, cfg, device, stack, draws=None if inject is None else [inject])
    return cfg, env, learn, state, inject


def iql_vmap_against_stock(stack: int, device: str = "cuda") -> float:
    """One stacked rec-IQL update of `stack` seeds against `stack` stock updates,
    each from its entry's slice of the networks, envs, carries and draws; returns
    the largest parameter difference."""
    from mava_tpu_torch.systems.q_learning import rec_iql
    from mava_tpu_torch.systems.q_learning.types import Draws

    cfg, env, learn, state, inject = iql_vmap_learner(stack, draws=True, device=device)
    e, device = cfg.arch.num_envs, torch.device(device)
    rows = lambda tree, s: pytree.tree_map(  # noqa: E731
        lambda x: x[s * e:(s + 1) * e].clone() if isinstance(x, torch.Tensor) and x.dim() else x,
        tree)
    stocks = []
    for s in range(stack):
        draws = Draws(inject.action_noise[s], [rows(x, s) for x in inject.env_noise],
                      inject.rows[s], inject.starts[s])
        stock_learn, _, stock = rec_iql.learner_setup(
            env, torch.Generator(device=device).manual_seed(0), cfg, device, draws=[draws])
        with torch.no_grad():
            for net, stacked in zip(stock.params, state.params):
                for name, p in net.named_parameters():
                    p.copy_(stacked.params[name][s])
        stocks.append((stock_learn, stock._replace(
            obs=rows(state.obs, s), terminal=rows(state.terminal, s),
            term_or_trunc=rows(state.term_or_trunc, s), env_state=rows(state.env_state, s))))
    out = learn(state)
    worst = 0.0
    for s, (stock_learn, stock) in enumerate(stocks):
        got = stock_learn(stock)
        for net, stacked in zip(got.learner_state.params, out.learner_state.params):
            for name, p in net.named_parameters():
                worst = max(worst, (p.detach() - stacked.params[name][s]).abs().max().item())
    check(worst <= 1e-4, f"the stacked rec-IQL update of {stack} seeds disagrees with the stock "
                         f"updates: max |param diff| {worst:.3e}")
    return worst


def stacked_rates(label: str, make, steps_of, gpu: str) -> dict:
    """env-steps/s of one stacked update at S = 1, 4, 8 (after a warm-up one) and
    the launches of a whole update at S = 8 against S = 1 (at most 1.5x)."""
    rates, counts = {}, {}
    for stack in (1, 4, 8):
        learn, state = make(stack)
        state = learn(state).learner_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = learn(state).learner_state
        torch.cuda.synchronize()
        rates[stack] = stack * steps_of / (time.perf_counter() - t0)
        if stack in (1, 8):
            counts[stack] = launches_and_syncs(lambda: learn(state))["launches"]
    ratio = counts[8] / counts[1]
    check(ratio <= 1.5, f"a stacked {label} update launches {ratio:.2f}x at S = 8 what it "
                        "does at S = 1")
    print(f"  a stacked {label} update: {counts[1]} launches at S = 1, {counts[8]} at S = 8 "
          f"({ratio:.3f}x); env-steps/s S = 1 {rates[1]:.1f}, S = 4 {rates[4]:.1f}, S = 8 "
          f"{rates[8]:.1f} on {gpu}")
    return {"rates": rates, "launches": counts, "ratio": ratio}


def sac_vmap_learner(stack: int, centralised: bool = False, overrides=()):
    """(config, explore, learn, state) of a stacked SAC learner of `stack` seeds
    on MaSwarm at the shipped config plus `overrides`, one update a call."""
    from mava_tpu_torch import envs as environments
    from mava_tpu_torch.advanced_usage import ff_isac_vmap_seeds
    from mava_tpu_torch.utils.config import load_config

    cfg = load_config("default_ff_masac" if centralised else "default_ff_isac",
                      ["+arch.device=cuda", *overrides])
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = 1
    device = torch.device("cuda")
    env, _ = environments.make(cfg, device, add_global_state=centralised)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    explore, learn, _, state = ff_isac_vmap_seeds.learner_setup(env, gen, cfg, device, stack,
                                                               centralised)
    return cfg, explore, learn, state


def sac_vmap_run(gru, label: str, module, config_name: str, extra) -> float:
    """A SAC seed program through `run_experiment` at `SAC_VMAP_RUN`: no GRU
    launch, the return a number."""
    from mava_tpu_torch.utils.config import load_config

    gru.reset_launch_counts()
    start = time.perf_counter()
    performance = module.run_experiment(load_config(config_name, SAC_VMAP_RUN + extra))
    torch.cuda.synchronize()
    check(performance == performance, f"{label}: the eval return is not a number")
    check(not any(gru.kernel_launches.values()), f"{label} launched a GRU kernel")
    print(f"  {label} run_experiment ({', '.join(extra)}): mean eval return {performance:.3f}, "
          f"{time.perf_counter() - start:.1f} s")
    return performance


def offpolicy_phase(gru, gpu: str) -> dict:
    """The off-policy seed axis: the stacked kernels at rec-IQL's new stack shapes;
    rec_iql_vmap_seeds through run_experiment at S = 4 with the exact launch
    counts; one stacked rec-IQL update against 4 stock ones; ff_isac_vmap_seeds
    and ff_masac_vmap_sweep through run_experiment, cut in depth; env-steps/s at
    S = 1, 4, 8 and the launch ratios; the ring write's share of the act step;
    the vault written by the recording program and read by bc_from_vault."""
    import os
    import tempfile

    from mava_tpu_torch.advanced_usage import (
        ff_ippo_store_experience,
        ff_isac_vmap_seeds,
        ff_masac_vmap_sweep,
        rec_iql_vmap_seeds,
    )
    from mava_tpu_torch.examples import bc_from_vault
    from mava_tpu_torch.utils.config import load_config

    start = time.perf_counter()
    errs: dict = {}
    times = offpolicy_kernels(gru, errs)
    print(f"  ({time.perf_counter() - start:.1f} s into the off-policy phase)")

    # The main path: two updates of 4 seeds through run_experiment.
    gru.reset_launch_counts()
    performance = rec_iql_vmap_seeds.run_experiment(load_config(
        "default_rec_iql", IQL_VMAP_RUN + [f"+system.num_seeds={OFF_POLICY_SEEDS}"]))
    torch.cuda.synchronize()
    launches = dict(gru.kernel_launches)
    check(performance == performance, "rec_iql_vmap_seeds: the eval return is not a number")
    for counter, per_update in IQL_VMAP_PER_UPDATE.items():
        check(launches[counter] == 2 * per_update,
              f"rec_iql_vmap_seeds: {counter} launched {launches[counter]} times in 2 updates, "
              f"not {per_update} an update")
    for _, counter, _, _ in KERNELS:
        check(counter == "fwd_stacked" or launches[counter] == 0,
              f"rec_iql_vmap_seeds launched the unstacked {counter}")
    print(f"  rec_iql_vmap_seeds run_experiment, S = {OFF_POLICY_SEEDS}, 2 updates on SMAX 3s5z: "
          f"eval return {performance:.3f}, launches {launches}")
    worst = iql_vmap_against_stock(OFF_POLICY_SEEDS)
    print(f"  one stacked rec-IQL update of {OFF_POLICY_SEEDS} seeds against "
          f"{OFF_POLICY_SEEDS} stock updates from the same draws: max |param diff| {worst:.3e}")

    def iql(stack):
        _, _, learn, state, _ = iql_vmap_learner(stack)
        return learn, state

    cfg, _, _, state, _ = iql_vmap_learner(8)
    ring = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(state.buffer_state.experience))
    del state
    iql_steps = cfg.system.rollout_length * cfg.arch.num_envs
    torch.cuda.reset_peak_memory_stats()
    iql_rates = stacked_rates("rec-IQL", iql, iql_steps, gpu)
    stock_s, _, _, _ = one_update("rec_iql", SMAX, repeats=3)
    print(f"  rec-IQL: one stock update {iql_steps / stock_s[-1]:.1f} env-steps/s; the ring "
          f"{ring / 8 / 1e6:.3f} MB an entry ({cfg.system.buffer_size} steps x "
          f"{cfg.arch.num_envs} envs); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"({time.perf_counter() - start:.1f} s into the phase)")

    print(f"  SAC cuts (MaSwarm, shipped width): {' '.join(SAC_VMAP_CUTS)}")
    sac_vmap_run(gru, "ff_isac_vmap_seeds", ff_isac_vmap_seeds, "default_ff_isac",
                 [f"+system.num_seeds={OFF_POLICY_SEEDS}"])
    sac_vmap_run(gru, "ff_masac_vmap_sweep", ff_masac_vmap_sweep, "default_ff_masac",
                 ["+system.sweep_lrs=[1e-4, 3e-4, 1e-3, 3e-3]"])

    def isac(stack):
        _, explore, learn, state = sac_vmap_learner(stack, overrides=SAC_VMAP_CUTS[:3])
        return learn, explore(state)[0]

    cfg, explore, learn, state = sac_vmap_learner(OFF_POLICY_SEEDS, overrides=SAC_VMAP_CUTS[:3])
    state = learn(explore(state)[0]).learner_state
    sac_steps = cfg.system.rollout_length * cfg.arch.num_envs
    prof = profile_update(f"ff_isac_vmap_seeds S = {OFF_POLICY_SEEDS}", lambda: learn(state),
                          sac_steps, cfg.system.rollout_length)
    act_ms, ring_ms = prof["span_ms"].get("sac_vmap/act", 0.0), prof["span_ms"].get(
        "sac_vmap/ring_write", 0.0)
    print(f"  ff_isac_vmap_seeds S = {OFF_POLICY_SEEDS} (epochs {cfg.system.epochs}): the ring "
          f"writes take {ring_ms:.2f} of the act steps' {act_ms:.2f} ms host "
          f"({ring_ms / max(act_ms, 1e-9):.3f}), idle share {prof['idle_share']:.3f}")
    del state
    sac_rates = stacked_rates("ff-ISAC", isac, sac_steps, gpu)
    stock_sac = sac_updates("ff_isac on MaSwarm (stock)", "default_ff_isac", False,
                            SAC_VMAP_CUTS[:3], gpu, 1, profiled=False)

    # The vault: the recording program on the card, then behaviour cloning from it.
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=os.path.join(cwd, "build")) as tmp:
        os.chdir(tmp)
        try:
            recorded = ff_ippo_store_experience.run_experiment(load_config("default_ff_ippo", [
                "system.num_updates=2", "arch.num_evaluation=2", "+arch.device=cuda",
                "logger.use_console=False", "logger.system_name=ff_ippo_store_experience"]))
            cloned = bc_from_vault.main(["bc_epochs=2", "bc_batch_size=2048",
                                         "arch.num_eval_episodes=16"])
        finally:
            os.chdir(cwd)
    check(recorded == recorded and cloned == cloned, "the vault phase's returns are not numbers")
    print(f"  vault: ff_ippo_store_experience 2 updates (mean return {recorded:.3f}), "
          f"bc_from_vault 2 epochs (eval return {cloned:.3f})")
    print(f"  off-policy phase: {time.perf_counter() - start:.1f} s")
    return {"errs": errs, "times": times, "launches": launches, "iql": iql_rates,
            "sac": sac_rates, "stacked_vs_stock": worst, "ring_share": ring_ms / max(act_ms, 1e-9),
            "stock_sac": stock_sac}


# The distributed phase: rec-IPPO at the shipped width (16 envs, rollout 128,
# 4 epochs x 2 minibatches), 2 updates and one evaluation through torchrun.
DISTRIBUTED_RUN = ["system.num_updates=2", "arch.num_evaluation=1", "arch.num_eval_episodes=16",
                   "arch.absolute_metric=False"]
DISTRIBUTED_REPEATS = 2
# The recording program through torchrun (NCCL, world 1): ff-IPPO on RWARE
# tiny-2ag as shipped, 2 updates in 2 rounds (one vault chunk a round); and an
# lr sweep of 2 entries with staggered resets.
STORE_RUN = ["system.num_updates=2", "arch.num_evaluation=2"]
STAGGER_SWEEP_LRS = [1e-4, 1e-3]


def store_through_torchrun(workdir: str) -> dict:
    """`ff_ippo_store_experience` through torchrun at world 1 (NCCL) in
    `workdir`; its vault read back ({leaf name: array})."""
    import os

    from mava_tpu_torch.replay.vault import Vault

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.getcwd(), env.get("PYTHONPATH", "")])
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
         "-m", "mava_tpu_torch.advanced_usage.ff_ippo_store_experience", *STORE_RUN],
        capture_output=True, text=True, timeout=300, cwd=workdir, env=env)
    wall = time.perf_counter() - start
    check(proc.returncode == 0, f"torchrun ff_ippo_store_experience exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    check("ff-IPPO experience-recording run completed." in proc.stdout
          and proc.stdout.count("Experience stored in ") == 1,
          "torchrun ff_ippo_store_experience printed no completed or stored line")
    root = os.path.join(workdir, "vaults", "ff_ippo_store_experience")
    uids = os.listdir(root)
    check(len(uids) == 1, f"{len(uids)} vaults written, not one")
    print(f"  torchrun --nproc-per-node=1 ff_ippo_store_experience (NCCL, world 1): 2 updates "
          f"in 2 rounds, exit 0 in {wall:.1f} s wall, one vault")
    return Vault("ff_ippo_store_experience", rel_dir=os.path.join(workdir, "vaults"),
                 vault_uid=uids[0]).read()


def store_in_process(mesh, vault: dict) -> dict:
    """The recording program's learner in this process, from the same seed on
    the same mesh: each round's trajectories through `gather_env_rows`, held
    against `vault` (bitwise, or the largest difference); one gather a round."""
    import numpy as np

    from mava_tpu_torch.advanced_usage.ff_ippo_store_experience import batch_major
    from mava_tpu_torch.parallel import distributed
    from mava_tpu_torch.replay.vault import leaf_names
    from mava_tpu_torch.systems.anakin import schedule_updates
    from mava_tpu_torch.systems.ppo import ff_ippo

    environments, load_config, _ = port()
    cfg = load_config("default_ff_ippo", STORE_RUN + ["+arch.device=cuda"])
    cfg.arch.n_devices = mesh.world_size
    device = torch.device("cuda", 0)
    env, _ = environments.make(cfg, device)
    cfg = schedule_updates(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    learn, _, state = ff_ippo.learner_setup(env, gen, cfg, device, return_trajectories=True,
                                            mesh=mesh)
    before = distributed.env_row_gathers
    rounds = []
    for _ in range(cfg.arch.num_evaluation):
        out, trajectories = learn(state)
        rounds.append(batch_major(distributed.gather_env_rows(trajectories, mesh)))
        state = out.learner_state
    torch.cuda.synchronize()
    gathers = distributed.env_row_gathers - before
    check(gathers == len(rounds), f"{gathers} gathers in {len(rounds)} rounds, not one a round")
    names = leaf_names(rounds[0])
    check(sorted(names) == sorted(vault), f"vault leaves {sorted(vault)}, not {sorted(names)}")
    round_bytes = sum(x.numel() * x.element_size() for x in pytree.tree_leaves(rounds[0]))
    differ = {}
    for i, name in enumerate(names):
        want = np.concatenate([pytree.tree_leaves(r)[i].cpu().numpy() for r in rounds], axis=1)
        got = vault[name]
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"vault leaf {name}: {got.dtype} {got.shape}, not {want.dtype} {want.shape}")
        if not np.array_equal(got, want):
            differ[name] = float(np.max(np.abs(got.astype(np.float64) - want)))
    worst = max(differ.values(), default=0.0)
    print(f"  its vault ({len(names)} leaves, {vault['.action'].shape[0]} rows x "
          f"{vault['.action'].shape[1]} steps) against the same learner in this process: "
          + ("bitwise equal" if not differ else f"differs in {differ}")
          + f"; {gathers} gathers in {len(rounds)} rounds; {round_bytes:,} vault bytes a round")
    check(worst <= 1e-6, f"the vault differs from the in-process trajectories by {worst}")
    return {"vault_bytes_a_round": round_bytes, "gathers": gathers, "bitwise": not differ,
            "max_abs_err": worst}


def staggered_sweep() -> dict:
    """One stacked `ff_ippo_vmap_sweep` update of 2 lrs with
    `arch.stagger_resets=True` under the group: the two entries start from
    bitwise-equal, staggered env states; finite losses, one all-reduce a
    minibatch step."""
    from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds
    from mava_tpu_torch.parallel import make_seed_sharded_mesh
    from mava_tpu_torch.parallel import mesh as mesh_module

    environments, load_config, _ = port()
    cfg = load_config("default_ff_ippo", ["arch.stagger_resets=True", "+arch.device=cuda"])
    mesh = make_seed_sharded_mesh(1)
    cfg.arch.n_devices, cfg.system.num_updates_per_eval = mesh.data_size, 1
    device = torch.device("cuda", 0)
    env, _ = environments.make(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    start = time.perf_counter()
    learn, _, state = ff_ippo_vmap_seeds.learner_setup(
        env, gen, cfg, device, len(STAGGER_SWEEP_LRS), sweep_lrs=STAGGER_SWEEP_LRS, mesh=mesh)
    torch.cuda.synchronize()
    setup = time.perf_counter() - start
    n = cfg.arch.num_envs
    rows = [x for x in pytree.tree_leaves((state.env_state, state.timestep))
            if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] == 2 * n]
    same = all(torch.equal(x[:n], x[n:]) for x in rows)
    counts = state.env_state.env_state.step_count[:n]
    spread = len(set(counts.tolist()))
    print(f"  ff_ippo_vmap_sweep, 2 lrs, stagger_resets (NCCL, world 1): the entries' "
          f"{len(rows)} env tensors bitwise {'equal' if same else 'DIFFERENT'}; "
          f"{spread} distinct step counts of {n} envs; setup {setup:.1f} s")
    check(same and rows, "a staggered sweep's entries start from different env states")
    check(spread > 1, f"the burn-in left step counts {counts.tolist()}")
    before = mesh_module.all_reduces
    out = learn(state)
    torch.cuda.synchronize()
    reduces = mesh_module.all_reduces - before
    # A seed group of one rank (world 1 here) has no data group and no collective.
    steps = cfg.system.ppo_epochs * cfg.system.num_minibatches if mesh.data_group else 0
    check(all(bool(torch.isfinite(v).all()) for v in out.train_metrics.values()),
          "the staggered sweep's losses are not finite")
    check(reduces == steps, f"the staggered sweep update made {reduces} all-reduces, not {steps}")
    print(f"  one stacked update from there: losses finite, {reduces} all-reduces "
          f"(a seed group of {mesh.data_size} rank)")
    return {"stagger_spread": spread, "sweep_all_reduces": reduces}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distributed_learner(mesh, draws):
    """(learn, state, env-steps an update) of rec-IPPO at the shipped width on
    `mesh`, from the seed's state, with `draws` (noise, permutations) handed in."""
    environments, load_config, _ = port()
    from mava_tpu_torch.systems.ppo import rec_ippo

    cfg = load_config("default_rec_ippo", SLICE_OVERRIDES)
    cfg.arch.n_devices = mesh.world_size
    cfg.system.recurrent_chunk_size = cfg.system.rollout_length
    cfg.system.num_updates_per_eval = 1
    device = torch.device("cuda", 0)
    env, _ = environments.make(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.system.seed)
    learn, _, state = rec_ippo.learner_setup(env, gen, cfg, device, noise=draws[0],
                                             permutations=draws[1], mesh=mesh)
    return learn, state, cfg.system.rollout_length * cfg.arch.num_envs, cfg, env


def distributed_phase(gru, gpu: str) -> dict:
    """rec-IPPO data-parallel under NCCL at world size 1 (one card): through
    torchrun as a user launches it, then one data-parallel update against one
    stock update in this process, its launches and its all-reduces."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mava_tpu_torch.networks.factory import make_rollout_noise_fn
    from mava_tpu_torch.parallel import Mesh, make_mesh
    from mava_tpu_torch.parallel import mesh as mesh_module
    from mava_tpu_torch.utils.training import epoch_permutations

    start = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    store_dir = tempfile.mkdtemp(dir="build")
    try:
        vault = store_through_torchrun(store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
         "-m", "mava_tpu_torch.systems.ppo.rec_ippo", *DISTRIBUTED_RUN],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - start
    check(proc.returncode == 0, f"torchrun rec-IPPO exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    check("Recurrent IPPO experiment completed." in proc.stdout,
          "torchrun rec-IPPO printed no completed line")
    misc = [line for line in proc.stderr.splitlines() if "MISC" in line]
    print(f"  torchrun --nproc-per-node=1 rec_ippo (NCCL, world 1): 2 updates and one "
          f"evaluation, exit 0 in {wall:.1f} s wall; {misc[-1].strip() if misc else ''}")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        mesh = make_mesh()
        check(mesh.data_group is not None and mesh.world_size == 1, f"mesh {mesh}")
        _, _, _, cfg, env = distributed_learner(Mesh(), (None, None))
        device = torch.device("cuda", 0)
        draw_gen = torch.Generator(device=device).manual_seed(7)
        rollout, envs = cfg.system.rollout_length, cfg.arch.num_envs
        noise = make_rollout_noise_fn(cfg.network.action_head)(
            (rollout, envs, env.num_agents, env.action_dim), draw_gen, device)[None]
        perms = epoch_permutations(cfg.system.ppo_epochs, envs, draw_gen, device)[None]

        def first_update(on):
            learn, state, steps, _, _ = distributed_learner(on, (noise, perms))
            gru.reset_launch_counts()
            before = mesh_module.all_reduces
            out = learn(state)
            torch.cuda.synchronize()
            launches = dict(gru.kernel_launches)
            params = [p.detach().clone() for net in out.learner_state.params
                      for p in net.parameters()]
            return (learn, out), params, launches, mesh_module.all_reduces - before, steps

        (stock_learn, stock), stock_params, stock_launches, stock_reduces, steps = \
            first_update(Mesh())
        (dp_learn, dp), dp_params, dp_launches, dp_reduces, _ = first_update(mesh)
        same = all(torch.equal(a, b) for a, b in zip(stock_params, dp_params))
        same_losses = all(torch.equal(stock.train_metrics[k], dp.train_metrics[k])
                          for k in stock.train_metrics)
        print(f"  one update, data-parallel (NCCL world 1) vs stock: parameters bitwise "
              f"{'equal' if same else 'DIFFERENT'}, losses bitwise "
              f"{'equal' if same_losses else 'DIFFERENT'}")
        check(same and same_losses, "the data-parallel update differs from the stock one")
        minibatch_steps = cfg.system.ppo_epochs * cfg.system.num_minibatches
        check(stock_reduces == 0, f"the stock update made {stock_reduces} all-reduces")
        check(dp_reduces == minibatch_steps, f"{dp_reduces} all-reduces, not {minibatch_steps}")
        for _, counter, _, per_update in KERNELS:
            check(dp_launches[counter] == per_update == stock_launches[counter],
                  f"data-parallel update: {counter} launched {dp_launches[counter]} times, "
                  f"stock {stock_launches[counter]}, not {per_update}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dp = dp_learn(dp.learner_state)
            torch.cuda.synchronize()
        events = prof.events()
        # The dispatcher's op of `dist.all_reduce`, whatever the backend.
        reduce_ops = [e for e in events if e.name == "c10d::allreduce_"]
        nccl_kernels = [e for e in events if "nccl" in e.name.lower()
                        and e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(getattr(e, "device_time", getattr(e, "cuda_time", 0.0))
                        for e in nccl_kernels)
        host_us = sum(e.cpu_time for e in reduce_ops)
        check(len(reduce_ops) == minibatch_steps,
              f"the profiler counts {len(reduce_ops)} all-reduces, not {minibatch_steps}")

        # Both updates timed in one call, stock and data-parallel in turn, each
        # going on from its own state.
        times = {"stock": [], "data-parallel": []}
        learners = {"stock": (stock_learn, stock.learner_state),
                    "data-parallel": (dp_learn, dp.learner_state)}
        for _ in range(DISTRIBUTED_REPEATS):
            for label, (learn, state) in learners.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = learn(state)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
                learners[label] = (learn, out.learner_state)
        for label, seconds in times.items():
            print_updates(f"{label} rec-IPPO", seconds, steps, gpu)
        update_ms = 1e3 * sum(times["data-parallel"]) / len(times["data-parallel"])
        print(f"  all-reduces an update: {len(reduce_ops)} (profiler), "
              f"{device_us / 1e3:.4f} device ms in {len(nccl_kernels)} NCCL kernels, "
              f"{host_us / 1e3:.3f} host ms in c10d::allreduce_, against "
              f"{update_ms:.1f} host ms an update, on {gpu}")

        recording = time.perf_counter()
        stored = store_in_process(mesh, vault)
        stored.update(staggered_sweep())
        print(f"  the recording program and the staggered sweep: "
              f"{time.perf_counter() - recording:.1f} s in this process, on {gpu}")
        print(f"  phase: {time.perf_counter() - start:.1f} s")
        return {"launches": dp_launches, "all_reduces": len(reduce_ops),
                "all_reduce_device_ms": device_us / 1e3, "all_reduce_host_ms": host_us / 1e3,
                **stored}
    finally:
        dist.destroy_process_group()



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
    if "--dynamics" in sys.argv[1:]:
        print("dynamics A/B (the solve's check; tracing q̈ or a whole substep):")
        dynamics_ab(gpu)
        return 0

    start = time.perf_counter()
    marked = threading.Thread(target=gru.build_kernels, kwargs={"step_clocks": True})
    marked.start()
    gru.build_kernels()
    marked.join()
    print(f"build: {time.perf_counter() - start:.1f} s")
    if gru.build_log:
        print(gru.build_log.strip())
    if "--seeds" in sys.argv[1:]:
        print("seed phase (stacked kernels; rec-IPPO vmap seeds, ff-IPPO sweep, rec-IPPO PBT):")
        seed_phase(gru, gpu)
        print(gpu)
        return 0
    if "--offpolicy" in sys.argv[1:]:
        print("off-policy seed phase (rec-IQL, ff-ISAC, ff-MASAC vmap seeds and sweeps; vault):")
        offpolicy_phase(gru, gpu)
        print(gpu)
        return 0
    if "--distributed" in sys.argv[1:]:
        print("distributed phase (rec-IPPO data-parallel, the recording program, a staggered "
              "sweep; NCCL, world 1):")
        distributed_phase(gru, gpu)
        print(gpu)
        return 0
    if "--programs" in sys.argv[1:]:
        print("programs phase (the quickstart; run_seeds, bench_suite, bench_mfu, the sweeps):")
        programs_phase(gru, gpu)
        print(gpu)
        return 0

    print("kernel phase:")
    kernels = kernel_phase(gru)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("slice phase (rec-IPPO):")
    sliced = slice_phase(gru, gpu)
    print("rec-MAPPO phase:")
    mappo = mappo_phase(gru, gpu)
    print("SMAX phase (rec-MAPPO on 3s5z):")
    smax = smax_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("rec-IQL phase (SMAX 3s5z):")
    iql = iql_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("grid phase (rec-MAPPO rcnn on MaConnector; Cleaner, LBF, Gigastep):")
    grid = grid_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("SAC phase (ff-ISAC, ff-MASAC on MaSwarm; ff-ISAC on MaReacher):")
    sac_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("articulated phase (the six articulated envs; ff-ISAC, ff-MASAC, continuous ff-IPPO):")
    articulated_phase(gru, gpu, start)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("resume phase (rec-IPPO SMAX 3s5z full-state resume; ff-ISAC resume; stagger):")
    resume = resume_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("seed phase (stacked kernels; rec-IPPO vmap seeds, ff-IPPO sweep, rec-IPPO PBT):")
    seeds = seed_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("off-policy seed phase (rec-IQL, ff-ISAC, ff-MASAC vmap seeds and sweeps; vault):")
    offpolicy = offpolicy_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("feed-forward phase (ff-IPPO, ff-MAPPO, Matrax, the bench program):")
    feedforward_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    print("programs phase (the quickstart; run_seeds, bench_suite, bench_mfu, the sweeps):")
    programs = programs_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    # Last: it brings up a process group, which the phases above run without.
    print("distributed phase (rec-IPPO data-parallel, the recording program, a staggered "
          "sweep; NCCL, world 1):")
    distributed = distributed_phase(gru, gpu)
    print(f"  ({time.perf_counter() - start:.0f} s since the start)")
    if "--profile" in sys.argv[1:]:
        print("profile phase:")
        profile_phase("rec_ippo", [], 128)
        profile_phase("ff_ippo", ["arch.num_envs=512"], 128)

    t16, t32 = kernels["times"][16], kernels["times"][32]
    library = {"fwd": ("cudnn_fwd", "torch.nn.GRU forward (cuDNN), keep == 1"),
               "bwd_gates": (None, None),
               "bwd_recurrence": ("cudnn_bwd", "torch.nn.GRU backward (cuDNN), keep == 1: "
                                               "the whole of K2p + K2a + K2b"),
               "bwd_reduce": ("mm", "torch.mm on hprev*keep formed beforehand"),
               "bwd_reduce_sum": ("sum", "torch.sum over the slices")}
    slices = gru.reduce_split(*SLICE_SHAPES[0]).slices
    record = {"kernels": []}
    stacked = kernels["stacked"]
    for name, counter, replaces, _ in KERNELS:
        paths = {"launches_smax_rec_mappo": smax["launches"][counter],
                 "launches_rec_iql": iql["launches"][counter],
                 "launches_maconnector_rcnn_rec_mappo": grid["connector"]["launches"][counter],
                 "launches_bench_suite_rec_mappo_smax": programs["launches"][counter],
                 "launches_bench_mfu_rec_iql_smax":
                     programs["mfu"]["rec_iql_smax"]["gru_launches_per_call"].get(counter, 0)}
        if counter == "fwd_stacked":
            record["kernels"].append({
                "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                "launches": iql["launches"][counter], **paths,
                "launches_rec_iql_vmap_seeds": offpolicy["launches"][counter],
                "max_abs_err": kernels["errs"][counter],
                "ms": stacked["fwd_stacked"], "plain_ms": stacked["fwd_stacked_plain"],
                "bound_ms": stacked["bound"], "bound_by": stacked["bound_by"],
                "library_ms": None,
                "library": "none: no one call runs two GRUs of different weights; two cuDNN "
                           "forwards (keep == 1) in two_cudnn_fwd_ms",
                "timed": "device-only: CUDA graph replays; *host_ms: eager calls",
                "host_ms": stacked["fwd_stacked_host"], "plain_host_ms": stacked["fwd_stacked_plain_host"],
                "two_unstacked_ms": stacked["two_fwd"], "two_unstacked_host_ms": stacked["two_fwd_host"],
                "two_cudnn_fwd_ms": stacked["two_cudnn_fwd"],
                "two_cudnn_fwd_host_ms": stacked["two_cudnn_fwd_host"],
                "shape": list(STACKED_SHAPES[0]), "clusters": stacked["clusters"],
                "max_active_clusters": stacked["max_active"], "waves": stacked["waves"],
                "kernel_route": gru.kernel_route(*STACKED_SHAPES[0][1:]).route,
            })
            continue
        if counter in ("fwd", "bwd_gates", "bwd_recurrence", "bwd_reduce"):
            paths["path_shapes"] = {
                f"T={t} B={b} H={h}": {
                    "ms": path[counter], "host_ms": path[counter + "_host"],
                    "plain_ms": path[counter + "_plain"], "plain_host_ms": path[counter + "_plain_host"],
                    "max_abs_err": kernels["path_errs"][(t, b, h)][counter],
                    "bound_ms": path[counter + "_bound"],
                    "library_ms": path.get({"fwd": "cudnn_fwd", "bwd_recurrence": "cudnn_bwd",
                                            "bwd_reduce": "mm"}.get(counter, ""))}
                for (t, b, h), path in kernels["path"].items()}
        bound, bound_by = bound_ms(counter, *SLICE_SHAPES[0], slices)
        lib_key, lib_what = library[counter]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sliced["launches"][counter],
            "launches_rec_mappo": mappo["launches"][counter],
            "launches_resume_rec_ippo_smax": resume["launches"][counter],
            "launches_data_parallel_rec_ippo": distributed["launches"][counter],
            "max_abs_err": kernels["errs"][counter],
            "ms": t16[counter], "plain_ms": t16[counter + "_plain"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": t16[lib_key] if lib_key else None, "library": lib_what,
            "timed": "device-only: CUDA graph replays; *host_ms: eager calls",
            "host_ms": t16[counter + "_host"], "plain_host_ms": t16[counter + "_plain_host"],
            "library_host_ms": t16[lib_key + "_host"] if lib_key else None,
            "shape": list(SLICE_SHAPES[0]), "ms_keep1": t16[counter + "_keep1"],
            "ms_b32": t32[counter], "host_ms_b32": t32[counter + "_host"],
            "bound_ms_b32": bound_ms(counter, *SLICE_SHAPES[1], slices)[0],
            "library_ms_b32": t32[lib_key] if lib_key else None,
            "streaming_ms": t16.get(counter + "_streaming"),
            "kernel_route": gru.kernel_route(*SLICE_SHAPES[0]).route, **paths,
        }
        if counter == "bwd_reduce":
            entry.update({
                "slices": slices, "partials_ms": t16["bwd_reduce_partials"],
                "form_operand_ms": t16["form_hk"], "library_with_operand_ms": t16["mm_with_hk"],
                "form_operand_ms_b32": t32["form_hk"], "library_with_operand_ms_b32": t32["mm_with_hk"],
            })
        record["kernels"].append(entry)
    seed_library = {"bwd_recurrence_stacked": ("cudnn_bwd_x_stack", "S torch.nn.GRU backward "
                                               "calls (cuDNN), keep == 1: the whole of K2p + K2a "
                                               "+ K2b over the stack"),
                    "bwd_reduce_stacked": ("bmm", "torch.bmm on hprev*keep formed beforehand"),
                    "bwd_reduce_sum_stacked": ("sum", "torch.sum over the slices")}
    main_shape = SEED_SHAPES[1]  # S = 4, the losses' B = 64: 16 of an update's 17 K1 launches
    pair, loss = offpolicy["times"]["pair"], offpolicy["times"]["loss"]
    for name, counter, _ in SEED_KERNELS:
        t = seeds["times"][main_shape]
        lib_key, lib_what = seed_library.get(counter, (None, "none: no one library call runs S "
                                                             "GRU passes of different weights"))
        record["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": SEED_REPLACES.format(69 if counter == "fwd_stacked" else 88),
            "launches": seeds["launches"][counter],
            "launches_path": "rec_ippo_vmap_seeds.run_experiment, S = 4, 2 updates, SMAX 3s5z",
            "launches_rec_iql_vmap_seeds": offpolicy["launches"][counter],
            "max_abs_err": max(seeds["errs"][counter], offpolicy["errs"].get(counter, 0.0)),
            "ms": t[counter], "plain_ms": t[counter + "_plain"],
            "bound_ms": t[counter + "_bound"], "bound_by": t[counter + "_bound_by"],
            "library_ms": t[lib_key] if lib_key else None, "library": lib_what,
            "timed": "device-only: CUDA graph replays; *host_ms: eager calls",
            "host_ms": t[counter + "_host"], "unstacked_x_stack_ms":
                t[counter.replace("_stacked", "_unstacked")],
            "shape": list(main_shape),
            "path_shapes": {f"S={st} T={tl} B={b} H={h}": {
                "ms": x[counter], "host_ms": x[counter + "_host"],
                "plain_ms": x[counter + "_plain"],
                "unstacked_x_stack_ms": x[counter.replace("_stacked", "_unstacked")],
                "bound_ms": x[counter + "_bound"],
                "library_ms": x[lib_key] if lib_key else None,
                "waves": {"fwd_stacked": x["fwd_waves"],
                          "bwd_recurrence_stacked": x["bwd_recurrence_waves"]}.get(counter)}
                for (st, tl, b, h), x in seeds["times"].items()},
            "rec_iql_vmap_shapes": {
                f"S={OFF_POLICY_SEEDS} T={OFF_POLICY_SHAPE[0]} B={OFF_POLICY_SHAPE[1]} "
                f"H={OFF_POLICY_SHAPE[2]} (loss pass)": {
                    "ms": loss[counter], "host_ms": loss[counter + "_host"],
                    "plain_ms": loss[counter + "_plain"],
                    "unstacked_x_stack_ms": loss[counter.replace("_stacked", "_unstacked")],
                    "bound_ms": loss[counter + "_bound"],
                    "library_ms": loss[lib_key] if lib_key else None,
                    "waves": {"fwd_stacked": loss["fwd_waves"],
                              "bwd_recurrence_stacked": loss["bwd_recurrence_waves"]}.get(counter)},
                **({f"2S={2 * OFF_POLICY_SEEDS} T={OFF_POLICY_SHAPE[0]} B={OFF_POLICY_SHAPE[1]} "
                    f"H={OFF_POLICY_SHAPE[2]} (target pass, per-pair keep)": {
                        "ms": pair["fwd_stacked_2s"], "host_ms": pair["fwd_stacked_2s_host"],
                        "plain_ms": pair["fwd_stacked_2s_plain"],
                        "unstacked_x_stack_ms": pair["fwd_unstacked_x_2s"],
                        "bound_ms": pair["bound"], "bound_by": pair["bound_by"],
                        "library_ms": None, "cudnn_fwd_x_stack_ms": pair["cudnn_fwd_x_2s"],
                        "clusters": pair["clusters"], "max_active_clusters": pair["max_active"],
                        "waves": pair["waves"]}} if counter == "fwd_stacked" else {}),
            },
        })
    print(f"total: {time.perf_counter() - start:.0f} s")
    print(gpu)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
