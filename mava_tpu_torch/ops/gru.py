"""The GRU recurrence over a whole sequence: CUDA kernels and their plain versions.

Port of `mava_tpu/ops/pallas_gru.py`. `gru_sequence(gates_i, keep, h0, w_h,
b_hn)` returns every step's hidden state, `hs` (T,B,H), of

    h = h_prev * keep;  r,z = sigmoid(x{r,z} + (h@Wh){r,z})
    n = tanh(xn + r * ((h@Wh)n + b_hn));  h' = (1-z)*n + z*h

and differentiates through `GRUSequenceFn`, whose backward recomputes the gates
from `hprev = [h0, hs[:-1]]`. The gradient with respect to `keep` is None (it
encodes the boolean reset mask).

Dispatch is by the device of the tensors and nothing else:
  * CPU tensors go to the plain PyTorch versions in this module,
    `gru_sequence_reference` and `gru_sequence_backward_reference` (and, for the
    backward's three passes one by one, `gru_backward_gates_reference`,
    `gru_backward_recurrence_reference`, `gru_backward_reduce_reference`);
  * CUDA tensors go to the hand-written kernels of `csrc/gru_sequence.cu`, built
    with nvcc for sm_90a on first use into `build/kernels/` and bound with
    ctypes. A CUDA tensor never falls back to a plain version: a build or launch
    failure raises.

Which hand-written kernels a shape takes is `kernel_route(T, B, H)`, a pure
function of the shape:
  * "resident" (H a multiple of 64 up to 256): K1 forward and K2a reverse
    recurrence run on clusters of 8 thread blocks that split the hidden units
    and keep their slice of Wh in registers for the whole sequence; the gate
    recompute of the backward is a parallel pre-pass, K2p;
  * "streaming" (every other H up to 1024): one block per 8 rows reads Wh from
    L2 each step and the backward recomputes the gates inside its loop.
Both end with K2b, the deterministic dWh / db_hn reduction: a first kernel sums
slices of the T*B rows into partial tiles, a second adds the partials in slice
order. How the rows are split is `reduce_split(T, B, H)`, again a pure function
of the shape.

`gru_sequence_stacked(gates_i, keep, h0, w_h, b_hn)` is the recurrence over a
leading stack axis S of inputs and weights, with `keep` shared (T,B,H) or one
per entry (S,T,B,H): what `jax.vmap` of `gru_sequence` and of its VJP over
stacked parameters computes (rec-IQL's fused double-DQN target pass, forward
only; the recurrent learners vmapped over seeds, learning rates or a PBT
population, forward and backward). It differentiates through
`GRUSequenceStackedFn`: the stacked K1, then the stacked K2p, K2a and K2b, each
one launch for the whole stack with the stack entry as one more grid
dimension. Its plain versions are the unstacked ones entry by entry
(`gru_sequence_stacked_reference`, `gru_sequence_stacked_backward_reference`).

`fwd_launches` and `bwd_launches` count calls of the unstacked op that launched
kernels (one per forward call, one per backward call); `kernel_launches` counts
each kernel by name, the stacked ones as `fwd_stacked`, `bwd_gates_stacked`,
`bwd_recurrence_stacked`, `bwd_reduce_stacked` and `bwd_reduce_sum_stacked`,
and `launch_shapes` the same launches by kernel and shape, which is what
`launched_flops` reckons with `kernel_work`. The plain versions leave them alone.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.profiler import record_function

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gru_sequence.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_HIDDEN = 1024
SMEM_LIMIT = 232_448  # bytes of shared memory one block can use on an H100
CLUSTER = 8  # blocks per cluster on the resident route (the portable maximum)
CLUSTER_ROWS = 16  # batch rows per cluster on the resident route
STREAM_ROWS = 8  # batch rows per block on the streaming route
STREAMING = "streaming"
SM_COUNT = 132  # streaming multiprocessors of an H100
REDUCE_TILE = 64  # K2b: edge of the tile of dWh that one block owns
REDUCE_CHUNK = 32  # K2b: rows a block stages per pass
REDUCE_WAVES = 3  # K2b: blocks wanted, in units of SM_COUNT
REDUCE_MIN_CHUNKS = 2  # K2b: passes a slice should at least hold, to have one in flight

# For measurements and tests only: `STREAMING` sends every CUDA call to the
# streaming kernels whatever its shape, so that they can be checked and timed
# at the shapes the resident kernels take. None in normal use.
forced_route: Optional[str] = None

fwd_launches = 0
bwd_launches = 0
KERNELS = ("fwd", "bwd_gates", "bwd_recurrence", "bwd_reduce", "bwd_reduce_sum", "fwd_stacked",
           "bwd_gates_stacked", "bwd_recurrence_stacked", "bwd_reduce_stacked",
           "bwd_reduce_sum_stacked")
kernel_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# (kernel, T, B, H, slices, stack, shared keep) -> launches: `kernel_work`'s arguments.
launch_shapes: Counter = Counter()

# Published peaks of an H100 SXM: fp32 outside the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0
    for name in KERNELS:
        kernel_launches[name] = 0
    launch_shapes.clear()


def kernel_work(kernel: str, t_len: int, b: int, h: int, slices: int = 1, stack: int = 1,
                shared_keep: bool = True):
    """(FLOP, bytes) one call of `kernel` needs: the matrix product's multiply-adds
    counted as 2, every input read once and every output written once, fp32.
    `bwd_reduce` is the whole function (both of K2b's kernels, no scratch) and
    does not depend on `slices`; `bwd_reduce_sum` is the second kernel alone,
    whose input is the `slices` partial sums. A `*_stacked` kernel is the
    unstacked one for each of `stack` entries; `fwd_stacked`'s entries share
    one `keep` unless `shared_keep` is False (the seed programs)."""
    n, w = t_len * b, h * 3 * h
    if kernel == "bwd_reduce_sum":
        return (slices - 1) * (w + h), 4 * (slices + 1) * (w + h)
    if kernel.endswith("_stacked"):
        flop, nbytes = kernel_work(kernel[: -len("_stacked")], t_len, b, h, slices)
        shared = 4 * n * h if kernel == "fwd_stacked" and shared_keep else 0
        return stack * flop, stack * nbytes - (stack - 1) * shared
    product = 2 * n * h * 3 * h
    floats = {
        # gates_i, keep, h0, Wh, b_hn -> hs
        "fwd": n * 3 * h + n * h + b * h + w + h + n * h,
        # gates_i, keep, h0, Wh, b_hn, hs -> gates (4 per unit)
        "bwd_gates": n * 3 * h + n * h + b * h + w + h + n * h + n * 4 * h,
        # gates, keep, h0, Wh, hs, g_hs -> dgates_i, dgh, dh0
        "bwd_recurrence": n * 4 * h + n * h + b * h + w + n * h + n * h + 2 * n * 3 * h + b * h,
        # keep, h0, hs, dgh -> dWh, db_hn
        "bwd_reduce": n * h + b * h + n * h + n * 3 * h + w + h,
    }[kernel]
    flop = product + (2 * n * 3 * h if kernel == "bwd_reduce" else 0)
    return flop, 4 * floats


def launched_flops() -> float:
    """The FLOP of every kernel launched since `reset_launch_counts`: each
    launch at its own kernel's `kernel_work`. K2b's first launch counts as the
    whole reduction and its sum launch adds the slices' sum, so a split
    reduction counts (slices - 1) adds per output more than an unsplit one."""
    return float(sum(n * kernel_work(*key)[0] for key, n in launch_shapes.items()))


class KernelRoute(NamedTuple):
    """Which hand-written kernels a shape takes, and their launch geometry."""

    route: str  # "resident" or "streaming"
    cluster: int  # blocks per cluster; 1 on the streaming route
    fwd_threads: int
    fwd_smem: int  # bytes of shared memory per block, K1
    bwd_threads: int
    bwd_smem: int  # bytes of shared memory per block, K2a
    blocks: int  # blocks of K1 and of K2a


def _check_dims(t_len: int, b: int, h: int) -> None:
    if t_len < 1 or b < 1 or not 1 <= h <= MAX_HIDDEN:
        raise ValueError(
            f"gru_sequence: need T >= 1, B >= 1 and 1 <= H <= {MAX_HIDDEN}, "
            f"got T={t_len}, B={b}, H={h}"
        )


def kernel_route(t_len: int, b: int, h: int) -> KernelRoute:
    """The route of a (T, B, H) problem, from the shape alone.

    The resident route splits H over 8 blocks, 16 lanes share a unit's product
    and read the carry as float4, so it takes H % 64 == 0; up to H = 256 a
    thread's slice of Wh (3H/16 floats forward, 3H/8 backward) fits its
    registers. T and B do not matter: a cluster takes 16 rows, ragged or not.
    """
    _check_dims(t_len, b, h)
    if h % 64 == 0 and h <= 256:
        units = h // CLUSTER
        return KernelRoute(
            route="resident",
            cluster=CLUSTER,
            fwd_threads=CLUSTER_ROWS * units,
            fwd_smem=4 * (2 * CLUSTER * (CLUSTER_ROWS * units + 16)
                          + 2 * CLUSTER_ROWS * (4 * units + 4)
                          + 2 * CLUSTER_ROWS * (units + 4)) + 16,
            bwd_threads=h * (2 if h <= 128 else 1),
            bwd_smem=4 * (3 * units * CLUSTER_ROWS + CLUSTER_ROWS * (4 * units + 4)
                          + 4 * CLUSTER * units * CLUSTER_ROWS
                          + 2 * CLUSTER_ROWS * (7 * units + 4)) + 16,
            blocks=CLUSTER * -(-b // CLUSTER_ROWS),
        )
    threads = min(-(-3 * h // 32) * 32, 512)
    return KernelRoute(
        route=STREAMING,
        cluster=1,
        fwd_threads=threads,
        fwd_smem=4 * STREAM_ROWS * 4 * h,
        bwd_threads=threads,
        bwd_smem=4 * STREAM_ROWS * 5 * h,
        blocks=-(-b // STREAM_ROWS),
    )


class ReduceSplit(NamedTuple):
    """How K2b splits the T*B rows over blocks."""

    slices: int  # S: partial sums per element of dWh and db_hn
    rows_per_slice: int  # slice s holds rows [s * rows_per_slice, (s + 1) * rows_per_slice)
    tiles: int  # tiles of dWh; the first kernel's grid is tiles x slices


def reduce_split(t_len: int, b: int, h: int, slices: Optional[int] = None) -> ReduceSplit:
    """The row split of K2b for a (T, B, H) problem, from the shape alone.

    One block takes a 64 x 64 tile of dWh for one slice of the rows, in passes
    of 32 rows. The slices are as many as it takes for tiles x slices to reach
    three waves of the card's 132 SMs (an SM holds three blocks at once; on an
    H100 at T = 128, H = 128 the time is flat within 3 % from two waves to four,
    and 5-15 % longer at one wave or at six), as long as a slice keeps two
    passes, so that one can be in flight while the other multiplies. Each slice costs one partial copy of dWh
    in scratch (S * (H*3H + H) floats, written and read once): at S = 32 and
    H = 128 that is 6.3 MB and stays in the 50 MB L2.
    `slices` overrides the count (tests and timing); slices past the last row
    are empty and contribute zeros.
    """
    _check_dims(t_len, b, h)
    tiles = -(-h // REDUCE_TILE) * -(-3 * h // REDUCE_TILE)
    chunks = -(-t_len * b // REDUCE_CHUNK)
    if slices is None:
        want = -(-REDUCE_WAVES * SM_COUNT // tiles)
        per_slice = max(REDUCE_MIN_CHUNKS, -(-chunks // want))
        slices = -(-chunks // per_slice)
    elif slices < 1:
        raise ValueError(f"reduce_split: need slices >= 1, got {slices}")
    else:
        per_slice = -(-chunks // slices)
    return ReduceSplit(slices=slices, rows_per_slice=per_slice * REDUCE_CHUNK, tiles=tiles)


def reduce_slice_rows(split: ReduceSplit, n: int, s: int) -> Tuple[int, int]:
    """[start, stop) of the rows of slice `s` out of `n`, as the kernel takes them."""
    return min(n, s * split.rows_per_slice), min(n, (s + 1) * split.rows_per_slice)


# The loaded libraries: the kernels as the port runs them (False) and the same
# kernels with per-phase clock marks compiled in (True, `measure_step_clocks`).
_libs: Dict[bool, ctypes.CDLL] = {}
# What nvcc printed (ptxas register and shared-memory use) for the library this
# process built; empty when it was loaded from the build directory.
build_log = ""
PHASES = {
    "fwd": ("fetch+product", "butterfly", "gates", "stage", "fence+barrier+copies+store", "wait"),
    "bwd_recurrence": ("fetch", "gate cotangents", "block barrier", "stores+product",
                       "stage+fence+barrier+copies", "wait", "sum of partials"),
}


# --------------------------------------------------------------------------- plain versions
def gru_sequence_reference(
    gates_i: torch.Tensor,
    keep: torch.Tensor,
    h0: torch.Tensor,
    w_h: torch.Tensor,
    b_hn: torch.Tensor,
) -> torch.Tensor:
    """Plain forward: the recurrence as a loop over T (reference `_fwd_kernel`)."""
    h = h0
    hs = []
    for t in range(gates_i.shape[0]):
        h = h * keep[t]
        xr, xz, xn = gates_i[t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + b_hn))
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs)


def _entry_keep(keep: torch.Tensor, stacked_dim: int, s: int) -> torch.Tensor:
    """Entry s's keep: its own where `keep` has the stack axis, else the shared one."""
    return keep[s] if keep.dim() == stacked_dim else keep


def gru_sequence_stacked_reference(gates_i, keep, h0, w_h, b_hn) -> torch.Tensor:
    """Plain stacked forward: `gru_sequence_reference` for each stack entry, keep
    shared (T,B,H) or per entry (S,T,B,H). Returns hs (S,T,B,H)."""
    return torch.stack([
        gru_sequence_reference(gates_i[s], _entry_keep(keep, 4, s), h0[s], w_h[s], b_hn[s])
        for s in range(gates_i.shape[0])
    ])


def gru_sequence_stacked_backward_reference(gates_i, keep, h0, w_h, b_hn, hs, g_hs):
    """Plain stacked backward: `gru_sequence_backward_reference` for each stack
    entry. Returns (dgates_i, dh0, dWh, db_hn), each with the stack axis."""
    outs = [
        gru_sequence_backward_reference(gates_i[s], _entry_keep(keep, 4, s), h0[s], w_h[s],
                                        b_hn[s], hs[s], g_hs[s])
        for s in range(gates_i.shape[0])
    ]
    return tuple(torch.stack(x) for x in zip(*outs))


def gru_sequence_backward_reference(
    gates_i: torch.Tensor,
    keep: torch.Tensor,
    h0: torch.Tensor,
    w_h: torch.Tensor,
    b_hn: torch.Tensor,
    hs: torch.Tensor,
    g_hs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: the reverse recurrence with recompute (reference
    `_bwd_kernel`). Returns (dgates_i, dh0, dWh, db_hn)."""
    t_len = gates_i.shape[0]
    hprev = torch.cat([h0[None], hs[:-1]], dim=0)
    dh = torch.zeros_like(h0)
    dgates = torch.empty_like(gates_i)
    dwh = torch.zeros_like(w_h)
    dbhn = torch.zeros_like(b_hn)
    for t in reversed(range(t_len)):
        h = hprev[t] * keep[t]
        xr, xz, xn = gates_i[t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        hnb = hn + b_hn
        n = torch.tanh(xn + r * hnb)

        d = g_hs[t] + dh
        dn = d * (1.0 - z)
        dz = d * (h - n)
        dan = dn * (1.0 - n * n)
        dar = (dan * hnb) * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dgh = torch.cat([dar, daz, dan * r], dim=-1)
        dgates[t] = torch.cat([dar, daz, dan], dim=-1)
        dbhn += (dan * r).sum(0)
        dwh += h.T @ dgh
        dh = (d * z + dgh @ w_h.T) * keep[t]
    return dgates, dh, dwh, dbhn


def _hprev(h0: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    return torch.cat([h0[None], hs[:-1]], dim=0)


def gru_backward_gates_reference(gates_i, keep, h0, w_h, b_hn, hs) -> torch.Tensor:
    """Plain K2p: the gates of every step, recomputed from hprev = [h0, hs[:-1]].
    Returns (T,B,4H), for each unit its (r, z, n, hnb) side by side, with
    hnb = ((hprev*keep) @ Wh)n + b_hn."""
    xr, xz, xn = gates_i.chunk(3, dim=-1)
    hr, hz, hn = ((_hprev(h0, hs) * keep) @ w_h).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    hnb = hn + b_hn
    return torch.stack([r, z, torch.tanh(xn + r * hnb), hnb], dim=-1).flatten(-2)


def gru_backward_recurrence_reference(gates, keep, h0, w_h, hs, g_hs):
    """Plain K2a on recomputed gates: the reverse loop alone. Returns
    (dgates_i, dgh, dh0) with dgh = [dar, daz, dan*r] (T,B,3H)."""
    r, z, n, hnb = gates.unflatten(-1, (-1, 4)).unbind(-1)
    hk = _hprev(h0, hs) * keep
    dh = torch.zeros_like(h0)
    dgates = torch.empty_like(gates[..., : 3 * h0.shape[-1]])
    dgh = torch.empty_like(dgates)
    for t in reversed(range(gates.shape[0])):
        d = g_hs[t] + dh
        dn = d * (1.0 - z[t])
        dz = d * (hk[t] - n[t])
        dan = dn * (1.0 - n[t] * n[t])
        dar = (dan * hnb[t]) * r[t] * (1.0 - r[t])
        daz = dz * z[t] * (1.0 - z[t])
        dgates[t] = torch.cat([dar, daz, dan], dim=-1)
        dgh[t] = torch.cat([dar, daz, dan * r[t]], dim=-1)
        dh = (d * z[t] + dgh[t] @ w_h.T) * keep[t]
    return dgates, dgh, dh


def gru_backward_reduce_reference(keep, h0, hs, dgh):
    """Plain K2b: dWh = sum_{t,b} (hprev*keep)^T dgh and db_hn = sum dgh_n."""
    h = h0.shape[-1]
    hk = (_hprev(h0, hs) * keep).reshape(-1, h)
    flat = dgh.reshape(-1, 3 * h)
    return hk.T @ flat, flat[:, 2 * h :].sum(0)


def gru_backward_reduce_partials_reference(keep, h0, hs, dgh, split: ReduceSplit) -> torch.Tensor:
    """Plain first kernel of K2b: (S, H*3H + H), slice s being [dWh, db_hn] summed
    over that slice's rows alone."""
    h = h0.shape[-1]
    hk = (_hprev(h0, hs) * keep).reshape(-1, h)
    flat = dgh.reshape(-1, 3 * h)
    parts = []
    for s in range(split.slices):
        lo, hi = reduce_slice_rows(split, hk.shape[0], s)
        parts.append(torch.cat([(hk[lo:hi].T @ flat[lo:hi]).reshape(-1), flat[lo:hi, 2 * h :].sum(0)]))
    return torch.stack(parts)


def gru_backward_reduce_sum_reference(partials: torch.Tensor, h: int):
    """Plain second kernel of K2b: the partials added in slice order."""
    total = partials[0].clone()
    for s in range(1, partials.shape[0]):
        total += partials[s]
    return total[: h * 3 * h].reshape(h, 3 * h), total[h * 3 * h :]


def _stack_outputs(fn, count: int):
    """fn(s) for each stack entry s, each of its outputs stacked on a new axis 0."""
    outs = [fn(s) for s in range(count)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(x) for x in zip(*outs))


def gru_backward_gates_stacked_reference(gates_i, keep, h0, w_h, b_hn, hs) -> torch.Tensor:
    """Plain stacked K2p: (S,T,B,4H)."""
    return _stack_outputs(lambda s: gru_backward_gates_reference(
        gates_i[s], _entry_keep(keep, 4, s), h0[s], w_h[s], b_hn[s], hs[s]), gates_i.shape[0])


def gru_backward_recurrence_stacked_reference(gates, keep, h0, w_h, hs, g_hs):
    """Plain stacked K2a: (dgates_i, dgh, dh0), each with the stack axis."""
    return _stack_outputs(lambda s: gru_backward_recurrence_reference(
        gates[s], _entry_keep(keep, 4, s), h0[s], w_h[s], hs[s], g_hs[s]), gates.shape[0])


def gru_backward_reduce_stacked_reference(keep, h0, hs, dgh):
    """Plain stacked K2b: (dWh (S,H,3H), db_hn (S,H))."""
    return _stack_outputs(lambda s: gru_backward_reduce_reference(
        _entry_keep(keep, 4, s), h0[s], hs[s], dgh[s]), hs.shape[0])


def gru_backward_reduce_partials_stacked_reference(keep, h0, hs, dgh, split: ReduceSplit):
    """Plain stacked first kernel of K2b: (S, slices, H*3H + H)."""
    return _stack_outputs(lambda s: gru_backward_reduce_partials_reference(
        _entry_keep(keep, 4, s), h0[s], hs[s], dgh[s], split), hs.shape[0])


def gru_backward_reduce_sum_stacked_reference(partials: torch.Tensor, h: int):
    """Plain stacked second kernel of K2b: each entry's partials in slice order."""
    return _stack_outputs(lambda s: gru_backward_reduce_sum_reference(partials[s], h),
                          partials.shape[0])


# --------------------------------------------------------------------------- build and bind
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the GRU kernels need the CUDA toolkit to build.")


def build_kernels(step_clocks: bool = False) -> ctypes.CDLL:
    """Build `csrc/gru_sequence.cu` (once per source hash and flag set) and load
    it. `step_clocks` builds the variant with -DGRU_STEP_CLOCKS."""
    global build_log
    if step_clocks in _libs:
        return _libs[step_clocks]
    flags = NVCC_FLAGS + (("-DGRU_STEP_CLOCKS",) if step_clocks else ())
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"libgru_sequence_{key.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One build for all the ranks of a data-parallel run: the first to take
    # the lock builds, the others find the library when they get it.
    with open(out.with_name(f"{out.name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(_SOURCE)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{proc.stderr}")
            os.replace(tmp, out)
            if not step_clocks:
                build_log = proc.stderr + proc.stdout
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, pointers, ints in (
        ("gru_sequence_fwd", 6, 6),
        ("gru_sequence_bwd_gates", 7, 5),
        ("gru_sequence_bwd_recurrence", 12, 6),
        ("gru_sequence_bwd_reduce", 5, 7),
        ("gru_sequence_bwd_reduce_sum", 3, 3),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * pointers + [i32] * ints + [ptr]
        fn.restype = i32
    lib.gru_sequence_resident_config.argtypes = [i32, ctypes.POINTER(i32)]
    lib.gru_sequence_resident_config.restype = i32
    lib.gru_sequence_max_active_clusters.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.gru_sequence_max_active_clusters.restype = i32
    lib.gru_sequence_reduce_config.argtypes = [ctypes.POINTER(i32)]
    lib.gru_sequence_reduce_config.restype = i32
    if step_clocks:
        lib.gru_sequence_step_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.gru_sequence_step_clocks.restype = i32
        lib.gru_sequence_bwd_reduce_probe.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.gru_sequence_bwd_reduce_probe.restype = i32
    _libs[step_clocks] = lib
    return lib


def _check(name: str, x: torch.Tensor, shape: Tuple[int, ...], device: torch.device):
    if x.device != device:
        raise ValueError(f"gru_sequence: {name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"gru_sequence: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"gru_sequence: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"gru_sequence: {name} must be contiguous")
    if x.is_cuda and x.data_ptr() % 16 != 0:  # the kernels move float4s
        raise ValueError(f"gru_sequence: {name} must be 16-byte aligned")


def _check_inputs(gates_i, keep, h0, w_h, b_hn, stacked: bool = False) -> Tuple[int, ...]:
    """(T, B, H), or (S, T, B, H) where `stacked`: gates_i, h0, w_h and b_hn then
    lead with the stack axis S, and keep is shared (T, B, H) or per entry
    (S, T, B, H)."""
    lead = 1 if stacked else 0
    if gates_i.dim() != 3 + lead or gates_i.shape[-1] % 3 != 0:
        want = "(S, T, B, 3H)" if stacked else "(T, B, 3H)"
        raise ValueError(f"gru_sequence: gates_i must be {want}, got {tuple(gates_i.shape)}")
    stack = tuple(gates_i.shape[:lead])
    t_len, b, h3 = gates_i.shape[lead:]
    h = h3 // 3
    _check_dims(t_len, b, h)
    if stacked and not 1 <= stack[0] <= 65535:
        raise ValueError(f"gru_sequence: need 1 <= S <= 65535, got S={stack[0]}")
    dev = gates_i.device
    _check("gates_i", gates_i, (*stack, t_len, b, h3), dev)
    _check("keep", keep, (*stack[: keep.dim() - 3], t_len, b, h), dev)
    _check("h0", h0, (*stack, b, h), dev)
    _check("w_h", w_h, (*stack, h, h3), dev)
    _check("b_hn", b_hn, (*stack, h), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_sequence: unsupported device {dev}")
    return (*stack, t_len, b, h)


def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def built_route(h: int) -> Optional[Tuple[int, int, int, int, int]]:
    """What the built library says of the resident kernels for H: (cluster, K1
    threads, K1 shared bytes, K2a threads, K2a shared bytes), or None where it
    has none. `kernel_route` must agree with it."""
    out = (ctypes.c_int * 5)()
    if build_kernels().gru_sequence_resident_config(h, out) != 0:
        return None
    return tuple(out)


def max_active_clusters(h: int, kernel: str, b: int, stack: int = 1) -> int:
    """How many clusters of the resident K1 (`kernel` "fwd") or K2a
    ("bwd_recurrence") for H the card holds at once (`cudaOccupancyMaxActiveClusters`)
    for a launch over B rows and `stack` stack entries. A launch of more
    clusters than that runs in waves."""
    out = ctypes.c_int(0)
    which = {"fwd": 0, "bwd_recurrence": 1}[kernel]
    _raise_on(build_kernels().gru_sequence_max_active_clusters(h, which, b, stack, ctypes.byref(out)),
              "gru_sequence_max_active_clusters")
    return out.value


def built_reduce_config() -> Tuple[int, int]:
    """(tile edge, rows per pass) of K2b in the built library. `REDUCE_TILE` and
    `REDUCE_CHUNK`, on which `reduce_split` rests, must agree with it."""
    out = (ctypes.c_int * 2)()
    build_kernels().gru_sequence_reduce_config(out)
    return tuple(out)


def _resident(t_len: int, b: int, h: int) -> bool:
    """Whether this call takes the resident kernels."""
    if forced_route not in (None, STREAMING):
        raise ValueError(f"gru_sequence: no route {forced_route!r} to force")
    return forced_route is None and kernel_route(t_len, b, h).route == "resident"


def _launch(name: str, work: Tuple, fn, device: torch.device, *args) -> None:
    """Launch `fn` and count it; `work` is (T, B, H, slices, stack, shared keep)."""
    with torch.cuda.device(device):
        err = fn(*[_ptr(a) if isinstance(a, torch.Tensor) else a for a in args], _stream(device))
    _raise_on(err, fn.__name__)
    kernel_launches[name] += 1
    launch_shapes[(name, *work)] += 1


def _empty(device: torch.device, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def gru_sequence_forward(gates_i, keep, h0, w_h, b_hn, step_clocks: bool = False):
    """hs (T,B,H). K1 on CUDA tensors, the plain loop on CPU tensors.
    `step_clocks` runs the build with clock marks (see `measure_step_clocks`)."""
    global fwd_launches
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    if gates_i.device.type == "cpu":
        return gru_sequence_reference(gates_i, keep, h0, w_h, b_hn)
    lib = build_kernels(step_clocks)
    dev = gates_i.device
    cluster = CLUSTER if _resident(t_len, b, h) else 0
    hs = _empty(dev, t_len, b, h)
    _launch("fwd", (t_len, b, h, 1, 1, True), lib.gru_sequence_fwd, dev,
            gates_i, keep, h0, w_h, b_hn, hs, t_len, b, h, 1, 0, cluster)
    fwd_launches += 1
    return hs


def gru_sequence_stacked_forward(gates_i, keep, h0, w_h, b_hn) -> torch.Tensor:
    """hs (S,T,B,H): one launch of K1 over every stack entry on CUDA tensors, the
    plain loop over S on CPU tensors. `keep` is (T,B,H) shared or (S,T,B,H)."""
    stack, t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn, stacked=True)
    if gates_i.device.type == "cpu":
        return gru_sequence_stacked_reference(gates_i, keep, h0, w_h, b_hn)
    lib = build_kernels()
    dev = gates_i.device
    cluster = CLUSTER if _resident(t_len, b, h) else 0
    hs = _empty(dev, stack, t_len, b, h)
    # The same kernel function as K1: the span tells its launches apart in a profile.
    with record_function("gru/fwd_stacked"):
        _launch("fwd_stacked", (t_len, b, h, 1, stack, keep.dim() == 3),
                lib.gru_sequence_fwd, dev, gates_i, keep, h0, w_h, b_hn, hs, t_len,
                b, h, stack, int(keep.dim() == 4), cluster)
    return hs


def gru_backward_gates(gates_i, keep, h0, w_h, b_hn, hs) -> torch.Tensor:
    """K2p: (T,B,4H), each unit's (r, z, n, hnb) recomputed for every step at once."""
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    _check("hs", hs, (t_len, b, h), gates_i.device)
    if gates_i.device.type == "cpu":
        return gru_backward_gates_reference(gates_i, keep, h0, w_h, b_hn, hs)
    lib = build_kernels()
    gates = _empty(gates_i.device, t_len, b, 4 * h)
    _launch("bwd_gates", (t_len, b, h, 1, 1, True), lib.gru_sequence_bwd_gates, gates_i.device,
            gates_i, keep, h0, w_h, b_hn, hs, gates, t_len, b, h, 1, 0)
    return gates


def gru_backward_recurrence(gates_i, keep, h0, w_h, b_hn, hs, g_hs, gates=None,
                            step_clocks: bool = False):
    """K2a: (dgates_i, dgh, dh0). On the resident route it reads `gates` (K2p's
    output); on the streaming route it recomputes them in its loop from a
    transposed copy of Wh made here."""
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    dev = gates_i.device
    _check("hs", hs, (t_len, b, h), dev)
    _check("g_hs", g_hs, (t_len, b, h), dev)
    resident = _resident(t_len, b, h)
    if dev.type == "cpu" or resident:
        if gates is None:
            raise ValueError("gru_backward_recurrence: this route needs the recomputed gates")
        _check("gates", gates, (t_len, b, 4 * h), dev)
    if dev.type == "cpu":
        return gru_backward_recurrence_reference(gates, keep, h0, w_h, hs, g_hs)
    lib = build_kernels(step_clocks)
    w_h_t = None
    if not resident:
        w_h_t = _empty(dev, 3 * h, h)
        w_h_t.copy_(w_h.T)
    dgates, dgh, dh0 = _empty(dev, t_len, b, 3 * h), _empty(dev, t_len, b, 3 * h), _empty(dev, b, h)
    _launch("bwd_recurrence", (t_len, b, h, 1, 1, True), lib.gru_sequence_bwd_recurrence, dev,
            gates_i, keep, h0, w_h, w_h_t, b_hn, hs, g_hs, gates if resident else None,
            dgates, dgh, dh0, t_len, b, h, 1, 0, CLUSTER if resident else 0)
    return dgates, dgh, dh0


def _check_reduce_inputs(keep, h0, hs, dgh) -> Tuple[int, int, int]:
    t_len, b, h = hs.shape
    for name, x, shape in (("keep", keep, (t_len, b, h)), ("h0", h0, (b, h)),
                           ("hs", hs, (t_len, b, h)), ("dgh", dgh, (t_len, b, 3 * h))):
        _check(name, x, shape, hs.device)
    return t_len, b, h


def gru_backward_reduce_partials(keep, h0, hs, dgh, slices: Optional[int] = None) -> torch.Tensor:
    """K2b, first kernel: (S, H*3H + H), the sums of [dWh, db_hn] over each slice
    of the rows. S is `reduce_split`'s unless `slices` says otherwise."""
    t_len, b, h = _check_reduce_inputs(keep, h0, hs, dgh)
    dev = hs.device
    split = reduce_split(t_len, b, h, slices)
    if dev.type == "cpu":
        return gru_backward_reduce_partials_reference(keep, h0, hs, dgh, split)
    lib = build_kernels()
    partials = _empty(dev, split.slices, h * 3 * h + h)
    _launch("bwd_reduce", (t_len, b, h, split.slices, 1, True), lib.gru_sequence_bwd_reduce, dev,
            keep, h0, hs, dgh, partials, t_len, b, h, split.slices, split.rows_per_slice, 1, 0)
    return partials


def gru_backward_reduce_probe(probe: int, keep, h0, hs, dgh) -> None:
    """For timing only: K2b's first kernel at its own grid and row split with (1)
    the product's FMAs replaced by adds at the same shared-memory reads, or (2)
    only a slice's first chunk loaded. The result is of no use and is dropped;
    the launch is not counted. CUDA tensors only; the build with clock marks."""
    t_len, b, h = _check_reduce_inputs(keep, h0, hs, dgh)
    if hs.device.type != "cuda":
        raise ValueError("gru_backward_reduce_probe: needs CUDA tensors")
    split = reduce_split(t_len, b, h)
    partials = _empty(hs.device, split.slices, h * 3 * h + h)
    with torch.cuda.device(hs.device):
        err = build_kernels(True).gru_sequence_bwd_reduce_probe(
            *[_ptr(x) for x in (keep, h0, hs, dgh, partials)], t_len, b, h, split.slices,
            split.rows_per_slice, probe, _stream(hs.device))
    _raise_on(err, "gru_sequence_bwd_reduce_probe")


def gru_backward_reduce_sum(partials: torch.Tensor, h: int):
    """K2b, second kernel: (dWh, db_hn) as the sum of the partials in slice order."""
    _check("partials", partials, (partials.shape[0], h * 3 * h + h), partials.device)
    if partials.device.type == "cpu":
        return gru_backward_reduce_sum_reference(partials, h)
    lib = build_kernels()
    dev = partials.device
    dwh, dbhn = _empty(dev, h, 3 * h), _empty(dev, h)
    _launch("bwd_reduce_sum", (0, 0, h, partials.shape[0], 1, True),
            lib.gru_sequence_bwd_reduce_sum, dev, partials, dwh, dbhn,
            h, partials.shape[0], 1)
    return dwh, dbhn


def gru_backward_reduce(keep, h0, hs, dgh, slices: Optional[int] = None):
    """K2b: (dWh, db_hn), bitwise the same from run to run. On CUDA tensors the two
    kernels in turn; on CPU tensors the plain product."""
    if hs.device.type == "cpu":
        _check_reduce_inputs(keep, h0, hs, dgh)
        return gru_backward_reduce_reference(keep, h0, hs, dgh)
    return gru_backward_reduce_sum(gru_backward_reduce_partials(keep, h0, hs, dgh, slices),
                                   hs.shape[-1])


def gru_sequence_backward(gates_i, keep, h0, w_h, b_hn, hs, g_hs):
    """(dgates_i, dh0, dWh, db_hn). On CUDA tensors K2p (resident route only),
    K2a and K2b in turn; on CPU tensors the plain loop."""
    global bwd_launches
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    _check("hs", hs, (t_len, b, h), gates_i.device)
    _check("g_hs", g_hs, (t_len, b, h), gates_i.device)
    if gates_i.device.type == "cpu":
        return gru_sequence_backward_reference(gates_i, keep, h0, w_h, b_hn, hs, g_hs)
    gates = None
    if _resident(t_len, b, h):
        gates = gru_backward_gates(gates_i, keep, h0, w_h, b_hn, hs)
    dgates, dgh, dh0 = gru_backward_recurrence(gates_i, keep, h0, w_h, b_hn, hs, g_hs, gates)
    dwh, dbhn = gru_backward_reduce(keep, h0, hs, dgh)
    bwd_launches += 1
    return dgates, dh0, dwh, dbhn


def _check_stacked_extra(stack: int, t_len: int, b: int, h: int, device, **tensors) -> None:
    widths = {"hs": h, "g_hs": h, "gates": 4 * h, "dgh": 3 * h}
    for name, x in tensors.items():
        _check(name, x, (stack, t_len, b, widths[name]), device)


def gru_backward_gates_stacked(gates_i, keep, h0, w_h, b_hn, hs) -> torch.Tensor:
    """Stacked K2p: (S,T,B,4H), one launch with the stack entry as grid z."""
    stack, t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn, stacked=True)
    _check_stacked_extra(stack, t_len, b, h, gates_i.device, hs=hs)
    if gates_i.device.type == "cpu":
        return gru_backward_gates_stacked_reference(gates_i, keep, h0, w_h, b_hn, hs)
    gates = _empty(gates_i.device, stack, t_len, b, 4 * h)
    _launch("bwd_gates_stacked", (t_len, b, h, 1, stack, True),
            build_kernels().gru_sequence_bwd_gates, gates_i.device,
            gates_i, keep, h0, w_h, b_hn, hs, gates, t_len, b, h, stack, int(keep.dim() == 4))
    return gates


def gru_backward_recurrence_stacked(gates_i, keep, h0, w_h, b_hn, hs, g_hs, gates=None):
    """Stacked K2a: (dgates_i, dgh, dh0), each with the stack axis, one launch with
    the stack entry as grid y. As `gru_backward_recurrence`, the resident route
    reads `gates` and the streaming route recomputes them from transposed copies
    of each entry's Wh made here."""
    stack, t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn, stacked=True)
    dev = gates_i.device
    _check_stacked_extra(stack, t_len, b, h, dev, hs=hs, g_hs=g_hs)
    resident = _resident(t_len, b, h)
    if dev.type == "cpu" or resident:
        if gates is None:
            raise ValueError("gru_backward_recurrence_stacked: this route needs the recomputed gates")
        _check_stacked_extra(stack, t_len, b, h, dev, gates=gates)
    if dev.type == "cpu":
        return gru_backward_recurrence_stacked_reference(gates, keep, h0, w_h, hs, g_hs)
    w_h_t = None
    if not resident:
        w_h_t = _empty(dev, stack, 3 * h, h)
        w_h_t.copy_(w_h.transpose(1, 2))
    dgates, dgh = _empty(dev, stack, t_len, b, 3 * h), _empty(dev, stack, t_len, b, 3 * h)
    dh0 = _empty(dev, stack, b, h)
    _launch("bwd_recurrence_stacked", (t_len, b, h, 1, stack, True),
            build_kernels().gru_sequence_bwd_recurrence, dev,
            gates_i, keep, h0, w_h, w_h_t, b_hn, hs, g_hs, gates if resident else None,
            dgates, dgh, dh0, t_len, b, h, stack, int(keep.dim() == 4),
            CLUSTER if resident else 0)
    return dgates, dgh, dh0


def _check_reduce_stacked(keep, h0, hs, dgh) -> Tuple[int, int, int, int]:
    stack, t_len, b, h = hs.shape
    _check("keep", keep, (*(stack,)[: keep.dim() - 3], t_len, b, h), hs.device)
    _check("h0", h0, (stack, b, h), hs.device)
    _check_stacked_extra(stack, t_len, b, h, hs.device, hs=hs, dgh=dgh)
    return stack, t_len, b, h


def gru_backward_reduce_partials_stacked(keep, h0, hs, dgh, slices: Optional[int] = None):
    """Stacked K2b, first kernel: (S, slices, H*3H + H), every entry's slices in one
    launch (grid z = entry * slices + slice)."""
    stack, t_len, b, h = _check_reduce_stacked(keep, h0, hs, dgh)
    split = reduce_split(t_len, b, h, slices)
    if hs.device.type == "cpu":
        return gru_backward_reduce_partials_stacked_reference(keep, h0, hs, dgh, split)
    if split.slices * stack > 65535:
        raise ValueError(f"gru_backward_reduce_partials_stacked: {stack} entries x "
                         f"{split.slices} slices exceed the grid")
    partials = _empty(hs.device, stack, split.slices, h * 3 * h + h)
    _launch("bwd_reduce_stacked", (t_len, b, h, split.slices, stack, True),
            build_kernels().gru_sequence_bwd_reduce, hs.device,
            keep, h0, hs, dgh, partials, t_len, b, h, split.slices, split.rows_per_slice,
            stack, int(keep.dim() == 4))
    return partials


def gru_backward_reduce_sum_stacked(partials: torch.Tensor, h: int):
    """Stacked K2b, second kernel: (dWh (S,H,3H), db_hn (S,H)), each entry's
    partials added in slice order, one launch with the entry as grid y."""
    stack, slices = partials.shape[:2]
    _check("partials", partials, (stack, slices, h * 3 * h + h), partials.device)
    if partials.device.type == "cpu":
        return gru_backward_reduce_sum_stacked_reference(partials, h)
    dev = partials.device
    dwh, dbhn = _empty(dev, stack, h, 3 * h), _empty(dev, stack, h)
    _launch("bwd_reduce_sum_stacked", (0, 0, h, slices, stack, True),
            build_kernels().gru_sequence_bwd_reduce_sum, dev,
            partials, dwh, dbhn, h, slices, stack)
    return dwh, dbhn


def gru_backward_reduce_stacked(keep, h0, hs, dgh, slices: Optional[int] = None):
    """Stacked K2b: (dWh, db_hn) of every entry, bitwise the same from run to run.
    On CUDA tensors the two kernels in turn; on CPU tensors the plain product."""
    if hs.device.type == "cpu":
        _check_reduce_stacked(keep, h0, hs, dgh)
        return gru_backward_reduce_stacked_reference(keep, h0, hs, dgh)
    return gru_backward_reduce_sum_stacked(
        gru_backward_reduce_partials_stacked(keep, h0, hs, dgh, slices), hs.shape[-1])


def gru_sequence_stacked_backward(gates_i, keep, h0, w_h, b_hn, hs, g_hs):
    """(dgates_i, dh0, dWh, db_hn) of every stack entry. On CUDA tensors the
    stacked K2p (resident route only), K2a and K2b, one launch each for the
    whole stack; on CPU tensors the plain loop entry by entry."""
    stack, t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn, stacked=True)
    _check_stacked_extra(stack, t_len, b, h, gates_i.device, hs=hs, g_hs=g_hs)
    if gates_i.device.type == "cpu":
        return gru_sequence_stacked_backward_reference(gates_i, keep, h0, w_h, b_hn, hs, g_hs)
    gates = None
    if _resident(t_len, b, h):
        gates = gru_backward_gates_stacked(gates_i, keep, h0, w_h, b_hn, hs)
    dgates, dgh, dh0 = gru_backward_recurrence_stacked(
        gates_i, keep, h0, w_h, b_hn, hs, g_hs, gates)
    dwh, dbhn = gru_backward_reduce_stacked(keep, h0, hs, dgh)
    return dgates, dh0, dwh, dbhn


def measure_step_clocks(gates_i, keep, h0, w_h, b_hn, g_hs) -> Dict[str, Dict[str, float]]:
    """SM clock cycles per step and phase (`PHASES`) of the resident K1 and K2a,
    from one launch of each in the build with clock marks, as thread 0 of block 0
    saw them. CUDA tensors of a shape on the resident route only."""
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    if gates_i.device.type != "cuda" or kernel_route(t_len, b, h).route != "resident":
        raise ValueError("measure_step_clocks: needs CUDA tensors of a shape on the resident route")
    hs = gru_sequence_forward(gates_i, keep, h0, w_h, b_hn, step_clocks=True)
    gates = gru_backward_gates(gates_i, keep, h0, w_h, b_hn, hs)
    gru_backward_recurrence(gates_i, keep, h0, w_h, b_hn, hs, g_hs, gates, step_clocks=True)
    out = (ctypes.c_longlong * 16)()
    _raise_on(build_kernels(True).gru_sequence_step_clocks(out), "gru_sequence_step_clocks")
    return {
        name: {phase: out[8 * i + j] / t_len for j, phase in enumerate(PHASES[name])}
        for i, name in enumerate(PHASES)
    }


class GRUSequenceFn(torch.autograd.Function):
    """forward = K1, backward = K2p + K2a + K2b (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, gates_i, keep, h0, w_h, b_hn):
        hs = gru_sequence_forward(gates_i, keep, h0, w_h, b_hn)
        ctx.save_for_backward(gates_i, keep, h0, w_h, b_hn, hs)
        return hs

    @staticmethod
    @once_differentiable
    def backward(ctx, g_hs):
        dgates, dh0, dwh, dbhn = gru_sequence_backward(
            *ctx.saved_tensors, g_hs.contiguous()
        )
        return dgates, None, dh0, dwh, dbhn


def gru_sequence(gates_i, keep, h0, w_h, b_hn) -> torch.Tensor:
    """Differentiable GRU recurrence over time; see the module docstring."""
    return GRUSequenceFn.apply(gates_i, keep, h0, w_h, b_hn)


class GRUSequenceStackedFn(torch.autograd.Function):
    """forward = the stacked K1, backward = the stacked K2p + K2a + K2b (the plain
    versions entry by entry on CPU tensors)."""

    @staticmethod
    def forward(ctx, gates_i, keep, h0, w_h, b_hn):
        hs = gru_sequence_stacked_forward(gates_i, keep, h0, w_h, b_hn)
        ctx.save_for_backward(gates_i, keep, h0, w_h, b_hn, hs)
        return hs

    @staticmethod
    @once_differentiable
    def backward(ctx, g_hs):
        dgates, dh0, dwh, dbhn = gru_sequence_stacked_backward(
            *ctx.saved_tensors, g_hs.contiguous()
        )
        return dgates, None, dh0, dwh, dbhn


def gru_sequence_stacked(gates_i, keep, h0, w_h, b_hn) -> torch.Tensor:
    """The GRU recurrence over a leading stack axis: gates_i (S,T,B,3H), keep
    (T,B,H) shared or (S,T,B,H) per entry, h0 (S,B,H), w_h (S,H,3H), b_hn (S,H)
    -> hs (S,T,B,H). Differentiable with respect to all but keep."""
    return GRUSequenceStackedFn.apply(gates_i, keep, h0, w_h, b_hn)
