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
    `gru_sequence_reference` and `gru_sequence_backward_reference`;
  * CUDA tensors go to the hand-written kernels of `csrc/gru_sequence.cu`
    (K1 forward; K2a reverse recurrence + K2b deterministic dWh/db_hn
    reduction), built with nvcc for sm_90a on first use into `build/kernels/`
    and bound with ctypes. A CUDA tensor never falls back to the plain version:
    a build or launch failure raises.

`fwd_launches` and `bwd_launches` count kernel launches (one per forward call,
one per backward call, which runs K2a then K2b); the plain versions leave
them alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gru_sequence.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_HIDDEN = 1024

fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
# What nvcc printed (ptxas register and shared-memory use) for the library this
# process built; empty when it was loaded from the build directory.
build_log = ""


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


# --------------------------------------------------------------------------- build and bind
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the GRU kernels need the CUDA toolkit to build.")


def build_kernels() -> ctypes.CDLL:
    """Build `csrc/gru_sequence.cu` (once per source hash) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libgru_sequence_{key.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
        build_log = proc.stderr + proc.stdout
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_sequence_fwd.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.gru_sequence_fwd.restype = i32
    lib.gru_sequence_bwd.argtypes = [ptr] * 13 + [i32] * 3 + [ptr]
    lib.gru_sequence_bwd.restype = i32
    _lib = lib
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


def _check_inputs(gates_i, keep, h0, w_h, b_hn) -> Tuple[int, int, int]:
    if gates_i.dim() != 3 or gates_i.shape[-1] % 3 != 0:
        raise ValueError(f"gru_sequence: gates_i must be (T, B, 3H), got {tuple(gates_i.shape)}")
    t_len, b, h3 = gates_i.shape
    h = h3 // 3
    if t_len < 1 or b < 1 or not 1 <= h <= MAX_HIDDEN:
        raise ValueError(
            f"gru_sequence: need T >= 1, B >= 1 and 1 <= H <= {MAX_HIDDEN}, "
            f"got T={t_len}, B={b}, H={h}"
        )
    dev = gates_i.device
    _check("gates_i", gates_i, (t_len, b, h3), dev)
    _check("keep", keep, (t_len, b, h), dev)
    _check("h0", h0, (b, h), dev)
    _check("w_h", w_h, (h, h3), dev)
    _check("b_hn", b_hn, (h,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_sequence: unsupported device {dev}")
    return t_len, b, h


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def gru_sequence_forward(gates_i, keep, h0, w_h, b_hn) -> torch.Tensor:
    """hs (T,B,H). K1 on CUDA tensors, the plain loop on CPU tensors."""
    global fwd_launches
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    if gates_i.device.type == "cpu":
        return gru_sequence_reference(gates_i, keep, h0, w_h, b_hn)
    lib = build_kernels()
    hs = torch.empty((t_len, b, h), dtype=torch.float32, device=gates_i.device)
    with torch.cuda.device(gates_i.device):
        err = lib.gru_sequence_fwd(
            *map(_ptr, (gates_i, keep, h0, w_h, b_hn, hs)),
            t_len, b, h, _stream(gates_i.device),
        )
    _raise_on(err, "gru_sequence_fwd")
    fwd_launches += 1
    return hs


def gru_sequence_backward(gates_i, keep, h0, w_h, b_hn, hs, g_hs):
    """(dgates_i, dh0, dWh, db_hn). K2a + K2b on CUDA, the plain loop on CPU."""
    global bwd_launches
    t_len, b, h = _check_inputs(gates_i, keep, h0, w_h, b_hn)
    _check("hs", hs, (t_len, b, h), gates_i.device)
    _check("g_hs", g_hs, (t_len, b, h), gates_i.device)
    if gates_i.device.type == "cpu":
        return gru_sequence_backward_reference(gates_i, keep, h0, w_h, b_hn, hs, g_hs)
    lib = build_kernels()
    dev = gates_i.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    w_h_t = empty(3 * h, h)
    w_h_t.copy_(w_h.T)
    dgates, dgh = empty(t_len, b, 3 * h), empty(t_len, b, 3 * h)
    dh0, dwh, dbhn = empty(b, h), empty(h, 3 * h), empty(h)
    with torch.cuda.device(dev):
        err = lib.gru_sequence_bwd(
            *map(_ptr, (gates_i, keep, h0, w_h, w_h_t, b_hn, hs, g_hs)),
            *map(_ptr, (dgates, dgh, dh0, dwh, dbhn)),
            t_len, b, h, _stream(dev),
        )
    _raise_on(err, "gru_sequence_bwd")
    bwd_launches += 1
    return dgates, dh0, dwh, dbhn


class GRUSequenceFn(torch.autograd.Function):
    """forward = K1, backward = K2a + K2b (plain versions on CPU tensors)."""

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
