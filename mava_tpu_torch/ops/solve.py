"""The articulated envs' batched solve M x = b: a hand-written CUDA kernel for
the card (`csrc/batched_solve.cu`: LU with partial pivoting, one system per
warp), and its plain version, `torch.linalg.solve_ex` without the error check.

The op dispatches on the tensors' device: CPU tensors take the plain version,
CUDA tensors the kernel, or an exception; there is no fallback. The kernel
replaces no TPU kernel (the reference's `jnp.linalg.solve` is XLA's). It is on
the path because the integrator's step is captured as one CUDA graph
(`envs/_dynamics.py`), and PyTorch's batched solve on the card takes a route
that a capture does not permit for MaHumanoid's 23 x 23 systems at batches
above 16. `envs/_dynamics.py` puts `solve_ex_on_card` in the traced q̈ of
every CUDA batch shape, in place of `aten._linalg_solve_ex`.

`launches` counts the kernel's launches on the card: one a call of
`batched_solve` on CUDA tensors, and, where the call was captured into a CUDA
graph, one at every replay of that graph (`envs/_dynamics.CapturedStep` adds
what its capture launched).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from mava_tpu_torch.ops.gru import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "batched_solve.cu"
MAX_N = 32  # one lane of a warp per row

launches = 0
_lib: Optional[ctypes.CDLL] = None


def reset_launch_count() -> None:
    global launches
    launches = 0


def build_solve_kernel() -> ctypes.CDLL:
    """Build `csrc/batched_solve.cu` (once per source hash) and load it."""
    global _lib
    if _lib is None:
        path, _ = build_library(SOURCE)
        lib = ctypes.CDLL(str(path))
        lib.batched_solve.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.batched_solve.restype = ctypes.c_int
        lib.batched_solve_max_n.argtypes = []
        lib.batched_solve_max_n.restype = ctypes.c_int
        if lib.batched_solve_max_n() != MAX_N:
            raise RuntimeError(f"{SOURCE} takes systems of up to {lib.batched_solve_max_n()} "
                               f"rows, ops/solve.py says {MAX_N}")
        _lib = lib
    return _lib


def batched_solve_reference(mass: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M⁻¹ b by LU with partial pivoting, as `jnp.linalg.solve`; the `info`
    check that `torch.linalg.solve` makes (a device-to-host read) is left out."""
    return torch.linalg.solve_ex(mass, rhs, check_errors=False)[0]


def batched_solve(mass: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x (B, n) with M x = b for M (B, n, n) and b (B, n), float32: the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    global launches
    if mass.dim() != 3 or rhs.dim() != 2 or mass.shape[1] != mass.shape[2] \
            or rhs.shape != mass.shape[:2]:
        raise ValueError(f"batched_solve takes M (B, n, n) and b (B, n), got "
                         f"{tuple(mass.shape)} and {tuple(rhs.shape)}")
    if mass.device != rhs.device:
        raise ValueError(f"M is on {mass.device}, b on {rhs.device}")
    if mass.device.type == "cpu":
        return batched_solve_reference(mass, rhs)
    batch, n = rhs.shape
    if mass.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise ValueError(f"the solve kernel takes float32, got {mass.dtype} and {rhs.dtype}")
    if n > MAX_N:
        raise ValueError(f"the solve kernel takes systems of up to {MAX_N} rows, got {n}")
    lib = build_solve_kernel()
    mass, rhs = mass.contiguous(), rhs.contiguous()
    x = torch.empty_like(rhs)
    if batch:
        device = mass.device
        with torch.cuda.device(device):
            err = lib.batched_solve(mass.data_ptr(), rhs.data_ptr(), x.data_ptr(), batch, n,
                                    torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"batched_solve: CUDA error {err} at launch")
        launches += 1
    return x


def solve_ex_on_card(mass: torch.Tensor, rhs: torch.Tensor, left: bool = True,
                     check_errors: bool = False) -> Tuple[torch.Tensor]:
    """What a traced q̈ on the card calls in place of `aten._linalg_solve_ex`
    (whose result it reads at index 0 only): the kernel's x, as a 1-tuple."""
    if not left or check_errors:
        raise ValueError("solve_ex_on_card solves from the left, without the error check")
    return (batched_solve(mass, rhs),)
