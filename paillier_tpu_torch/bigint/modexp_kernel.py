"""Kernel B2: the fixed-window ladder (shared or per-row exponents) on the
GPU.

Replaces ``paillier_tpu/bigint/pallas_rns2.py:_modexp_kernel`` (wrapper
``rns2_pow_pallas``).  The kernel is hand-written CUDA C++ in
``paillier_tpu_torch/csrc/rns2_modexp.cu`` (its header note gives the
layout and what bounds it; the Montgomery multiply on int8 tensor cores
and the tile rule are kernel B1's, in ``csrc/rns2_mont_mma.cuh``);
:mod:`cuda_build` builds it with ``nvcc`` for ``sm_90a`` at first use and
binds its plain C entry point with ``ctypes``; it launches on PyTorch's
current stream.

:func:`rns2_pow_b2` takes a CPU tensor to the plain version,
:func:`rns2_pow_plain` (re-exported here from :mod:`rns2`), and a CUDA
tensor to the kernel.  There is no fallback: a CUDA tensor that the
kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .rns2 import Rns2Context, rns2_pow_plain

__all__ = ["rns2_pow_b2", "rns2_pow_plain", "load"]

SOURCE = cuda_build.CSRC / "rns2_modexp.cu"

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rns2_modexp_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, vp,
                                       vp, vp, vp, ci, ci, ci, ci, vp]
    lib.rns2_modexp_launch.restype = ci
    lib.rns2_modexp_rows.argtypes = [ci, ci]
    lib.rns2_modexp_rows.restype = ci
    _lib = lib
    return lib


def _check_digits(digits: torch.Tensor, B: int, window: int) -> None:
    """Digits must be integers [D] or [B, D], D >= 1, each in
    [0, 2^window): the kernel indexes the power table with them
    unchecked."""
    if (digits.dtype.is_floating_point or digits.dtype.is_complex
            or digits.dtype == torch.bool or digits.dim() not in (1, 2)):
        raise ValueError(f"digits must be integers [D] or [B, D], got "
                         f"{digits.dtype} {tuple(digits.shape)}")
    if digits.shape[-1] < 1:
        raise ValueError("digits must hold at least one digit")
    if digits.dim() == 2 and digits.shape[0] != B:
        raise ValueError(f"per-row digits have {digits.shape[0]} rows, x has "
                         f"{B}")
    lo, hi = (int(v) for v in torch.aminmax(digits))
    if lo < 0 or hi >= 1 << window:
        raise ValueError(f"digits must lie in [0, {1 << window}) for window "
                         f"{window}, got [{lo}, {hi}]")


def rns2_pow_b2(ctx: Rns2Context, x: torch.Tensor, digits,
                window: int = 4) -> torch.Tensor:
    """x^e mod N by the fixed-window ladder.

    x: int32 [B, C] (or [C]) standard residues; digits: int32 [D] shared
    or [B, D] per row, MSB-first base-2^window.  Returns canonical
    residues of a value < lambda*N, bit-identical to
    :func:`rns2_pow_plain`.  The launcher picks the kernel's tile rows
    (``rns2_modexp_rows``, B1's rule).  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel and adds one to
    ``rns2_pow_b2.launches``.
    """
    if x.device.type == "cpu":
        return rns2_pow_plain(ctx, x, digits, window)
    if x.device.type != "cuda":
        raise ValueError(f"kernel B2 runs on CUDA tensors, got {x.device}")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    cuda_build.check_operand(ctx, x, window, "B2")
    x = x.contiguous()
    B, C = x.shape
    digits = torch.as_tensor(digits, device=x.device)
    _check_digits(digits, B, window)
    digits = digits.to(torch.int32)
    lib = load()
    per_row = digits.dim() == 2
    D = digits.shape[-1]
    ic1, ic2, f1, f2, e1p, e2p = cuda_build.context_pointers(ctx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rows = lib.rns2_modexp_rows(B, ctx.k)
        if rows <= 0:
            raise RuntimeError(f"kernel B2's tile rule failed: cudaError "
                               f"{-rows}")
        Bp = -(-B // rows) * rows
        if per_row:        # pad rows read table entry 0 and are not stored
            digits = torch.nn.functional.pad(digits, (0, 0, 0, Bp - B))
        digits = digits.contiguous()
        tbl = torch.empty((Bp, 1 << window, C), dtype=torch.int16,
                          device=x.device)
        out = torch.empty_like(x)
        err = lib.rns2_modexp_launch(
            x.data_ptr(), digits.data_ptr(), D, int(per_row),
            ic1.data_ptr(), ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            e1p.data_ptr(), e2p.data_ptr(), tbl.data_ptr(), out.data_ptr(),
            B, ctx.k, window, rows, stream)
    if err:
        raise RuntimeError(f"kernel B2 launch failed: cudaError {err}")
    cuda_build.count_launch(rns2_pow_b2)
    return out[0] if squeeze else out


rns2_pow_b2.launches = 0
