"""Kernel B3: the fixed-base comb ladder (per-row exponents) on the GPU.

Replaces ``paillier_tpu/bigint/pallas_rns2.py:_fixed_base_kernel``
(wrapper ``rns2_pow_fixed_base_pallas``).  The kernel is hand-written
CUDA C++ in ``paillier_tpu_torch/csrc/rns2_fixed_base.cu`` (its header
note gives the layout and what bounds it; the Montgomery multiply on int8
tensor cores, the per-row table copy and the tile rule are kernel B1's and
B2's, in ``csrc/rns2_mont_mma.cuh``); :mod:`cuda_build` builds it with
``nvcc`` for ``sm_90a`` at first use and binds its plain C entry point
with ``ctypes``; it launches on PyTorch's current stream.

:func:`rns2_pow_fixed_base_b3` takes a CPU table to the plain version,
:func:`rns2_pow_fixed_base_plain` (re-exported here from :mod:`rns2`),
and a CUDA table to the kernel.  There is no fallback: a CUDA tensor that
the kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.profiling import spanned
from . import cuda_build
from .modexp_kernel import _check_digits
from .rns2 import Rns2Context, rns2_pow_fixed_base_plain

__all__ = ["rns2_pow_fixed_base_b3", "rns2_pow_fixed_base_plain", "load"]

SOURCE = cuda_build.CSRC / "rns2_fixed_base.cu"

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rns2_fixed_base_launch.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp,
                                           vp, vp, vp, ci, ci, ci, ci, vp]
    lib.rns2_fixed_base_launch.restype = ci
    lib.rns2_fixed_base_rows.argtypes = [ci, ci]
    lib.rns2_fixed_base_rows.restype = ci
    _lib = lib
    return lib


@spanned("ladder", kernel="B3")
def rns2_pow_fixed_base_b3(ctx: Rns2Context, table: torch.Tensor, digits,
                           window: int = 4, fin: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """base^e_b * fin_b mod N by the comb table.

    table: int [D*2^w, C] canonical residues (rns2.build_fixed_base_table);
    digits: int [B, D] per row, MSB-first base-2^window; fin: canonical
    int32 [B, C] or [C] residues (None: 1).  Returns int32 [B, C]
    canonical residues of a value < lambda*N, bit-identical to
    :func:`rns2_pow_fixed_base_plain`.  The launcher picks the kernel's
    tile rows (``rns2_fixed_base_rows``, B1's rule).  A CPU table runs the
    plain version; a CUDA table launches the kernel and adds one to
    ``rns2_pow_fixed_base_b3.launches``.
    """
    if table.device.type == "cpu":
        return rns2_pow_fixed_base_plain(ctx, table, digits, window, fin=fin)
    if table.device.type != "cuda":
        raise ValueError(f"kernel B3 runs on CUDA tensors, got {table.device}")
    digits = torch.as_tensor(digits, device=table.device)
    if digits.dim() != 2:
        raise ValueError(f"digits must be per-row [B, D], got "
                         f"{tuple(digits.shape)}")
    B, D = digits.shape
    _check_digits(digits, B, window)
    T = 1 << window
    C = 2 * ctx.k
    if table.dim() != 2 or tuple(table.shape) != (D * T, C):
        raise ValueError(f"table must be [D * 2^window, 2k] = {(D * T, C)}, "
                         f"got {tuple(table.shape)}")
    # the kernel checks the context against a [B, 2k] int32 operand
    cuda_build.check_operand(ctx, torch.empty((0, C), dtype=torch.int32,
                                              device=table.device),
                             window, "B3")
    if fin is not None:
        if fin.dtype != torch.int32 or fin.device != table.device:
            raise ValueError("fin must be int32 on the device of the table")
        fin = fin.expand(B, C).contiguous()
    lib = load()
    tbl16 = table.to(torch.int16).contiguous()
    ic1, ic2, f1, f2, e1p, e2p = cuda_build.context_pointers(ctx)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rows = lib.rns2_fixed_base_rows(B, ctx.k)
        if rows <= 0:
            raise RuntimeError(f"kernel B3's tile rule failed: cudaError "
                               f"{-rows}")
        # pad rows read entry 0 of each step and are not stored
        dig = torch.nn.functional.pad(digits.to(torch.int32),
                                      (0, 0, 0, -(-B // rows) * rows - B)
                                      ).contiguous()
        out = torch.empty((B, C), dtype=torch.int32, device=table.device)
        err = lib.rns2_fixed_base_launch(
            tbl16.data_ptr(), dig.data_ptr(), D,
            fin.data_ptr() if fin is not None else None,
            ic1.data_ptr(), ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            e1p.data_ptr(), e2p.data_ptr(), out.data_ptr(), B, ctx.k,
            window, rows, stream)
    if err:
        raise RuntimeError(f"kernel B3 launch failed: cudaError {err}")
    cuda_build.count_launch(rns2_pow_fixed_base_b3)
    return out


rns2_pow_fixed_base_b3.launches = 0
