"""Kernel B1: the shared-exponent sliding-window ladder on the GPU.

Replaces ``paillier_tpu/bigint/pallas_rns2.py:_sliding_kernel`` (wrapper
``rns2_pow_sliding_pallas``).  The kernel is hand-written CUDA C++ in
``paillier_tpu_torch/csrc/rns2_sliding.cu`` (its header note gives the
launch rule and what bounds it; the Montgomery multiply on int8 tensor
cores is in ``csrc/rns2_mont_mma.cuh``); :mod:`cuda_build` builds
it with ``nvcc`` for ``sm_90a`` at first use and binds its plain C entry
point with ``ctypes``; it launches on PyTorch's current stream.

:func:`rns2_pow_sliding_b1` takes a CPU tensor to the plain version,
:func:`rns2_pow_sliding_plain` (re-exported here from :mod:`rns2`), and a
CUDA tensor to the kernel.  There is no fallback: a CUDA tensor that the
kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.profiling import spanned
from . import cuda_build
from .rns2 import Rns2Context, rns2_pow_sliding_plain

__all__ = ["rns2_pow_sliding_b1", "rns2_pow_sliding_plain", "load"]

SOURCE = cuda_build.CSRC / "rns2_sliding.cu"

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rns2_sliding_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, vp,
                                        vp, vp, vp, ci, ci, ci, ci, vp]
    lib.rns2_sliding_launch.restype = ci
    lib.rns2_sliding_rows.argtypes = [ci, ci]
    lib.rns2_sliding_rows.restype = ci
    _lib = lib
    return lib


@spanned("ladder", kernel="B1")
def rns2_pow_sliding_b1(ctx: Rns2Context, x: torch.Tensor, sched,
                        window: int = 6, fin: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """x^e * fin mod N by a shared sliding-window schedule.

    x: int32 [B, C] (or [C]) standard residues; sched: int32 [1+S] from
    rns2.sliding_window_schedule; fin: canonical int32 [B, C] or [C]
    residues (None: 1).  The launcher picks the kernel's tile rows
    (``rns2_sliding_rows``).  Bit-identical to the plain version.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel and
    adds one to ``rns2_pow_sliding_b1.launches``.
    """
    if x.device.type == "cpu":
        return rns2_pow_sliding_plain(ctx, x, sched, window, fin=fin)
    if x.device.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA tensors, got {x.device}")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    cuda_build.check_operand(ctx, x, window, "B1")
    x = x.contiguous()
    B, C = x.shape
    if fin is not None:
        if fin.dtype != torch.int32 or fin.device != x.device:
            raise ValueError("fin must be int32 on the device of x")
        fin = fin.expand(B, C).contiguous()
    sched = np.asarray(torch.as_tensor(sched).cpu(), dtype=np.int32)
    T = 1 << (window - 1)
    # the kernel reads table indices from the schedule unchecked
    if (sched.ndim != 1 or sched.size < 1 or not 0 <= sched[0] < T
            or sched.min() < -2 or sched.max() >= T):
        raise ValueError(f"sched must be int32 [1 + S] with table indices "
                         f"below {T} and sentinels -2 / -1")
    sched_t = torch.as_tensor(sched, device=x.device)
    lib = load()
    ic1, ic2, f1, f2, e1p, e2p = cuda_build.context_pointers(ctx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rows = lib.rns2_sliding_rows(B, ctx.k)
        if rows <= 0:
            raise RuntimeError(f"kernel B1's tile rule failed: cudaError "
                               f"{-rows}")
        tbl = torch.empty((-(-B // rows) * rows, T, C), dtype=torch.int16,
                          device=x.device)
        out = torch.empty_like(x)
        err = lib.rns2_sliding_launch(
            x.data_ptr(), fin.data_ptr() if fin is not None else None,
            sched_t.data_ptr(), sched_t.numel() - 1,
            ic1.data_ptr(), ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            e1p.data_ptr(), e2p.data_ptr(), tbl.data_ptr(), out.data_ptr(),
            B, ctx.k, window, rows, stream)
    if err:
        raise RuntimeError(f"kernel B1 launch failed: cudaError {err}")
    cuda_build.count_launch(rns2_pow_sliding_b1)
    return out[0] if squeeze else out


rns2_pow_sliding_b1.launches = 0
