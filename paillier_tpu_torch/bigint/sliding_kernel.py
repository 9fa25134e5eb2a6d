"""Kernel B1: the shared-exponent sliding-window ladder on the GPU.

Replaces ``paillier_tpu/bigint/pallas_rns2.py:_sliding_kernel`` (wrapper
``rns2_pow_sliding_pallas``).  The kernel is hand-written CUDA C++ in
``paillier_tpu_torch/csrc/rns2_sliding.cu`` (its header note gives the
layout and what bounds it); this module builds it with ``nvcc`` for
``sm_90a`` at first use, binds its plain C entry point with ``ctypes``
and launches it on PyTorch's current stream.

:func:`rns2_pow_sliding_b1` takes a CPU tensor to the plain version,
:func:`rns2_pow_sliding_plain` (re-exported here from :mod:`rns2`), and a
CUDA tensor to the kernel.  There is no fallback: a CUDA tensor that the
kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .rns2 import Rns2Context, rns2_pow_sliding_plain

__all__ = ["rns2_pow_sliding_b1", "rns2_pow_sliding_plain", "load"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "rns2_sliding.cu"
BUILD_DIR = _PKG.parent / "build" / "paillier_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
K_MAX = 320          # __launch_bounds__(320, 2): at most 320 threads a block

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: kernel B1 cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"rns2_sliding_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n"
                               f"{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rns2_sliding_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, vp,
                                        vp, vp, vp, ci, ci, ci, vp]
    lib.rns2_sliding_launch.restype = ci
    lib.rns2_sliding_rows.argtypes = []
    lib.rns2_sliding_rows.restype = ci
    _lib = lib
    return lib


def _pack_dp4a(e: torch.Tensor) -> torch.Tensor:
    """int8 [2k, 2k] -> int32 [2k/4, 2k]: word (q, j) holds the bytes
    e[4q + t, j], t = 0..3, in little-endian order (the __dp4a layout)."""
    C = e.shape[0]
    return (e.reshape(C // 4, 4, C).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(C // 4, C))


def _check(ctx: Rns2Context, x: torch.Tensor, window: int):
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be int32 [B, 2k], got {x.dtype} "
                         f"{tuple(x.shape)}")
    k = ctx.k
    if x.shape[1] != 2 * k:
        raise ValueError(f"x has {x.shape[1]} channels, context has {2 * k}")
    if k % 64 or k > K_MAX:
        raise ValueError(f"kernel B1 takes k a multiple of 64 up to {K_MAX}, "
                         f"got k={k}")
    if not 1 <= window <= 8:
        raise ValueError(f"window {window} outside 1..8")
    for name, t in ctx._asdict().items():
        if t.device != x.device:
            raise ValueError(f"context {name} on {t.device}, x on {x.device}")


def rns2_pow_sliding_b1(ctx: Rns2Context, x: torch.Tensor, sched,
                        window: int = 6, fin: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """x^e * fin mod N by a shared sliding-window schedule.

    x: int32 [B, C] (or [C]) standard residues; sched: int32 [1+S] from
    rns2.sliding_window_schedule; fin: canonical int32 [B, C] or [C]
    residues (None: 1).  Bit-identical to the plain version.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel
    and adds one to ``rns2_pow_sliding_b1.launches``.
    """
    if x.device.type == "cpu":
        return rns2_pow_sliding_plain(ctx, x, sched, window, fin=fin)
    if x.device.type != "cuda":
        raise ValueError(f"kernel B1 runs on CUDA tensors, got {x.device}")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    _check(ctx, x, window)
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
    rows = lib.rns2_sliding_rows()
    Bp = -(-B // rows) * rows
    tbl = torch.empty((Bp, T, C), dtype=torch.int16, device=x.device)
    out = torch.empty_like(x)
    e1q, e2q = _pack_dp4a(ctx.e1g), _pack_dp4a(ctx.e2g)
    f1, f2 = ctx.f1.contiguous(), ctx.f2.contiguous()
    ic1, ic2 = ctx.ic1.contiguous(), ctx.ic2.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rns2_sliding_launch(
            x.data_ptr(), fin.data_ptr() if fin is not None else None,
            sched_t.data_ptr(), sched_t.numel() - 1,
            ic1.data_ptr(), ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            e1q.data_ptr(), e2q.data_ptr(), tbl.data_ptr(), out.data_ptr(),
            B, ctx.k, window, stream)
    if err:
        raise RuntimeError(f"kernel B1 launch failed: cudaError {err}")
    rns2_pow_sliding_b1.launches += 1
    return out[0] if squeeze else out


rns2_pow_sliding_b1.launches = 0
