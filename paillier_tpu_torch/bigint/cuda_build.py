"""Build and bind the hand-written CUDA kernels (``paillier_tpu_torch/csrc``).

Each kernel source is compiled on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C entry point, at first use, into
``build/paillier_tpu_torch/`` beside the package; the library's name
carries a hash of the source, of every header it includes (recursively,
``#include "..."``) and of the flags, so an edited header never reuses a
stale build.  The wrappers load the library with ``ctypes`` and launch on
PyTorch's current stream.  Nothing here runs at import time, and nothing
falls back: a missing ``nvcc`` or a failed build raises.

Also here: what the RNS ladder kernels' wrappers (B1-B3) share (the
matrix packings, tensor-core fragments for B1 and B2 and ``__dp4a``
words for B3, and the checks of a context against an operand).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paillier_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
K_MAX = 704          # rns2_mont.cuh K_MAX: at most 704 threads (22 warps)

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def source_files(source: Path) -> list[Path]:
    """``source`` and every header it includes with ``#include "..."``,
    recursively, each once, in the order first met."""
    out: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / name.decode())
    return out


def source_hash(source: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    """Where :func:`build` puts the library of ``source``."""
    return BUILD_DIR / f"{source.stem}_{source_hash(source)}.so"


def build(source: Path) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (once per :func:`source_hash`) and load it.

    Returns the library and nvcc's output (with ptxas' register report;
    empty when the library was already built)."""
    so = library_path(source)
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {source.name}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def sass(source: Path) -> str:
    """``cuobjdump -sass`` of the library :func:`build` made of ``source``
    (the machine code the card runs; build it first)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(library_path(source))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {source.name}: "
                           f"{proc.stderr.strip()}")
    return proc.stdout


def pack_dp4a(e: torch.Tensor) -> torch.Tensor:
    """int8 [2k, 2k] -> int32 [2k/4, 2k]: word (q, j) holds the bytes
    e[4q + t, j], t = 0..3, in little-endian order (the __dp4a layout)."""
    C = e.shape[0]
    return (e.reshape(C // 4, 4, C).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(C // 4, C))


def pack_mma(e: torch.Tensor) -> torch.Tensor:
    """int8 [2k, 2k] -> int8 [k/16, k/16, 2, 2, 32, 16], the A fragments
    of ``mma.m16n8k32.row.col.s8`` over E^T (csrc/rns2_mont_mma.cuh):
    [channel group cg][64-digit slice s][k32 step u][lo/hi h][lane][16 B].

    Lane 4g + t holds, in register 2j + i (bytes 4 (2j + i) + b), the entry
    E[64 s + 16 t + 8 u + 4 j + b, h k + 16 cg + 8 i + g]: fragment row
    (channel) g + 8 i, fragment column (digit) 16 j + 4 t + b of step
    2 s + u, whose digits are permuted within the 64-digit slice so that
    a lane's B fragments of both steps are bytes 16 t .. 16 t + 15 of a
    digit row."""
    C = e.shape[0]
    k = C // 2
    # p = (s, t, u, j, b), column = (h, cg, i, g)
    v = e.reshape(k // 32, 4, 2, 2, 4, 2, k // 16, 2, 8)
    return v.permute(6, 0, 2, 5, 8, 1, 3, 7, 4).contiguous().reshape(
        k // 16, k // 32, 2, 2, 32, 16)


def check_operand(ctx, x: torch.Tensor, window: int, kernel: str) -> None:
    """Raise ValueError unless a ladder kernel takes (ctx, x, window):
    x int32 [B, 2k] on the context's device, k a multiple of 64 up to
    K_MAX, window 1..8."""
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be int32 [B, 2k], got {x.dtype} "
                         f"{tuple(x.shape)}")
    k = ctx.k
    if x.shape[1] != 2 * k:
        raise ValueError(f"x has {x.shape[1]} channels, context has {2 * k}")
    if k % 64 or k > K_MAX:
        raise ValueError(f"kernel {kernel} takes k a multiple of 64 up to "
                         f"{K_MAX}, got k={k}")
    if not 1 <= window <= 8:
        raise ValueError(f"window {window} outside 1..8")
    for name, t in ctx._asdict().items():
        if t.device != x.device:
            raise ValueError(f"context {name} on {t.device}, x on {x.device}")


def context_pointers(ctx, pack=pack_dp4a) -> tuple:
    """The context as the kernels take it: contiguous ic1, ic2, f1, f2 and
    the two matrices packed by ``pack`` (:func:`pack_mma` for B1 and B2,
    :func:`pack_dp4a` for B3; kept alive by the caller)."""
    return (ctx.ic1.contiguous(), ctx.ic2.contiguous(), ctx.f1.contiguous(),
            ctx.f2.contiguous(), pack(ctx.e1g), pack(ctx.e2g))
