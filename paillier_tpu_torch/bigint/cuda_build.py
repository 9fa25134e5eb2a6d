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
matrices packed into tensor-core fragments, and the checks of a context
against an operand), and the launch counter of the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
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


_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                   r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)(.*)")
_TARGET = re.compile(r"`?\(?(\.L_x_\d+|0x[0-9a-f]+)\)?")


def sass_loop_ops(code: str) -> dict[str, list[str]]:
    """For each function of ``cuobjdump -sass`` output, the opcodes (with
    their modifiers, e.g. ``IMMA.16832.S8.S8``) of the instructions that
    lie inside a loop: between a branch's target and the branch, where
    the target is not after the branch.  Targets may be labels
    (``.L_x_3``) or addresses (``0x0210``)."""
    funcs: dict[str, list] = {}
    insns: list = []
    labels: dict[str, int] = {}
    pending: list[str] = []
    for line in code.splitlines():
        m = _FUNC.match(line)
        if m:
            insns, labels, pending = [], {}, []
            funcs[m.group(1)] = (insns, labels)
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and funcs:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    out = {}
    for name, (insns, labels) in funcs.items():
        spans = []
        for addr, op, rest in insns:
            if op.split(".")[0] != "BRA":
                continue
            t = _TARGET.search(rest)
            if t is None:
                continue
            tgt = t.group(1)
            tgt = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
            if tgt is not None and tgt <= addr:
                spans.append((tgt, addr))
        out[name] = [op for addr, op, _ in insns
                     if any(a <= addr <= b for a, b in spans)]
    return out


def pack_mma(e: torch.Tensor) -> torch.Tensor:
    """int8 [D, 2c] -> int8 [c/16, D/64, 2, 2, 32, 16], the A fragments
    of ``mma.m16n8k32.row.col.s8`` over E^T (csrc/rns2_mont_mma.cuh):
    [channel group cg][64-digit slice s][k32 step u][lo/hi h][lane][16 B].
    The ladders' matrices are square (D = 2c = 2k); the probes
    (``paillier_tpu_torch/probes``) also pack [640, 768] and [640, 384].

    Lane 4g + t holds, in register 2j + i (bytes 4 (2j + i) + b), the entry
    E[64 s + 16 t + 8 u + 4 j + b, h c + 16 cg + 8 i + g]: fragment row
    (channel) g + 8 i, fragment column (digit) 16 j + 4 t + b of step
    2 s + u, whose digits are permuted within the 64-digit slice so that
    a lane's B fragments of both steps are bytes 16 t .. 16 t + 15 of a
    digit row."""
    D, c = e.shape[0], e.shape[1] // 2
    # p = (s, t, u, j, b), column = (h, cg, i, g)
    v = e.reshape(D // 64, 4, 2, 2, 4, 2, c // 16, 2, 8)
    return v.permute(6, 0, 2, 5, 8, 1, 3, 7, 4).contiguous().reshape(
        c // 16, D // 64, 2, 2, 32, 16)


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


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, under a lock: the DDLEQ chunk
    pipeline launches the kernels from two threads."""
    with _count_lock:
        wrapper.launches += 1


def context_pointers(ctx) -> tuple:
    """The context as kernels B1-B3 take it: contiguous ic1, ic2, f1, f2
    and the two matrices packed by :func:`pack_mma` (kept alive by the
    caller)."""
    return (ctx.ic1.contiguous(), ctx.ic2.contiguous(), ctx.f1.contiguous(),
            ctx.f2.contiguous(), pack_mma(ctx.e1g), pack_mma(ctx.e2g))
