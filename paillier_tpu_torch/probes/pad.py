"""Probe P4: the L2 read rate of the extension matrices, and what a column
permutation costs.

Replaces ``scripts/perf_pad.py``: ``bench_dots``' ``kern`` (its
``pl.pallas_call`` at :87) and ``bench_roll``'s ``kern_roll`` /
``kern_base`` (:129).

  pad    ``steps`` chained products of acc int32 [B, 640]: p = int8(acc)
         @ W, W int8 [640, lanes] (lanes 768, 640 or 384), acc = p & 63
         fed back at 640 columns (columns past 640 dropped, past ``lanes``
         zero)
  roll   32 steps of acc = (acc + roll(acc, 320, 1)) & 0xFFFF on int32
         [B, 640]; with ``permute=False`` acc = (acc + acc) & 0xFFFF

On the H100 (``csrc/probe_pad.cu``) every block of R rows reads all of W
at every step through B1's fragment code: ``ceil(B / R) * 640 * lanes *
steps`` bytes (:func:`l2_bytes`).  Over the time that is the rate the
blocks ask for, some of it served by L1 (``__ldg``, B1's loads); with
``l2_only`` the loads are ``ld.global.cg``, which L1 does not cache, so
it is the rate the L2 delivers.  The roll moves values between threads
through shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bigint import cuda_build
from ..bigint.limbmm import _dot_i8
from . import CI, D, K, VP, Kernel, check, on_cuda, pick_tile, stream

SCRIPT = "scripts/perf_pad.py:69"         # bench_dots' kern
SCRIPT_ROLL = "scripts/perf_pad.py:109"   # bench_roll's kern_roll, kern_base
B = 1024
STEPS = 8
ROLL_STEPS = 32
WIDTHS = (768, 640, 384)

KERNEL = Kernel("pad", {
    "pad_launch": [VP, VP, VP, VP, CI, CI, CI, CI, CI, VP],
    "roll_launch": [VP, VP, CI, CI, CI, VP]})
# every instantiation's loop holds the tensor-core product (IMMA); W's
# 16-byte loads go through the read-only cache (LDG.E.128.CONSTANT) in
# the instantiations of B1's loads, and in the l2_only ones are strong
# GPU-scope loads (ld.global.cg: LDG.E.128.STRONG.GPU), which L1 does not
# serve, and none of them goes through the read-only cache
SASS_EXPECT = {
    r"pad_kernel.*LoadNC": [(r"IMMA", 1), (r"LDG\.E\.128\.CONSTANT", 1)],
    r"pad_kernel.*LoadL2": [(r"IMMA", 1), (r"LDG\.E\.128\.STRONG\.GPU", 1),
                            (r"LDG\.E\.128\.CONSTANT", 0, 0)]}


def inputs(lanes: int, rows: int = B, seed: int = 0, device="cpu") -> tuple:
    """(x, W) of width ``lanes`` as ``bench_dots`` draws them: W int8 in
    [-100, 100), then x int32 in [0, 64), width after width."""
    rng = np.random.default_rng(seed)
    for w in WIDTHS:
        W = rng.integers(-100, 100, (D, w), np.int8)
        x = rng.integers(0, 64, (rows, D), np.int32)
        if w == lanes:
            return (torch.as_tensor(x, device=device),
                    torch.as_tensor(W, device=device))
    raise ValueError(f"lanes must be one of {WIDTHS}, got {lanes}")


def roll_input(rows: int = B, device="cpu") -> torch.Tensor:
    return torch.arange(rows * D, dtype=torch.int32,
                        device=device).reshape(rows, D)


def pad_plain(x, w, steps: int = STEPS) -> torch.Tensor:
    lanes = w.shape[1]
    acc = x
    for _ in range(steps):
        p = _dot_i8(acc.to(torch.int8), w) & 63
        acc = (p[:, :D] if lanes >= D else torch.nn.functional.pad(
            p, (0, D - lanes)))
    return acc


def pad(x, w, steps: int = STEPS, rows: int | None = None,
        l2_only: bool = False) -> torch.Tensor:
    """The chained products on x int32 [B, 640], W int8 [640, lanes].  A
    CPU tensor runs :func:`pad_plain`; a CUDA tensor launches the kernel
    in tiles of ``rows`` rows (8, 16 or 32; default: B1's rule), loading
    W past L1 if ``l2_only``, and adds one to ``pad.launches``."""
    if not on_cuda(x, "P4"):
        return pad_plain(x, w, steps)
    x = check(x, "x", torch.int32, (None, D))
    w = check(w, "W", torch.int8, (D, None))
    lanes = w.shape[1]
    if lanes not in WIDTHS or steps < 1:
        raise ValueError(f"W must have {WIDTHS} columns and steps >= 1, got "
                         f"{lanes}, {steps}")
    ep = cuda_build.pack_mma(w)
    rows = pick_tile(rows, x.shape[0])
    out = torch.empty_like(x)
    KERNEL.launch("pad_launch", x.device, x.data_ptr(), ep.data_ptr(),
                  out.data_ptr(), None, x.shape[0], lanes, steps, rows,
                  int(l2_only), stream(x))
    pad.launches += 1
    return out


pad.launches = 0


def roll_plain(x, steps: int = ROLL_STEPS, permute: bool = True
               ) -> torch.Tensor:
    for _ in range(steps):
        x = (x + (torch.roll(x, K, 1) if permute else x)) & 0xFFFF
    return x


def roll(x, steps: int = ROLL_STEPS, permute: bool = True) -> torch.Tensor:
    """``roll_plain`` on x int32 [B, 640]: a CPU tensor runs it; a CUDA
    tensor launches the roll kernel and adds one to ``roll.launches``."""
    if not on_cuda(x, "P4"):
        return roll_plain(x, steps, permute)
    x = check(x, "x", torch.int32, (None, D))
    out = torch.empty_like(x)
    KERNEL.launch("roll_launch", x.device, x.data_ptr(), out.data_ptr(),
                  x.shape[0], steps, int(permute), stream(x))
    roll.launches += 1
    return out


roll.launches = 0


def macs(rows: int, lanes: int, steps: int = STEPS) -> int:
    """int8 multiply-adds the function needs: the product's columns past
    640 are dropped, so only min(lanes, 640) columns count."""
    return rows * steps * D * min(lanes, D)


def l2_bytes(rows: int, tile: int, lanes: int, steps: int = STEPS) -> int:
    """Bytes of W the blocks read from L2: each of ceil(B / R) blocks all
    of W at every step (worked out, not counted)."""
    return -(-rows // tile) * D * lanes * steps


def io_bytes(rows: int, lanes: int) -> int:
    """Each input read once (of W the columns used), the output written
    once."""
    return rows * D * 4 * 2 + D * min(lanes, D)
