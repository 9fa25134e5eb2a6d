"""Probe P3: do the int8 products and the elementwise reductions overlap?

Replaces ``scripts/perf_overlap.py:k_dots / k_vpu / k_both`` (their
``pl.pallas_call`` at :89).  ``steps`` steps of one or both of two
independent chains, returning (o, p):

  dots  x int8 [B, 640]: v = (x@mlo + x@mhi + x@mlo + x@mhi) & 127,
        x = int8(concat(v, v)); p = y unchanged
  vpu   y int32 [B, 320], 3 passes a step of t = y * 12345, q =
        int32(floor(f32(t) * inv)), y = t - q * m and two conditional
        corrections; o = x unchanged
  both  the two in one loop body

``overlap_frac = (dots + vpu - both) / min(dots, vpu)``, as the script
prints it.  On the H100 (``csrc/probe_overlap.cu``) the products are two
passes of B1's fragment code a step and y sits in registers, and the
same warps of a block issue both chains.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bigint import cuda_build
from ..bigint.limbmm import _dot_i8
from . import (CI, D, K, VP, Kernel, chain_draws, check, on_cuda, pick_tile,
               stream)

SCRIPT = "scripts/perf_overlap.py:56"    # k_dots, k_vpu, k_both
B = 512
STEPS = 600
PASSES = 3          # the script's VPU_PASSES
MODES = ("dots", "vpu", "both")
VPU_OPS = 7         # fewest instructions of one pass: IMAD, I2F, FMUL,
                    # F2I.FLOOR, IMAD (t - q m), and one add-min
                    # (VIADDMNMX) for each of the two corrections

KERNEL = Kernel("overlap", {"overlap_launch": [VP, VP, VP, VP, VP, VP, VP,
                                               CI, CI, CI, CI, VP]})
# every instantiation's loop holds the tensor-core product (IMMA)
SASS_EXPECT = {r"overlap_kernel": [(r"IMMA", 1)]}


def inputs(rows: int = B, seed: int = 0, device="cpu") -> tuple:
    """(x, mlo, mhi, y, m, inv) as the script draws them; m int32 [320]
    (the script broadcasts its one row over the batch), inv = 1 / f32(m)."""
    rng = np.random.default_rng(seed)
    x, mlo, mhi = chain_draws(rng, rows)
    y = rng.integers(0, 10000, (rows, K), dtype=np.int32)
    m = rng.integers(12000, 15000, (1, K), dtype=np.int32)[0]
    t = [torch.as_tensor(a, device=device) for a in (x, mlo, mhi, y, m)]
    return (*t, 1.0 / t[4].float())


def vpu_step(y, m, inv):
    for _ in range(PASSES):
        t = y * 12345
        q = torch.floor(t.float() * inv).to(torch.int32)
        y = t - q * m
        y = torch.where(y < 0, y + m, y)
        y = torch.where(y >= m, y - m, y)
    return y


def overlap_plain(x, mlo, mhi, y, m, inv, steps: int, mode: str) -> tuple:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for _ in range(steps):
        if mode != "vpu":
            v = (_dot_i8(x, mlo) + _dot_i8(x, mhi) + _dot_i8(x, mlo)
                 + _dot_i8(x, mhi)) & 127
            x = torch.cat([v, v], dim=-1).to(torch.int8)
        if mode != "dots":
            y = vpu_step(y, m, inv)
    return x, y


def overlap(x, mlo, mhi, y, m, inv, steps: int, mode: str,
            rows: int | None = None) -> tuple:
    """(o, p) of ``mode`` on x int8 [B, 640], mlo, mhi int8 [640, 320],
    y int32 [B, 320], m int32 [320], inv f32 [320].  A CPU tensor runs
    :func:`overlap_plain`; a CUDA tensor launches the kernel in tiles of
    ``rows`` rows (8, 16 or 32; default: B1's rule) and adds one to
    ``overlap.launches``."""
    if not on_cuda(x, "P3"):
        return overlap_plain(x, mlo, mhi, y, m, inv, steps, mode)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    x = check(x, "x", torch.int8, (None, D))
    Bx = x.shape[0]
    y = check(y, "y", torch.int32, (Bx, K))
    m = check(m, "m", torch.int32, (K,))
    inv = check(inv, "inv", torch.float32, (K,))
    ep = cuda_build.pack_mma(torch.cat([check(mlo, "mlo", torch.int8, (D, K)),
                                        check(mhi, "mhi", torch.int8, (D, K))],
                                       dim=1))
    rows = pick_tile(rows, Bx)
    o, p = torch.empty_like(x), torch.empty_like(y)
    KERNEL.launch("overlap_launch", x.device, x.data_ptr(), ep.data_ptr(),
                  y.data_ptr(), m.data_ptr(), inv.data_ptr(), o.data_ptr(),
                  p.data_ptr(), Bx, steps, MODES.index(mode) + 1, rows,
                  stream(x))
    overlap.launches += 1
    return o, p


overlap.launches = 0


def macs(rows: int, steps: int) -> int:
    """int8 multiply-adds of the dots chain: four [640] x [640, 320]."""
    return rows * steps * 2 * D * D


def vpu_ops(rows: int, steps: int) -> int:
    """Instructions of the vpu chain (at least)."""
    return rows * K * steps * PASSES * VPU_OPS
