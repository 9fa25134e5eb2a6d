"""Probe P1: what each product layout of a Montgomery multiply's
extensions costs.

Replaces ``scripts/perf_dotvar.py:mk_kernel`` (its ``pl.pallas_call`` at
:91).  ``steps`` steps on x int8 [B, 640] of ``v = (lo + (hi << 7)) &
127``, ``x = int8(concat(v, v))`` with lo = x @ mlo, hi = x @ mhi summed
over the layout's products:

  split4  four products [640, 320]: lo, hi, lo, hi
  gap2    two products with the padded [640, 768] (mlo | 64 zeros | mhi |
          64 zeros), sliced at 384
  fused2  two products with [mlo | mhi] [640, 640], hi brought to lo's
          columns by a roll of 320
  wide1   one product with the padded [640, 768] (half the products)

split4, gap2 and fused2 compute one function.  On the H100
(``csrc/probe_dotvar.cu``) fused2 is kernel B1's base extension (lo and
hi of a channel in one lane, so no roll), split4 walks one half a pass,
and gap2 / wide1 multiply the 64 zero columns too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bigint import cuda_build
from ..bigint.limbmm import _dot_i8
from . import (CI, D, K, VP, Kernel, chain_draws, check, on_cuda, pick_tile,
               stream)

SCRIPT = "scripts/perf_dotvar.py:32"     # mk_kernel
B = 4096
STEPS = 2374
VARIANTS = ("split4", "gap2", "fused2", "wide1")
GAP = 768          # columns of the padded matrix (lo at 0, hi at 384)

KERNEL = Kernel("dotvar", {"dotvar_launch": [VP, VP, VP, VP, CI, CI, CI, CI,
                                             VP]})
# every instantiation's loop holds the tensor-core product (IMMA)
SASS_EXPECT = {r"dotvar_kernel": [(r"IMMA", 1)]}


def inputs(rows: int = B, seed: int = 0, device="cpu") -> tuple:
    """(x, mlo, mhi) as the script draws them: int8 in [0, 100)."""
    return tuple(torch.as_tensor(a, device=device) for a in
                 chain_draws(np.random.default_rng(seed), rows))


def gap_matrix(mlo, mhi) -> torch.Tensor:
    """The padded [640, 768]: mlo at columns 0..319, mhi at 384..703."""
    gap = torch.zeros((D, GAP), dtype=torch.int8, device=mlo.device)
    gap[:, :K] = mlo
    gap[:, GAP // 2:GAP // 2 + K] = mhi
    return gap


def dotvar_plain(x, mlo, mhi, steps: int, variant: str) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    gap, fus = gap_matrix(mlo, mhi), torch.cat([mlo, mhi], dim=1)
    h = GAP // 2
    for _ in range(steps):
        if variant == "split4":
            v = _dot_i8(x, mlo) + (_dot_i8(x, mhi) << 7)
            v = v + _dot_i8(x, mlo) + (_dot_i8(x, mhi) << 7)
        elif variant == "fused2":
            v = 0
            for _ in range(2):
                P = _dot_i8(x, fus)
                v = v + (P + (torch.roll(P, K, 1) << 7))[:, :K]
        else:
            v = 0
            for _ in range(2 if variant == "gap2" else 1):
                P = _dot_i8(x, gap)
                v = v + (P[:, :h] + (P[:, h:] << 7))[:, :K]
        v = v & 127
        x = torch.cat([v, v], dim=-1).to(torch.int8)
    return x


def dotvar(x, mlo, mhi, steps: int, variant: str, rows: int | None = None
           ) -> torch.Tensor:
    """The layout's chain on x int8 [B, 640] with mlo, mhi int8 [640, 320].
    A CPU tensor runs :func:`dotvar_plain`; a CUDA tensor launches the
    kernel in tiles of ``rows`` rows (8, 16 or 32; default: B1's rule)
    and adds one to ``dotvar.launches``."""
    if not on_cuda(x, "P1"):
        return dotvar_plain(x, mlo, mhi, steps, variant)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    x = check(x, "x", torch.int8, (None, D))
    mlo = check(mlo, "mlo", torch.int8, (D, K))
    mhi = check(mhi, "mhi", torch.int8, (D, K))
    mat = (torch.cat([mlo, mhi], dim=1) if variant in ("split4", "fused2")
           else gap_matrix(mlo, mhi))
    ep = cuda_build.pack_mma(mat)
    rows = pick_tile(rows, x.shape[0])
    out = torch.empty_like(x)
    KERNEL.launch("dotvar_launch", x.device, x.data_ptr(), ep.data_ptr(),
                  out.data_ptr(), None, x.shape[0], steps,
                  VARIANTS.index(variant), rows, stream(x))
    dotvar.launches += 1
    return out


dotvar.launches = 0


def macs(rows: int, steps: int, variant: str) -> int:
    """int8 multiply-adds the variant's function needs, whatever its
    layout: two [640] x [640, 640] products a row and step (split4, gap2
    and fused2 compute one function), one for wide1.  The padding columns
    of gap2 and wide1 are not counted.  The two products of a step repeat
    one product (the script's stand-in for the two distinct extensions of
    a Montgomery multiply), and both are counted, as in B1's bound."""
    return rows * steps * D * D * (1 if variant == "wide1" else 2)
