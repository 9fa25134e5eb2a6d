"""Probe P2: the latency of a dependent chain of int8 products.

Replaces ``scripts/perf_dotchain.py:kernel`` (its ``pl.pallas_call`` at
:47).  ``steps`` steps, each two dependent extensions of x int8
[B, 640]: ``v = (x @ mlo + x @ mhi) & 127``, ``x = int8(concat(v, v))``.
On the H100 (``csrc/probe_dotchain.cu``) an extension is one pass of B1's
fragment code over the packed ``[mlo | mhi]``; at one block an SM
(132 x R rows) the time per step is the chain's latency.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bigint import cuda_build
from ..bigint.limbmm import _dot_i8
from . import (CI, D, K, VP, Kernel, chain_draws, check, on_cuda, pick_tile,
               stream)

SCRIPT = "scripts/perf_dotchain.py:20"   # kernel
B = 512            # the script's default batch
STEPS = 2374       # the Montgomery multiplies of one 2048-bit encryption

KERNEL = Kernel("dotchain", {"dotchain_launch": [VP, VP, VP, CI, CI, CI, VP]})
# every instantiation's loop holds the tensor-core product (IMMA)
SASS_EXPECT = {r"dotchain_kernel": [(r"IMMA", 1)]}


def inputs(rows: int = B, seed: int = 0, device="cpu") -> tuple:
    """(x, mlo, mhi) as the script draws them: int8 in [0, 100)."""
    return tuple(torch.as_tensor(a, device=device) for a in
                 chain_draws(np.random.default_rng(seed), rows))


def dotchain_plain(x, mlo, mhi, steps: int) -> torch.Tensor:
    for _ in range(2 * steps):
        v = (_dot_i8(x, mlo) + _dot_i8(x, mhi)) & 127
        x = torch.cat([v, v], dim=-1).to(torch.int8)
    return x


def dotchain(x, mlo, mhi, steps: int, rows: int | None = None
             ) -> torch.Tensor:
    """The chain on x int8 [B, 640] with mlo, mhi int8 [640, 320].  A CPU
    tensor runs :func:`dotchain_plain`; a CUDA tensor launches the kernel
    in tiles of ``rows`` rows (8, 16 or 32; default: B1's rule) and adds
    one to ``dotchain.launches``."""
    if not on_cuda(x, "P2"):
        return dotchain_plain(x, mlo, mhi, steps)
    x = check(x, "x", torch.int8, (None, D))
    ep = cuda_build.pack_mma(torch.cat([check(mlo, "mlo", torch.int8, (D, K)),
                                        check(mhi, "mhi", torch.int8, (D, K))],
                                       dim=1))
    rows = pick_tile(rows, x.shape[0])
    out = torch.empty_like(x)
    KERNEL.launch("dotchain_launch", x.device, x.data_ptr(), ep.data_ptr(),
                  out.data_ptr(), x.shape[0], steps, rows, stream(x))
    dotchain.launches += 1
    return out


dotchain.launches = 0


def macs(rows: int, steps: int) -> int:
    """int8 multiply-adds: two [640] x [640, 640] extensions a step."""
    return rows * steps * 2 * D * D
