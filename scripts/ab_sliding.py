#!/usr/bin/env python3
"""Time each tile of kernel B1 (csrc/rns2_sliding.cu) on one GPU.

    python scripts/ab_sliding.py [--rows N,N,...] [--wide-rows N,N,...]

Builds this tree's B1 and, at k = 320 (e = n, with fin), k = 192
(e = p - 1), k = 512 (e = n^2) and k = 704 (a 2048-bit e, with fin),
runs every tile the launcher takes (8, 16 and, at k <= 320, 32 rows) on
each row count once, then times them in turns with CUDA events (tiles in
order, then in reverse).  Every tile's output must equal that of the
launcher's own pick (rns2_sliding_rows) bit for bit.  --rows are the row
counts at k = 192 and 320, --wide-rows those at k = 512 and 704.  Prints
one line per shape: the rule's tile, the fastest, and each tile's blocks
and times.
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from paillier_tpu_torch.bigint import cuda_build  # noqa: E402
from paillier_tpu_torch.bigint import sliding_kernel as sk  # noqa: E402
from paillier_tpu_torch.bigint.rns2 import (Rns2Engine,  # noqa: E402
                                            sliding_window_schedule)


def run_b1(lib, ctx, x, sched, fin, rows):
    """B1 on (ctx, x, sched, fin), window 6, with tiles of ``rows``."""
    B, C = x.shape
    tbl = torch.empty((-(-B // rows) * rows, 32, C), dtype=torch.int16,
                      device=x.device)
    out = torch.empty_like(x)
    ic1, ic2, f1, f2, e1, e2 = cuda_build.context_pointers(
        ctx, cuda_build.pack_mma)
    st = torch.as_tensor(np.asarray(sched, dtype=np.int32), device=x.device)
    err = lib.rns2_sliding_launch(
        x.data_ptr(), fin.data_ptr() if fin is not None else None,
        st.data_ptr(), st.numel() - 1, ic1.data_ptr(), ic2.data_ptr(),
        f1.data_ptr(), f2.data_ptr(), e1.data_ptr(), e2.data_ptr(),
        tbl.data_ptr(), out.data_ptr(), B, ctx.k, 6, rows,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def timed(fn):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=ints,
                    default=[512, 1024, 1536, 2048, 2112, 2560, 3072, 4096,
                             8192])
    ap.add_argument("--wide-rows", type=ints,
                    default=[256, 512, 1024, 1536, 2048, 4096])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    lib = sk.load()
    dev = torch.device("cuda")
    rng = random.Random(7)

    def odd(bits):
        return rng.getrandbits(bits) | 1 << (bits - 1) | 1

    n, p = odd(1024) * odd(1024), odd(1024)
    mods = [("k=320 e=n fin", n * n, n, True, a.rows, (8, 16, 32)),
            ("k=192 e=p-1", p * p, p - 1, False, a.rows, (8, 16, 32)),
            ("k=512 e=n^2", n ** 3, n * n, False, a.wide_rows, (8, 16)),
            ("k=704 e=2048-bit fin", odd(8192), odd(2048), True,
             a.wide_rows, (8, 16))]
    for label, N, e, use_fin, row_counts, tiles in mods:
        eng = Rns2Engine(N, device=dev)
        k = eng.spec.k
        sched = sliding_window_schedule(e, 6)
        for B in row_counts:
            x = torch.as_tensor(np.random.default_rng(B).integers(
                0, 10000, size=(B, 2 * k)), dtype=torch.int32, device=dev)
            fin = x.flip(0).contiguous() if use_fin else None
            rule = lib.rns2_sliding_rows(B, k)

            def fn(R):
                return lambda: run_b1(lib, eng.ctx, x, sched, fin, R)

            outs = {R: timed(fn(R))[0] for R in tiles}
            for R in tiles:
                if not torch.equal(outs[R], outs[rule]):
                    raise SystemExit(f"{label} rows={B}: tile {R} differs "
                                     f"from tile {rule}")
            ms = {R: [] for R in tiles}
            for R in tiles + tiles[::-1]:
                ms[R].append(timed(fn(R))[1])
            best = min(tiles, key=lambda R: max(ms[R]))
            times = "; ".join(f"{R} rows ({-(-B // R)} blocks) "
                              f"{min(ms[R]):.3f}-{max(ms[R]):.3f} ms"
                              for R in tiles)
            print(f"{label} rows={B}: rule {rule}, fastest {best}; {times}",
                  flush=True)
    print(f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


if __name__ == "__main__":
    main()
