#!/usr/bin/env python3
"""Time the launch alternatives of kernels B1, B2, B3 and B4 on one GPU.

    python scripts/ab_sliding.py [--kernel b1|b2|b3|b4] [--rows N,N,...]
                                 [--wide-rows N,N,...]

--kernel b1 (default): builds this tree's B1 and, at k = 320 (e = n,
with fin), k = 192 (e = p - 1), k = 512 (e = n^2) and k = 704 (a
2048-bit e, with fin), runs every tile the launcher takes (8, 16 and, at
k <= 320, 32 rows) on each row count once, then times them in turns with
CUDA events (tiles in order, then in reverse).  Every tile's output must
equal that of the launcher's own pick (rns2_sliding_rows) bit for bit.
--rows are the row counts at k = 192 and 320, --wide-rows those at
k = 512 and 704.  Prints one line per shape: the rule's tile, the
fastest, and each tile's blocks and times.

--kernel b2: the same for B2 (tiles of rns2_modexp_rows) at k = 320 with
per-row 2048-bit exponents (512 digits, const_mult's shape) over --rows,
and at k = 512 with per-row 4096-bit exponents (1,024 digits,
nested_add's shape) over --wide-rows.

--kernel b3: the same for B3 (tiles of rns2_fixed_base_rows): the comb
of a fixed base with 256 per-row digits (r < 2^1024, window 4) and fin,
at k = 320 (alternative encryption at level 1) over --rows and at
k = 512 (level 2) over --wide-rows.

--kernel b4: B4 with every lane count (4 to 32 lanes a row, as the words
allow) in blocks of 64, 128 and 256 threads, with a 2048-bit shared
exponent (512 digits, extract_randomness' exponent) at L = 128 on
--rows and at L = 256 on --wide-rows, and on 64 and 256 per-row 1024-bit
moduli and exponents at L = 64 (the Fermat batch); outputs must equal
the wrapper's own pick (mont_kernel.lanes_per_row, BLOCK_THREADS).
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
from paillier_tpu_torch.bigint import fixed_base_kernel as fb  # noqa: E402
from paillier_tpu_torch.bigint import modexp_kernel as mx  # noqa: E402
from paillier_tpu_torch.bigint import mont_kernel as mk  # noqa: E402
from paillier_tpu_torch.bigint import sliding_kernel as sk  # noqa: E402
from paillier_tpu_torch.bigint.host import ints_to_limbs  # noqa: E402
from paillier_tpu_torch.bigint.montgomery import (  # noqa: E402
    exp_digits, make_mont_ctx, stack_mont_ctx)
from paillier_tpu_torch.bigint.rns2 import (  # noqa: E402
    Rns2Engine, build_fixed_base_table, sliding_window_schedule)


def run_b1(lib, ctx, x, sched, fin, rows):
    """B1 on (ctx, x, sched, fin), window 6, with tiles of ``rows``."""
    B, C = x.shape
    tbl = torch.empty((-(-B // rows) * rows, 32, C), dtype=torch.int16,
                      device=x.device)
    out = torch.empty_like(x)
    ic1, ic2, f1, f2, e1, e2 = cuda_build.context_pointers(ctx)
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


def run_b2(lib, ctx, x, dig, rows):
    """B2 on (ctx, x, per-row digits), window 4, with tiles of ``rows``."""
    B, C = x.shape
    Bp = -(-B // rows) * rows
    dig = torch.nn.functional.pad(dig, (0, 0, 0, Bp - B)).contiguous()
    tbl = torch.empty((Bp, 16, C), dtype=torch.int16, device=x.device)
    out = torch.empty_like(x)
    ic1, ic2, f1, f2, e1, e2 = cuda_build.context_pointers(ctx)
    err = lib.rns2_modexp_launch(
        x.data_ptr(), dig.data_ptr(), dig.shape[1], 1, ic1.data_ptr(),
        ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(), e1.data_ptr(),
        e2.data_ptr(), tbl.data_ptr(), out.data_ptr(), B, ctx.k, 4, rows,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def run_b3(lib, ctx, tbl16, dig, fin, rows):
    """B3 on (ctx, int16 comb table, per-row digits, fin), window 4, with
    tiles of ``rows``."""
    B, D = dig.shape
    dig = torch.nn.functional.pad(dig, (0, 0, 0, -(-B // rows) * rows - B))
    out = torch.empty_like(fin)
    ic1, ic2, f1, f2, e1, e2 = cuda_build.context_pointers(ctx)
    err = lib.rns2_fixed_base_launch(
        tbl16.data_ptr(), dig.contiguous().data_ptr(), D, fin.data_ptr(),
        ic1.data_ptr(), ic2.data_ptr(), f1.data_ptr(), f2.data_ptr(),
        e1.data_ptr(), e2.data_ptr(), out.data_ptr(), B, ctx.k, 4, rows,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def b4_runner(lib, ctx, x, d, tpi, threads):
    """A call of B4 on (ctx, base limbs x, digits d), window 4, with
    ``tpi`` lanes a row in blocks of ``threads`` threads (fewer rows where
    shared memory does not hold them); the operands are prepared as
    mont_kernel.launch prepares them, once, outside the call."""
    B, L = x.shape
    nw = mk.padded_words(-(-L // 2), tpi)
    n, n0, r2, Lk = mk._kernel_ctx(ctx, nw)
    xk = torch.nn.functional.pad(x.to(torch.int32), (0, Lk - L)).contiguous()
    d = d.to(torch.int32).contiguous()
    rb = mk.rows_per_block(lib.limb_modexp_row_bytes(nw, 4), threads // tpi)

    def run():
        out = torch.empty((B, Lk), dtype=torch.int32, device=x.device)
        err = lib.limb_modexp_launch(
            xk.data_ptr(), d.data_ptr(), d.shape[-1], int(d.dim() == 2),
            n.data_ptr(), n0.data_ptr(), r2.data_ptr(),
            int(ctx.n.dim() == 2), out.data_ptr(), B, nw, 4, tpi, rb,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out[:, :L]
    return run


def timed(fn):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def sweep(label, variants, rule):
    """Run every variant once, check each equals variant ``rule``, time
    them in turns (in order, then reversed); print one line."""
    outs = {v: timed(fn)[0] for v, fn in variants.items()}
    for v in variants:
        if not torch.equal(outs[v], outs[rule]):
            raise SystemExit(f"{label}: {v} differs from {rule}")
    ms = {v: [] for v in variants}
    order = list(variants)
    for v in order + order[::-1]:
        ms[v].append(timed(variants[v])[1])
    best = min(order, key=lambda v: max(ms[v]))
    times = "; ".join(f"{v} {min(ms[v]):.3f}-{max(ms[v]):.3f} ms"
                      for v in order)
    print(f"{label}: rule {rule}, fastest {best}; {times}", flush=True)


class Shapes:
    """The moduli and operands every mode draws from (seeded)."""

    def __init__(self, dev):
        self.dev = dev
        self.rng = random.Random(7)
        self.n = self.odd(1024) * self.odd(1024)
        self.p = self.odd(1024)

    def odd(self, bits):
        return self.rng.getrandbits(bits) | 1 << (bits - 1) | 1

    def residues(self, B, k):
        return torch.as_tensor(np.random.default_rng(B).integers(
            0, 10000, size=(B, 2 * k)), dtype=torch.int32, device=self.dev)

    def digits(self, B, bits):
        return torch.as_tensor(np.stack([
            exp_digits(self.rng.getrandbits(bits), 4, bits // 4)
            for _ in range(B)]), device=self.dev)

    def limbs(self, vals, L):
        return torch.as_tensor(ints_to_limbs(vals, L).astype(np.int64),
                               device=self.dev)

    def b2_shapes(self, rows, wide_rows):
        """(label, eng, x, per-row digits) at k = 320 and 512."""
        for label, N, bits, counts in (("k=320 512 digits", self.n ** 2,
                                        2048, rows),
                                       ("k=512 1024 digits", self.n ** 3,
                                        4096, wide_rows)):
            eng = Rns2Engine(N, device=self.dev)
            for B in counts:
                yield (f"B2 {label} rows={B}", eng,
                       self.residues(B, eng.spec.k), self.digits(B, bits))

    def b3_shapes(self, rows, wide_rows):
        """(label, eng, int16 comb table, per-row digits, fin) at k = 320
        and 512: 256 digits of r < 2^1024."""
        for label, N, counts in (("k=320", self.n ** 2, rows),
                                 ("k=512", self.n ** 3, wide_rows)):
            eng = Rns2Engine(N, device=self.dev)
            table = build_fixed_base_table(eng, self.rng.randrange(2, N),
                                           256, 4).to(torch.int16)
            for B in counts:
                yield (f"B3 {label} rows={B} 256 digits fin", eng, table,
                       self.digits(B, 1024).to(torch.int32),
                       self.residues(B, eng.spec.k))

    def b4_shapes(self, rows, wide_rows):
        """(label, ctx, base limbs, digits): a shared 2048-bit exponent at
        L = 128 on each of ``rows`` and at L = 256 on each of
        ``wide_rows``; 64 and 256 per-row 1024-bit moduli at L = 64."""
        e = self.odd(2048)
        d = torch.as_tensor(exp_digits(e, 4, 512), device=self.dev)
        for N, L, counts in ((self.n, 128, rows), (self.n ** 2, 256,
                                                   wide_rows)):
            ctx = make_mont_ctx(N, device=self.dev)
            for B in counts:
                xs = [self.rng.randrange(N) for _ in range(B)]
                yield (f"B4 L={L} rows={B} 512 digits", ctx,
                       self.limbs(xs, L), d)
        for B in (64, 256):
            mods = [self.odd(1024) for _ in range(B)]
            sctx = stack_mont_ctx(mods, 64, device=self.dev)
            xs = [self.rng.randrange(m) for m in mods]
            yield (f"B4 L=64 {B} per-row moduli 256 digits", sctx,
                   self.limbs(xs, 64), self.digits(B, 1024))


def mode_b1(a, sh, dev):
    lib = sk.load()
    mods = [("k=320 e=n fin", sh.n * sh.n, sh.n, True, a.rows, (8, 16, 32)),
            ("k=192 e=p-1", sh.p * sh.p, sh.p - 1, False, a.rows,
             (8, 16, 32)),
            ("k=512 e=n^2", sh.n ** 3, sh.n * sh.n, False, a.wide_rows,
             (8, 16)),
            ("k=704 e=2048-bit fin", sh.odd(8192), sh.odd(2048), True,
             a.wide_rows, (8, 16))]
    for label, N, e, use_fin, row_counts, tiles in mods:
        eng = Rns2Engine(N, device=dev)
        k = eng.spec.k
        sched = sliding_window_schedule(e, 6)
        for B in row_counts:
            x = sh.residues(B, k)
            fin = x.flip(0).contiguous() if use_fin else None
            sweep(f"{label} rows={B}",
                  {R: (lambda R=R: run_b1(lib, eng.ctx, x, sched, fin, R))
                   for R in tiles}, lib.rns2_sliding_rows(B, k))


def mode_b2(a, sh, dev):
    lib = mx.load()
    for label, eng, x, dig in sh.b2_shapes(a.rows, a.wide_rows):
        tiles = (8, 16, 32) if eng.spec.k <= 320 else (8, 16)
        sweep(label, {R: (lambda R=R: run_b2(lib, eng.ctx, x, dig, R))
                      for R in tiles},
              lib.rns2_modexp_rows(x.shape[0], eng.spec.k))


def mode_b3(a, sh, dev):
    lib = fb.load()
    for label, eng, tbl16, dig, fin in sh.b3_shapes(a.rows, a.wide_rows):
        tiles = (8, 16, 32) if eng.spec.k <= 320 else (8, 16)
        sweep(label, {R: (lambda R=R: run_b3(lib, eng.ctx, tbl16, dig, fin,
                                             R))
                      for R in tiles},
              lib.rns2_fixed_base_rows(dig.shape[0], eng.spec.k))


def mode_b4(a, sh, dev):
    lib = mk.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, ctx, x, d in sh.b4_shapes(a.rows, a.wide_rows):
        nw = x.shape[1] // 2
        rule = (mk.lanes_per_row(nw, x.shape[0], sms), mk.BLOCK_THREADS)
        sweep(f"{label} (lanes, threads)",
              {(tpi, threads): b4_runner(lib, ctx, x, d, tpi, threads)
               for tpi in (4, 8, 16, 32)
               if mk.padded_words(nw, tpi) // tpi in mk.WORDS_PER_LANE
               for threads in (64, 128, 256)}, rule)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("b1", "b2", "b3", "b4"),
                    default="b1")
    ap.add_argument("--rows", type=ints, default=None)
    ap.add_argument("--wide-rows", type=ints, default=None)
    a = ap.parse_args()
    a.rows = a.rows or {
        "b1": [512, 1024, 1536, 2048, 2112, 2560, 3072, 4096, 8192],
        "b2": [1024, 1056, 2048, 2112, 3072, 4096, 8192],
        "b3": [1024, 1056, 2048, 2112, 3072, 4096, 8192],
        "b4": [512, 768, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 3584,
               4096, 5120, 6144, 8192]}[a.kernel]
    a.wide_rows = a.wide_rows or (
        [256, 512, 1024, 2048, 4096] if a.kernel == "b4" else
        [256, 512, 1024, 1536, 2048, 4096])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    sh = Shapes(dev)
    {"b1": mode_b1, "b2": mode_b2, "b3": mode_b3,
     "b4": mode_b4}[a.kernel](a, sh, dev)
    print(f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


if __name__ == "__main__":
    main()
