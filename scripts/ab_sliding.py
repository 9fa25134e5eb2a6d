#!/usr/bin/env python3
"""Time the launch alternatives of kernels B1, B2, B3, B4 and B4w on one GPU.

    python scripts/ab_sliding.py [--kernel b1|b2|b3|b4|b4w] [--rows N,N,...]
                                 [--wide-rows N,N,...] [--trees A B]

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

--kernel b4w: the B4 / B4w rule and B4w's launch shapes.  On a shared
32-digit exponent (177 Montgomery products a row) at L = 256 and 512 on
5, 16, 64, 256 and 1,024 rows, at L = 768 on 16, 64, 256 and 1,024, at
L = 128 on 4,096, and at B4w's own widths (L = 1,024 and 1,536 on 16
and 64 rows), times B4 (its own lane rule) beside B4w at every launch
shape of a grid (warps a block, blocks a cluster); every
output must equal the pick of mont_kernel.variant and wide_shape, which
is printed beside the fastest.  With --trees A B (two checkouts, e.g.
`git archive`s of two commits), then times in each tree, in turns (A,
B, B, A), in a process of its own that imports that tree's package:
mont_pow_b4w at L = 1,024 and 1,536 on 64 rows x 32 digits, and an
8192-bit key's (primes from keygen(8192, random.Random(8192)), found
once here) level-1 and level-2 encrypt and decrypt on 16 rows.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the package of this checkout, or (--trees) of the tree a run is given
ROOT = Path(os.environ.get("AB_TREE") or Path(__file__).resolve().parents[1])
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


def b4w_runner(lib, ctx, x, d, shape):
    """A call of B4w on (ctx, base limbs x, digits d), window 4, at launch
    shape (warps a block, blocks a cluster); the operands are prepared as
    mont_kernel.launch_wide prepares them, once, outside the call."""
    B, L = x.shape
    nw = mk.wide_words(L)
    mode = mk.wide_mode(nw, 4)
    n, nprime, r2 = mk._wide_ctx(ctx, nw)
    xk = torch.nn.functional.pad(x.to(torch.int32), (0, 2 * nw - L)
                                 ).contiguous()
    d = d.to(torch.int32).contiguous()
    scratch = torch.empty((B, mk.wide_scratch_words(nw, 4, mode)) if mode
                          else (0,), dtype=torch.int32, device=x.device)
    warps, cluster = shape

    def run():
        out = torch.empty((B, 2 * nw), dtype=torch.int32, device=x.device)
        err = lib.limb_modexp_wide_launch(
            xk.data_ptr(), d.data_ptr(), d.shape[-1], int(d.dim() == 2),
            n.data_ptr(), nprime.data_ptr(), r2.data_ptr(),
            int(ctx.n.dim() == 2), out.data_ptr(), B, nw, 4, warps,
            cluster, mode, scratch.data_ptr() if mode else None,
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


# B4w's launch shapes timed by --kernel b4w: warps a block under every
# cluster size, and the warps that give one column pair a thread
B4W_WARPS = (4, 8, 16, 24, 32)
B4W_SHAPES = ([(256, r) for r in (5, 16, 64, 256, 1024)]
              + [(512, r) for r in (5, 16, 64, 256, 1024)]
              + [(768, r) for r in (16, 64, 256, 1024)] + [(128, 4096)]
              + [(L, r) for L in (1024, 1536) for r in (16, 64)]
              + [(5824, 2)])


def mode_b4w(a, sh, dev):
    lib4, libw = mk.load(), mk.load_wide()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for L, B in B4W_SHAPES:
        N = sh.odd(16 * L)
        ctx = make_mont_ctx(N, device=dev)
        x = sh.limbs([sh.rng.randrange(N) for _ in range(B)], L)
        d = torch.as_tensor(exp_digits(sh.odd(128), 4, 32), device=dev)
        nw = mk.wide_words(L)
        variants = {}
        if L <= mk.REGISTER_MAX_LIMBS:
            variants["B4"] = b4_runner(lib4, ctx, x, d, mk.lanes_per_row(
                -(-L // 2), B, sms), mk.BLOCK_THREADS)
        for c in mk.WIDE_CLUSTERS:
            if c > 1 and (B * c > 4 * sms or mk.wide_mode(nw, 4) == 2):
                continue
            ws = set(B4W_WARPS) | {min(32, -(-nw // (32 * c)))}
            for warps in sorted(ws):
                if 32 * warps * c <= 2 * nw:
                    variants[("B4w", warps, c)] = b4w_runner(
                        libw, ctx, x, d, (warps, c))
        rule = mk.variant(L, B, sms)
        if rule == "B4w":
            rule = ("B4w",) + mk.wide_shape(nw, B, sms)
            if rule not in variants:
                variants[rule] = b4w_runner(libw, ctx, x, d, rule[1:])
        sweep(f"L={L} rows={B} 32 digits (B4 | B4w warps, cluster)",
              variants, rule)


def tree_run() -> None:
    """One --trees run, in the tree's own process (AB_TREE): prints one
    JSON line of ms.  Uses only names that every version of the port
    with kernel B4w has (mont_pow_b4w, the package root's key classes),
    so that two commits compare."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch.ops import random as prand
    dev = torch.device("cuda")
    args = json.loads(os.environ["AB_TREE_ARGS"])
    rng = random.Random(13)
    out = {}

    def ev_ms(fn, reps=3):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    for L in (1024, 1536):
        N = rng.getrandbits(16 * L) | 1 << (16 * L - 1) | 1
        ctx = make_mont_ctx(N, device=dev)
        x = torch.as_tensor(ints_to_limbs(
            [rng.randrange(N) for _ in range(64)], L).astype(np.int64),
            device=dev)
        d = torch.as_tensor(exp_digits(rng.getrandbits(128) | 1 << 127, 4,
                                       32), device=dev)
        out[f"B4w L={L} rows=64 32 digits"] = ev_ms(
            lambda: mk.mont_pow_b4w(ctx, x, d, 4))
    p, q = args["p"], args["q"]
    n = p * q
    sk_ = pt.SecretKey(n=n, g=n + 1, h=prand.random_qr_generator(
        n, random.Random(8192)), k=1 << 4096, bits=8192,
        lam=(p - 1) * (q - 1), p=p, q=q)
    for lv in (1, 2):
        enc = pt.Encryptor(sk_, lv, device=dev, rng=random.Random(lv))
        dec = pt.Decryptor(sk_, lv, device=dev)
        ms = [rng.randrange(n ** lv) for _ in range(16)]
        ct = enc.encrypt(ms)                     # the host plans, warm
        assert dec.decrypt(ct) == ms
        for name, fn in (("encrypt", lambda: enc.encrypt(ms)),
                         ("decrypt", lambda: dec.decrypt(ct))):
            t = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append(1e3 * (time.perf_counter() - t0))
            out[f"8192-bit L{lv} {name} 16 rows"] = min(t)
    print(json.dumps(out), flush=True)


def mode_trees(trees) -> None:
    """--trees A B: tree_run in A, B, B, A; one line a run and a table."""
    import paillier_tpu_torch as pt
    t0 = time.perf_counter()
    sk_, _ = pt.keygen(8192, random.Random(8192), device="cpu")
    print(f"keygen(8192) primes on the host: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    env = dict(os.environ, AB_TREE_ARGS=json.dumps({"p": sk_.p, "q": sk_.q}))
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        tree = str(Path(tree).resolve())
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel",
             "tree-run"], cwd=tree, env=dict(env, AB_TREE=tree),
            capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            raise SystemExit(f"{tree}: {proc.stdout}{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((tree, rec))
        print(f"{tree}: " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in rec.items()), flush=True)
    for key in runs[0][1]:
        print(f"{key}: " + "; ".join(
            f"{Path(t).name} {min(r[key] for tt, r in runs if tt == t):.3f}-"
            f"{max(r[key] for tt, r in runs if tt == t):.3f} ms"
            for t in dict.fromkeys(t for t, _ in runs)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("b1", "b2", "b3", "b4", "b4w",
                                         "tree-run"), default="b1")
    ap.add_argument("--rows", type=ints, default=None)
    ap.add_argument("--wide-rows", type=ints, default=None)
    ap.add_argument("--trees", nargs=2, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if a.kernel == "tree-run":
        return tree_run()
    a.rows = a.rows or {
        "b1": [512, 1024, 1536, 2048, 2112, 2560, 3072, 4096, 8192],
        "b2": [1024, 1056, 2048, 2112, 3072, 4096, 8192],
        "b3": [1024, 1056, 2048, 2112, 3072, 4096, 8192],
        "b4": [512, 768, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 3584,
               4096, 5120, 6144, 8192], "b4w": []}[a.kernel]
    a.wide_rows = a.wide_rows or (
        [256, 512, 1024, 2048, 4096] if a.kernel == "b4" else
        [256, 512, 1024, 1536, 2048, 4096])
    dev = torch.device("cuda")
    sh = Shapes(dev)
    {"b1": mode_b1, "b2": mode_b2, "b3": mode_b3, "b4": mode_b4,
     "b4w": mode_b4w}[a.kernel](a, sh, dev)
    if a.trees:
        mode_trees(a.trees)
    print(f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


if __name__ == "__main__":
    main()
