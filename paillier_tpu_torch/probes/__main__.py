"""Run the probes P1-P5 at the shapes of the scripts they replace.

    python -m paillier_tpu_torch.probes [p1 p2 p3 p4 p5] [--device cpu]
                                        [--steps N]

On the card (the default) each probe's kernel is timed with CUDA events,
the least of three calls after one untimed call, and the card's name and
power limit head the output; ``--device cpu`` runs the plain versions on the host clock.
``--steps`` replaces every probe's step or repetition count (P1, P2:
2,374; P3: 600; P4: 128 and 2,048 in one launch; P5: 2,000).  Each line
gives the probe's time beside its bound, the least work of the probe's
function whatever the kernel's layout: the int8 tensor-core operations
it needs (padding and dropped columns not counted) over 1,979 TOP/s, the
fewest instructions its elementwise ops need over SMs x 128 lanes x 1.98
GHz (``probes.issue_rate``) or the bytes read and written once over 3.35
TB/s, whichever is larger.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from . import HBM, INT8_OPS, TILES, issue_rate, tile_rows
from . import dotchain, dotvar, overlap, pad, vpuops


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def timed(fn, dev, runs: int = 3) -> float:
    """ms of fn(), the least of ``runs`` calls after one untimed call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(runs):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            best = min(best, ev[0].elapsed_time(ev[1]))
        else:
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def bound(ops_s: float, nbytes: int) -> tuple:
    """(ms, "operations" | "bytes"): the larger of the two times."""
    t_bytes = nbytes / HBM
    return (max(ops_s, t_bytes) * 1e3,
            "operations" if ops_s >= t_bytes else "bytes")


def _rec(probe, case, ms, bnd, line, **extra) -> dict:
    return dict(probe=probe, case=case, ms=ms, bound_ms=bnd[0],
                bound_by=bnd[1], line=f"{probe} {line}", **extra)


def run_p1(dev, steps: int | None = None) -> list[dict]:
    """Each layout at the script's 4096 rows, at the tile of B1's rule."""
    steps = steps or dotvar.STEPS
    B = dotvar.B
    a = dotvar.inputs(B, device=dev)
    tile = tile_rows(B) if dev.type == "cuda" else None
    out = []
    for v in dotvar.VARIANTS:
        ms = timed(lambda: dotvar.dotvar(*a, steps, v, rows=tile), dev)
        macs = dotvar.macs(B, steps, v)
        bnd = bound(2 * macs / INT8_OPS, 2 * B * 640 + 640 * 640)
        out.append(_rec("P1", v, ms, bnd, f"{v:7s} {B} rows, tile {tile}, "
                        f"{steps} steps: {ms:9.3f} ms, "
                        f"{ms * 1e3 / steps:7.3f} us a step (bound "
                        f"{bnd[0]:.3f} ms)", rows=B, tile=tile, steps=steps))
    return out


def run_p2(dev, steps: int | None = None) -> list[dict]:
    """The chain at the script's 512 rows and at one block an SM, on each
    tile."""
    steps = steps or dotchain.STEPS
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    out = []
    for tile in TILES:
        for B in (dotchain.B, sms * tile):
            a = dotchain.inputs(B, device=dev)
            ms = timed(lambda: dotchain.dotchain(*a, steps, rows=tile), dev)
            macs = dotchain.macs(B, steps)
            bnd = bound(2 * macs / INT8_OPS, 2 * B * 640 + 640 * 640)
            out.append(_rec("P2", f"{B} rows, tile {tile}", ms, bnd,
                            f"{B} rows, tile {tile}, {steps} steps: "
                            f"{ms:9.3f} ms, {ms * 1e3 / steps:7.3f} us a "
                            f"step (bound {bnd[0]:.3f} ms)", rows=B,
                            tile=tile, steps=steps))
    return out


def run_p3(dev, steps: int | None = None) -> list[dict]:
    """dots, vpu and both at the script's 512 rows, tile of B1's rule."""
    steps = steps or overlap.STEPS
    B = overlap.B
    a = overlap.inputs(B, device=dev)
    tile = tile_rows(B) if dev.type == "cuda" else None
    t_dots = 2 * overlap.macs(B, steps) / INT8_OPS
    t_vpu = overlap.vpu_ops(B, steps) / issue_rate(dev)
    nbytes = 2 * B * 640 + 640 * 640 + 2 * B * 320 * 4
    out, ms = [], {}
    for mode in overlap.MODES:
        ms[mode] = timed(lambda: overlap.overlap(*a, steps, mode, rows=tile),
                         dev)
        bnd = bound({"dots": t_dots, "vpu": t_vpu,
                     "both": max(t_dots, t_vpu)}[mode], nbytes)
        out.append(_rec("P3", mode, ms[mode], bnd,
                        f"{mode:5s} {B} rows, tile {tile}, {steps} steps: "
                        f"{ms[mode]:8.3f} ms (bound {bnd[0]:.3f} ms)",
                        rows=B, tile=tile, steps=steps))
    frac = (ms["dots"] + ms["vpu"] - ms["both"]) / min(ms["dots"], ms["vpu"])
    out[-1]["overlap_frac"] = frac
    out[-1]["line"] += (f"; sum {ms['dots'] + ms['vpu']:.3f}, max "
                        f"{max(ms['dots'], ms['vpu']):.3f}, overlap_frac "
                        f"{frac:.2f}")
    return out


def run_p4(dev, steps: int | None = None) -> list[dict]:
    """Each width at the script's 1024 rows (tile of B1's rule) and at
    4096 rows on every tile, 128 steps in one launch (the script chains
    16 calls of 8 steps on the device; chained launches here would time
    the host), W loaded as B1 loads it and, at 4096 rows, also past L1
    (``l2 only``: bytes over time is then the L2's read rate); then
    roll+add against add-only, 2,048 steps a launch."""
    cuda = dev.type == "cuda"
    psteps = steps or pad.STEPS * 16
    rsteps = steps or pad.ROLL_STEPS * 64
    out = []
    shapes = [(pad.B, tile_rows(pad.B) if cuda else None, False)]
    shapes += [(4096, t, l2) for l2 in (False, True) for t in TILES] \
        if cuda else []
    for lanes in pad.WIDTHS:
        for B, tile, l2 in shapes:
            x, w = pad.inputs(lanes, B, device=dev)
            ms = timed(lambda: pad.pad(x, w, psteps, rows=tile, l2_only=l2),
                       dev)
            macs = pad.macs(B, lanes, psteps)
            bnd = bound(2 * macs / INT8_OPS, pad.io_bytes(B, lanes))
            rate = (pad.l2_bytes(B, tile, lanes, psteps) / (ms * 1e-3) / 1e12
                    if tile else None)
            kind = "L2 reads" if l2 else "asked for, L1 hits included"
            out.append(_rec(
                "P4", f"{lanes} lanes, {B} rows, tile {tile}"
                + (", l2 only" if l2 else ""), ms, bnd,
                f"lanes={lanes} {B} rows, tile {tile}"
                + (", l2 only" if l2 else "") + f": "
                f"{ms * 1e3 / psteps:8.3f} us/dot, "
                + (f"W at {rate:.2f} TB/s ({kind})" if rate else
                   "L2 rate: not measured") + f" (bound {bnd[0]:.4f} ms "
                f"for {psteps} dots)", rows=B, tile=tile, lanes=lanes,
                steps=psteps, l2_only=l2, w_tbs=rate))
    x = pad.roll_input(pad.B, device=dev)
    # fewest instructions a value and step: roll+add's two halves are one
    # value, (a[c] + a[c + 320]) & 0xFFFF, so an add and an and for two
    # values; add-only's (a + a) & 0xFFFF a shift or add and an and
    for permute, name, insns in ((True, "roll+add", 1), (False, "add-only",
                                                          2)):
        ms = timed(lambda: pad.roll(x, rsteps, permute), dev)
        bnd = bound(pad.B * 640 * rsteps * insns / issue_rate(dev),
                    2 * pad.B * 640 * 4)
        out.append(_rec("P4", name, ms, bnd,
                        f"{name}: {ms * 1e3 / rsteps:8.4f} us/step on "
                        f"{pad.B} x 640 (bound {bnd[0]:.4f} ms for "
                        f"{rsteps} steps)", rows=pad.B, steps=rsteps))
    return out


def run_p5(dev, steps: int | None = None) -> list[dict]:
    """Each op class on the script's [4096, 320]."""
    reps = steps or vpuops.REPS
    B = vpuops.B
    x, f = vpuops.inputs(B, device=dev)
    out = []
    for op in vpuops.OPS:
        ms = timed(lambda: vpuops.vpuops(x, f, reps, op), dev)
        bnd = bound(vpuops.ops(B, reps, op) / issue_rate(dev), 3 * B * 320 * 4)
        out.append(_rec("P5", op, ms, bnd,
                        f"{op:8s} {ms:8.3f} ms, "
                        f"{ms * 1e6 / reps:8.1f} ns/pass "
                        f"(bound {bnd[0] * 1e6 / reps:.1f} ns/pass)",
                        rows=B, steps=reps))
    return out


PROBES = {"p1": run_p1, "p2": run_p2, "p3": run_p3, "p4": run_p4,
          "p5": run_p5}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m paillier_tpu_torch.probes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", metavar="p1..p5",
                    help="probes to run (default: all)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    if set(args.probes) - set(PROBES):
        ap.error(f"probes are {', '.join(PROBES)}")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the probes run on the card "
                             "(--device cpu runs the plain versions)")
        print(f"card: {card()}", flush=True)
    else:
        print("device: cpu (plain PyTorch versions, host clock)", flush=True)
    for name in args.probes or PROBES:
        for rec in PROBES[name](dev, args.steps):
            print(rec["line"], flush=True)


if __name__ == "__main__":
    main()
