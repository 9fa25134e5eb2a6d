"""Every variant of P1-P5 as one list of cases, each run on its kernel and
on its plain version at a few steps: the comparison that ``chip_smoke.py``
(phase 9) and the GPU tests make bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import dotchain, dotvar, overlap, pad, vpuops


@dataclass(frozen=True)
class Case:
    probe: str            # "P1" .. "P5"
    case: object          # variant, mode, width, "roll" / "add-only" or op
    wrapper: Callable     # the wrapper that launches the kernel (its
                          # ``launches`` counts)
    tiled: bool           # the kernel takes a tile of 8, 16 or 32 rows
    make: Callable        # (rows, device) -> inputs
    kernel: Callable      # (inputs, steps, tile) -> [outputs]
    plain: Callable       # (inputs, steps) -> [outputs]

    @property
    def key(self) -> str:
        """The probe, with P4's roll apart from its products."""
        return "P4 roll" if self.wrapper is pad.roll else self.probe

    def run(self, rows: int, tile, device, steps: int = 3) -> tuple:
        """(kernel outputs, plain outputs) on ``rows`` rows of the probe's
        inputs on ``device``; ``tile`` None: the rule's (tiled cases)."""
        a = self.make(rows, device)
        return self.kernel(a, steps, tile), self.plain(a, steps)


def _cases() -> list[Case]:
    out = []
    for v in dotvar.VARIANTS:
        out.append(Case(
            "P1", v, dotvar.dotvar, True,
            lambda r, d: dotvar.inputs(r, device=d),
            lambda a, s, t, v=v: [dotvar.dotvar(*a, s, v, rows=t)],
            lambda a, s, v=v: [dotvar.dotvar_plain(*a, s, v)]))
    out.append(Case(
        "P2", "chain", dotchain.dotchain, True,
        lambda r, d: dotchain.inputs(r, device=d),
        lambda a, s, t: [dotchain.dotchain(*a, s, rows=t)],
        lambda a, s: [dotchain.dotchain_plain(*a, s)]))
    for m in overlap.MODES:
        out.append(Case(
            "P3", m, overlap.overlap, True,
            lambda r, d: overlap.inputs(r, device=d),
            lambda a, s, t, m=m: list(overlap.overlap(*a, s, m, rows=t)),
            lambda a, s, m=m: list(overlap.overlap_plain(*a, s, m))))
    for l2 in (False, True):
        for w in pad.WIDTHS:
            out.append(Case(
                "P4", f"{w} l2 only" if l2 else w, pad.pad, True,
                lambda r, d, w=w: pad.inputs(w, r, device=d),
                lambda a, s, t, l2=l2: [pad.pad(*a, s, rows=t, l2_only=l2)],
                lambda a, s: [pad.pad_plain(*a, s)]))
    for name in ("roll", "add-only"):
        perm = name == "roll"
        out.append(Case(
            "P4", name, pad.roll, False,
            lambda r, d: (pad.roll_input(r, device=d),),
            lambda a, s, t, p=perm: [pad.roll(*a, s, p)],
            lambda a, s, p=perm: [pad.roll_plain(*a, s, p)]))
    for op in vpuops.OPS:
        out.append(Case(
            "P5", op, vpuops.vpuops, False,
            lambda r, d: vpuops.inputs(r, device=d),
            lambda a, s, t, op=op: [vpuops.vpuops(*a, s, op)],
            lambda a, s, op=op: [vpuops.vpuops_plain(*a, s, op)]))
    return out


CASES = _cases()
