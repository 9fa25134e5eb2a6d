"""The benchmark's frozen roofline arithmetic for the RNS ladders.

Copied from ``paillier_tpu_torch/ops/profiling.py`` (``RooflineModel``'s
RNS operation term and ``CHIPS["h100"]``'s int8 peak) and from
``paillier_tpu_torch/bigint/rns2.py`` (``Rns2Spec``'s first estimate of
the channel count), with the multiply count made exact for the exponent
at hand instead of an expected count.  This file is the yardstick, not
the program: a change to the program does not move it.

One RNS Montgomery multiply of a row at k channels a base runs two int8
base extensions of [2k] x [2k, 2k]: 8 k^2 multiply-adds, 2 operations
each.  The least time of a ladder is its multiplies times that, over the
card's published dense int8 peak.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# NVIDIA H100 SXM5 data sheet: dense int8 tensor-core peak, at 700 W
INT8_PEAK_OPS = 1979e12


def channels(mod_bits: int) -> int:
    """k, the RNS channels a base for a modulus of ``mod_bits`` bits:
    every channel carries at least 13 bits, 64 bits of headroom, rounded
    up to a multiple of 64 (320 for n^2 of a 2048-bit key, 192 for p^2,
    256 for p^3, 512 for n^3)."""
    k = -(-(mod_bits + 64) // 13)
    return -(-k // 64) * 64


def macs_per_mult(k: int) -> int:
    return 8 * k * k


def _sliding(bits: str, w: int) -> int:
    """Montgomery multiplies of the left-to-right sliding-window ladder
    over the odd-power table [x, x^3, .., x^(2^w - 1)] for the exponent
    whose binary digits are ``bits``: the entry into Montgomery form,
    x^2 and the 2^(w-1) - 1 table products, a squaring for each bit past
    the leading window and a product for each later window, the exit."""
    nb = len(bits)
    lead = min(w, nb)
    while bits[lead - 1] != "1":
        lead -= 1
    table = (1 + (1 << (w - 1)) - 1) if w > 1 else 0
    mults = 1 + table + (nb - lead) + 1
    i = lead
    while i < nb:
        if bits[i] == "0":
            i += 1
            continue
        l = min(w, nb - i)
        while bits[i + l - 1] != "1":
            l -= 1
        mults += 1
        i += l
    return mults


@lru_cache(maxsize=256)
def least_mults(e: int) -> int:
    """The fewest Montgomery multiplies a sliding-window ladder needs for
    the exponent ``e`` >= 1, over windows 1 to 8, table and exit
    included (0 for e = 0)."""
    if e == 0:
        return 0
    bits = bin(e)[2:]
    return min(_sliding(bits, w) for w in range(1, 9))


def least_mults_rows(exps) -> np.ndarray:
    """:func:`least_mults` of each exponent of ``exps`` (ints below 2^63),
    vectorised over the rows: the same scan, one bit position at a time
    for all rows together."""
    e = np.asarray(exps, dtype=np.uint64)
    nb = np.zeros(e.shape, dtype=np.int64)
    v = e.copy()
    while v.any():
        nb += v != 0
        v >>= np.uint64(1)
    width = int(nb.max()) if nb.size else 0
    # bit j of row r, most significant first in row r's own width
    pos = np.arange(width)[None, :]
    shift = (nb[:, None] - 1 - pos).clip(min=0).astype(np.uint64)
    bit = ((e[:, None] >> shift) & np.uint64(1)).astype(bool) & \
        (pos < nb[:, None])
    best = np.full(e.shape, np.iinfo(np.int64).max, dtype=np.int64)
    rows = np.arange(e.size)
    for w in range(1, 9):
        table = (1 << (w - 1)) if w > 1 else 0
        # leading window: the longest prefix of at most w bits ending in 1
        lead = np.minimum(w, nb)
        for _ in range(w):
            bad = (lead > 0) & ~bit[rows, (lead - 1).clip(min=0)]
            lead = np.where(bad, lead - 1, lead)
        mults = 1 + table + (nb - lead) + 1
        i = lead.copy()
        while True:
            live = i < nb
            if not live.any():
                break
            at = bit[rows, np.minimum(i, width - 1)] & live
            # a zero bit: one squaring, already counted; step over it
            l = np.minimum(w, nb - i)
            for _ in range(w):
                bad = at & (l > 0) & \
                    ~bit[rows, np.minimum(i + l - 1, width - 1).clip(min=0)]
                l = np.where(bad, l - 1, l)
            mults = mults + at
            i = np.where(at, i + l, np.where(live, i + 1, i))
        best = np.minimum(best, mults)
    return np.where(nb == 0, 0, best)


def least_seconds(k: int, rows: int, mults: int) -> float:
    """The least time of ``mults`` Montgomery multiplies on each of
    ``rows`` rows at ``k`` channels, at the int8 peak."""
    return 2.0 * macs_per_mult(k) * mults * rows / INT8_PEAK_OPS


def item_seconds(item: dict) -> float:
    """The least time of one entry of a run's work list: ``{"kernel":
    "B1" | "B2", "mod_bits": .., "row_mults": ..}``, the multiplies summed
    over the ladder's rows."""
    return least_seconds(channels(item["mod_bits"]), 1, item["row_mults"])
