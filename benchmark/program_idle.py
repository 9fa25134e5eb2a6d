"""The card's idle time in a traced window, split by the stage of the
program that was running on the host meanwhile.

The program records spans at its layer boundaries while a
``torch.profiler`` records (``paillier_tpu_torch.ops.profiling``): a root
span around each API call (encrypt, decrypt, const_mult, aggregate, add,
partial, combine, prove, verify) and, inside them, encode, decode,
host_int, ladder, hash and gather.  ``profiling.take()`` hands them over
with an anchor that puts them on the clock of the profiler's device
events.  Each gap in the union of the window's device operations (the
union ``device_idle_pct`` reads) is split by the innermost span open on
the host at each instant: the latest opened of those still open, over
all threads.  A root span that is itself the innermost counts as
``glue``.  On four cards rank 0's record is read, as rank 0's trace is.
A program without the recorder gives no record: the readers return None.
"""

from __future__ import annotations

import heapq

import numpy as np

from benchmark.traces import union

ROOTS = frozenset(("encrypt", "decrypt", "const_mult", "aggregate", "add",
                   "partial", "combine", "prove", "verify"))
OUTSIDE = "outside every span"

_taken: tuple = (None, None)          # (run, its record): taken once a run
_split: tuple = (None, None)          # (run, its split)


def stage(name: str) -> str:
    """The stage a span's name counts under."""
    return "glue" if name in ROOTS else name


def rank0(record: dict) -> dict:
    """Rank 0's record: the one a run of ranks brought back, else the
    process's own."""
    for r in record.get("ranks", []):
        if r["rank"] == 0:
            return r
    return record


def record(run):
    """Rank 0's span record of ``run``'s traced window, or None where the
    program has no recorder or recorded nothing.  Taken from the program
    once a run; the readers of one run share it."""
    global _taken
    if _taken[0] is not run:
        rec = None
        try:
            from paillier_tpu_torch.ops import profiling
            take = getattr(profiling, "take", None)
        except ImportError:
            take = None
        if take is not None:
            rec = rank0(take())
            if rec["anchor_ns"] is None or not rec["spans"]:
                rec = None
        _taken = (run, rec)
    return _taken[1]


def segments(spans: list, anchor: int, lo: int, hi: int) -> list:
    """[(start, end, stage)] on the device clock, partitioning [lo, hi):
    each piece labelled by the innermost span open over it (the latest
    opened; a later span in the list at the same time), or
    :data:`OUTSIDE`."""
    events = []
    for i, s in enumerate(spans):
        a = min(max(s["start_ns"] + anchor, lo), hi)
        b = min(max(s["end_ns"] + anchor, lo), hi)
        if b > a:
            events.append((a, 1, i))
            events.append((b, 0, i))
    events.sort()
    out, heap, live = [], [], set()
    prev, k = lo, 0
    while k <= len(events):
        t = events[k][0] if k < len(events) else hi
        while heap and heap[0][2] not in live:
            heapq.heappop(heap)
        if t > prev:
            label = stage(spans[heap[0][2]]["name"]) if heap else OUTSIDE
            out.append((prev, t, label))
            prev = t
        if k == len(events):
            break
        while k < len(events) and events[k][0] == t:
            _, opens, i = events[k]
            if opens:
                live.add(i)
                heapq.heappush(heap, (-events[k][0], -i, i))
            else:
                live.discard(i)
            k += 1
    return out


def _busy_before(s: np.ndarray, e: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy ns of the disjoint sorted intervals (s, e) before each t."""
    cum = np.concatenate([[0], np.cumsum(e - s)])
    idx = np.searchsorted(s, t, side="right") - 1
    j = np.maximum(idx, 0)
    part = np.clip(t - s[j], 0, e[j] - s[j]) if s.size else 0 * t
    return np.where(idx >= 0, cum[j] + part, 0)


def split(trace, rec: dict, lo: int | None = None,
          hi: int | None = None) -> dict:
    """{stage: idle ns} of ``trace`` by the innermost span of ``rec``
    open on the host, over [lo, hi) (default: from the first to the last
    span or device operation); the idle time where no span was open is
    under :data:`OUTSIDE`."""
    anchor = rec["anchor_ns"]
    s, e = union(trace.start, trace.end)
    s, e = s.astype(np.int64), e.astype(np.int64)
    if lo is None or hi is None:
        ends = [x["start_ns"] + anchor for x in rec["spans"]]
        ends += [x["end_ns"] + anchor for x in rec["spans"]]
        if s.size:
            ends += [int(s[0]), int(e[-1])]
        lo = min(ends) if lo is None else lo
        hi = max(ends) if hi is None else hi
    segs = segments(rec["spans"], anchor, lo, hi)
    if not segs:
        return {}
    a = np.array([x[0] for x in segs], dtype=np.int64)
    b = np.array([x[1] for x in segs], dtype=np.int64)
    idle = (b - a) - (_busy_before(s, e, b) - _busy_before(s, e, a))
    out: dict = {}
    for (_, _, label), ns in zip(segs, idle.tolist()):
        out[label] = out.get(label, 0) + ns
    return out


def idle_ms(run, name: str):
    """Device-idle milliseconds a request of ``run``'s window during which
    stage ``name`` was the innermost open span on rank 0's host; None
    without a trace or a record."""
    global _split
    if run.trace is None or not run.latencies:
        return None
    rec = record(run)
    if rec is None:
        return None
    if _split[0] is not run:
        _split = (run, split(run.trace, rec))
    return _split[1].get(name, 0) / 1e6 / len(run.latencies)
