"""The traced window: ``torch.profiler``'s device events, read in memory.

Only CUDA activity is recorded (a host-side record of every operator
would hold millions of events over a window); the events are read from
the profiler's results without writing a trace file, and kept as arrays
(a name index, start and end in ns on the device's clock).  The host's
spans (``harness.Spans``) are placed on the device's clock by one marker
launched right after the profiler starts, on an idle, synchronised card.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import numpy as np

# device operations that are copies or fills, not kernel launches
_NOT_KERNELS = ("Memcpy", "Memset")


def union(start: np.ndarray, end: np.ndarray) -> tuple:
    """The union of the intervals [start, end) as sorted disjoint
    (starts, ends)."""
    if start.size == 0:
        return start, end
    o = np.argsort(start, kind="stable")
    s, e = start[o], end[o]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:], s.size) - 1
    return s[first], reach[last]


@dataclass
class Trace:
    """The traced window's device events on the device's clock:
    ``names[idx[i]]`` ran from ``start[i]`` to ``end[i]`` (ns)."""

    window_s: float
    names: list
    idx: np.ndarray
    start: np.ndarray
    end: np.ndarray
    breakdown: dict = field(default_factory=dict)

    def _mask(self, patterns=(), kernels_only=True) -> np.ndarray:
        ok = np.array([(not kernels_only or not n.startswith(_NOT_KERNELS))
                       and (not patterns or any(p in n for p in patterns))
                       for n in self.names], dtype=bool)
        return ok[self.idx] if self.idx.size else np.zeros(0, dtype=bool)

    @property
    def launches(self) -> int:
        return int(self._mask().sum())

    def busy_s(self, *patterns: str) -> float:
        """Seconds in which a device operation (of the kernels whose name
        holds one of ``patterns``, when given) ran: the union's length."""
        m = self._mask(patterns, kernels_only=bool(patterns))
        s, e = union(self.start[m], self.end[m])
        return float((e - s).sum()) / 1e9

    def kernel_s(self, *patterns: str) -> float:
        """Summed duration of the kernels whose name holds one of
        ``patterns`` (every kernel when none is given)."""
        m = self._mask(patterns)
        return float((self.end[m] - self.start[m]).sum()) / 1e9


class Tracer:
    """Start and stop ``torch.profiler`` around a window on ``device``."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.prof = None

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.marker_ns = time.perf_counter_ns()
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize(self.device)
        self.start_ns = time.perf_counter_ns()

    def stop(self, spans=None, top: int = 10):
        """The window's :class:`Trace`, or None where the profiler saw
        no device operation."""
        torch = self.torch
        torch.cuda.synchronize(self.device)
        end_ns = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)
        names: dict = {}
        rows = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            k = names.setdefault(e.name(), len(names))
            rows.append((k, e.start_ns(), e.start_ns() + e.duration_ns()))
        self.prof = None
        if not rows:
            return None
        arr = np.array(rows, dtype=np.int64)
        arr = arr[np.argsort(arr[:, 1], kind="stable")]
        # the marker's fill is the first device event: it sets the clocks
        offset = int(arr[0, 1]) - self.marker_ns
        lo, hi = self.start_ns + offset, end_ns + offset
        arr = arr[2:]
        arr = arr[(arr[:, 2] > lo) & (arr[:, 1] < hi)]
        tr = Trace(window_s=(end_ns - self.start_ns) / 1e9,
                   names=list(names), idx=arr[:, 0], start=arr[:, 1],
                   end=arr[:, 2])
        tr.breakdown = {"device_ops": _top_ops(tr, top),
                        "idle_gaps": _gaps(tr, lo, hi, offset, spans, top)}
        return tr


def _short(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _top_ops(tr: Trace, top: int) -> list:
    per_name = np.bincount(tr.idx, weights=(tr.end - tr.start),
                           minlength=len(tr.names))
    tot: dict = {}
    for name, ns in zip(tr.names, per_name):
        k = _short(name)
        tot[k] = tot.get(k, 0.0) + float(ns)
    return [[k, v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top] if v > 0]


def _gaps(tr: Trace, lo: int, hi: int, offset: int, spans, top: int) -> list:
    """Idle time of the window summed by what the host was doing: the
    innermost harness span open at each gap's middle ("between
    requests" outside every span)."""
    s, e = union(tr.start, tr.end)
    starts = np.append(s, hi)
    prev = np.maximum(np.insert(e, 0, lo), lo)
    gap = starts - prev
    keep = gap > 0
    mids = ((starts + prev) // 2 - offset)[keep]
    gaps = gap[keep]
    items = sorted(spans.items, key=lambda x: x[1]) if spans else []
    opens = [x[1] for x in items]
    tot: dict = {}
    for mid, g in zip(mids.tolist(), gaps.tolist()):
        label = "between requests"
        # the latest-opened span still open at mid is the innermost
        for name, s0, s1 in reversed(items[:bisect.bisect_right(opens,
                                                                mid)]):
            if s1 >= mid:
                label = name
                break
        tot[label] = tot.get(label, 0) + g
    return [[k, v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
