"""Profiling and roofline accounting for the ladders on an NVIDIA card.

The port of ``paillier_tpu.ops.profiling`` for the H100:

* :func:`trace`: context manager around ``torch.profiler`` (CPU and CUDA
  activity) that writes a Chrome trace (``trace.json``, loadable in
  Perfetto or ``chrome://tracing``) of whatever runs inside it into
  ``logdir``, and yields the profiler.
* :func:`span`, :func:`take`: the port's own stages (API calls, encode /
  decode, host big-integer work, the ladders' launch wrappers, the hash,
  the gathers), recorded while a ``torch.profiler`` records in this
  process and placed on the clock of its device events; :func:`trace`
  writes them beside the kernels.  :func:`count` keeps the program's own
  counters (rows of share proofs verified, servers dropped), which
  :func:`take` reports beside the kernels' launch counters.
* :class:`RooflineModel`: the least time the card could take for one
  batched modular exponentiation, the larger of its operation term and
  its bytes term, so that a measured time can be quoted as a share of
  it.  The operation term is the int8 tensor-core issue of the RNS
  ladders (kernels B1-B3: two base extensions of [2k] x [2k, 2k] a row
  and Montgomery multiply, 8 k^2 multiply-adds) or the INT32 multiply
  issue of the limb ladder (kernel B4: 2 nw^2 + nw 32 x 32 -> 64
  multiply-adds a product, nw = 32-bit words of the modulus, each
  multiply-add an ``IMAD.WIDE`` of two issues).  The bytes term reads
  every input once and writes every output once at the HBM rate.

The JAX module's TPU entries (v5e, v5p, v4), its v5e calibration of
vector passes a multiply and its 128-lane padding are TPU layouts and
have no counterpart here.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass

from torch.autograd import profiler as _torch_profiler


@dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one card."""

    name: str
    int8_tops: float          # tensor-core int8, dense, tera-ops (MAC = 2)
    imad_wide_gmacs: float    # 32x32->64 multiply-adds, giga a second
    hbm_gbps: float           # HBM bandwidth GB/s


CHIPS = {
    # H100 SXM5: 1,979 dense int8 TOP/s; 3.35 TB/s HBM3; 132 SMs of 64
    # INT32 lanes at 1.98 GHz, an IMAD.WIDE taking two issues
    "h100": ChipSpec("h100", int8_tops=1979.0,
                     imad_wide_gmacs=132 * 64 * 1.98 / 2, hbm_gbps=3350.0),
}


def detect_chip() -> ChipSpec:
    """The :class:`ChipSpec` of CUDA device 0, by its name.  Raises
    RuntimeError without a card and ValueError for a card that has no
    entry in :data:`CHIPS`."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("detect_chip needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    for key, spec in CHIPS.items():
        if key in name.lower().replace(" ", ""):
            return spec
    raise ValueError(f"no ChipSpec for {name!r}; known: {sorted(CHIPS)}")


def sliding_mults(e_bits: int, window: int) -> int:
    """Montgomery multiplies of the shared-exponent sliding-window ladder
    (rns2.sliding_window_schedule): squarings + expected window hits +
    odd-power table build + entry/exit."""
    return e_bits + e_bits // (window + 1) + (1 << (window - 1)) + 2


def fixed_window_mults(e_bits: int, window: int) -> int:
    """Montgomery products of the fixed-window ladder (B2, B4): window
    squarings and one multiply a digit, the 2^window table, the exit."""
    d = -(-e_bits // window)
    return d * (window + 1) + (1 << window) + 1


@dataclass
class RooflineModel:
    """The least time of one batched modexp configuration on ``chip``.

    ``k``: RNS channels per base (Rns2Spec.k) for the RNS ladders; 0 for
    the limb ladder (kernel B4) on ``mod_bits``-bit moduli.  ``rows``:
    the batch."""

    mod_bits: int             # modulus width (e.g. 4096 for mod n^2)
    exp_bits: int             # exponent width (e.g. 2048 for r^n)
    k: int = 0                # RNS channels per base; 0: limb ladder
    window: int = 6
    sliding: bool = True
    rows: int = 1
    chip: ChipSpec | None = None

    def __post_init__(self):
        if self.chip is None:
            self.chip = detect_chip()

    @property
    def mults(self) -> int:
        if self.sliding:
            return sliding_mults(self.exp_bits, self.window)
        return fixed_window_mults(self.exp_bits, self.window)

    @property
    def macs_per_mult(self) -> int:
        """int8 MACs per RNS Montgomery multiply (2 base extensions)."""
        return 8 * self.k * self.k

    @property
    def words(self) -> int:
        """32-bit words of the modulus (the limb ladder's nw)."""
        return -(-self.mod_bits // 32)

    @property
    def imad_per_mult(self) -> int:
        """32x32->64 multiply-adds per limb Montgomery product (CIOS)."""
        nw = self.words
        return 2 * nw * nw + nw

    def ops_s(self) -> float:
        """Seconds at the operation peak: the tensor cores (RNS) or the
        INT32 multiply pipe (limb)."""
        if self.k:
            return (2.0 * self.macs_per_mult * self.mults * self.rows
                    / (self.chip.int8_tops * 1e12))
        return (self.imad_per_mult * self.mults * self.rows
                / (self.chip.imad_wide_gmacs * 1e9))

    def bytes(self) -> int:
        """Bytes each ladder must move: a row in and out (int32 residues
        [2k] or 16-bit limbs held as int32) and, for RNS, the two
        [2k, 2k] int8 base-extension matrices."""
        if self.k:
            return self.rows * 2 * (2 * self.k) * 4 + 2 * (2 * self.k) ** 2
        return self.rows * 2 * (2 * self.words) * 4

    def hbm_s(self) -> float:
        return self.bytes() / (self.chip.hbm_gbps * 1e9)

    def bound_s(self) -> float:
        return max(self.ops_s(), self.hbm_s())

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_s() >= self.hbm_s() else "bytes"

    def rate(self) -> float:
        """Rows a second at the bound."""
        return self.rows / self.bound_s()

    def report(self, measured: float | None = None) -> str:
        """The bound's lines; ``measured``: rows a second, quoted as a
        share of the bound."""
        kind = (f"k={self.k} int8 tensor cores ({self.macs_per_mult} MACs "
                f"a multiply)" if self.k else
                f"limb nw={self.words} IMAD.WIDE ({self.imad_per_mult} "
                f"multiply-adds a product)")
        lines = [
            f"roofline {self.chip.name}: mod={self.mod_bits}b "
            f"exp={self.exp_bits}b {kind}, "
            f"{'sliding' if self.sliding else 'fixed'}-w{self.window} "
            f"({self.mults} multiplies), {self.rows} rows",
            f"  operations : {self.ops_s() * 1e3:>10.4f} ms",
            f"  HBM bytes  : {self.hbm_s() * 1e3:>10.4f} ms "
            f"({self.bytes()} B)",
            f"  bound      : {self.bound_s() * 1e3:>10.4f} ms by "
            f"{self.bound_by}, {self.rate():,.0f} rows/s",
        ]
        if measured:
            lines.append(f"  measured   : {measured:>12,.0f} rows/s = "
                         f"{measured / self.rate():.1%} of the bound")
        return "\n".join(lines)


def encryption_roofline(pk_bits: int = 2048, window: int = 6,
                        chip: ChipSpec | None = None, rows: int = 4096
                        ) -> RooflineModel:
    """Roofline of regular encryption's r^(n^s) ladder at level 1 (kernel
    B1): exponent n (pk_bits), modulus n^2 (2*pk_bits), ``rows`` rows."""
    from ..bigint.rns2 import Rns2Spec
    # k depends only on the modulus width: any odd modulus of that width
    probe = (1 << (2 * pk_bits - 1)) | 1
    k = Rns2Spec(probe).k
    return RooflineModel(mod_bits=2 * pk_bits, exp_bits=pk_bits, k=k,
                         window=window, sliding=True, rows=rows, chip=chip)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the enclosed block (CPU activity, and
    CUDA activity where a card is present), written to
    ``logdir/trace.json`` in the Chrome trace format when the block
    ends, with the port's spans of the block (those :func:`take` holds,
    left for it to take) as a track of their own on the trace's time
    base.  Yields the profiler (``key_averages()``, ``events()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, _record(clear=False))


# ---------------------------------------------------------------------------
# Spans: the port's stages on the device trace's clock
# ---------------------------------------------------------------------------
#
# A span is recorded exactly while a torch.profiler records in this
# process (torch's process-wide flag, so the DDLEQ pipeline's worker
# threads record too); otherwise span() returns one shared no-op object.
# Spans emit nothing into the profiler: a CUDA user annotation would be
# counted among the device's events.  Times are time.perf_counter_ns();
# anchor_ns = time.time_ns() - time.perf_counter_ns(), read when
# recording starts, puts them on the Unix-epoch nanoseconds of the
# profiler's events.

_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()
_spans: list = []                 # every recorded span, open ones too
_anchor: int | None = None
_merged: list = []                # the ranks' records (parallel.launch)
_counts: dict = {}                # count()'s counters, since the start


class _Off:
    """The span of a call while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "parent",
                 "root", "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _anchor
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self.end_ns = None
        with _lock:
            if _anchor is None:
                _anchor = time.time_ns() - time.perf_counter_ns()
            _spans.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        return False


def span(name: str, **attrs):
    """Context manager: one stage of the port (``name``, with ``attrs``
    such as the ladder's kernel), recorded while a ``torch.profiler``
    records in this process.  A span opened inside another on the same
    thread is its child; one opened on an empty stack is the root of an
    API call."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str, **attrs):
    """Decorator: each call of the function is a :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _torch_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, dict(attrs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name`` (whether or not a
    profiler records); :func:`take` reports the totals since the process
    started, as it does the launch counters."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def _launch_counts() -> dict:
    """The kernels' launch counters (``cuda_build.count_launch``), read
    from their wrappers, as ``launch.<kernel>``: the ladders B1-B4w and
    the SHA-256 (``SHA``)."""
    from ..bigint import (fixed_base_kernel, modexp_kernel, mont_kernel,
                          sliding_kernel)
    from . import sha256
    wrappers = (("B1", sliding_kernel.rns2_pow_sliding_b1),
                ("B2", modexp_kernel.rns2_pow_b2),
                ("B3", fixed_base_kernel.rns2_pow_fixed_base_b3),
                ("B4", mont_kernel.mont_pow_b4),
                ("B4w", mont_kernel.mont_pow_b4w),
                ("SHA", sha256.sha256_bytes))
    return {f"launch.{k}": getattr(w, "launches", 0) for k, w in wrappers}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _record(clear: bool) -> dict:
    global _spans, _anchor, _merged
    with _lock:
        done = [s for s in _spans if s.end_ns is not None]
        anchor, merged = _anchor, list(_merged)
        if clear:
            _spans = [s for s in _spans if s.end_ns is None]
            _merged = []
            if not _spans:
                _anchor = None
    index = {s.id: i for i, s in enumerate(done)}
    spans = [{"name": s.name, "attrs": s.attrs, "start_ns": s.start_ns,
              "end_ns": s.end_ns, "id": s.id,
              "parent": index.get(s.parent.id, -1) if s.parent else -1,
              "root": s.root, "thread": s.thread} for s in done]
    with _lock:
        counts = dict(_counts)
    return {"rank": _rank(), "anchor_ns": anchor, "spans": spans,
            "counters": {**_launch_counts(), **counts}, "ranks": merged}


def take() -> dict:
    """The record of the spans that ended since the last take, which it
    clears: ``spans`` (dicts of ``name``, ``attrs``, ``start_ns`` and
    ``end_ns`` on ``time.perf_counter_ns()``, ``id``, ``parent`` (its
    index in the list, -1 for a root or a parent taken before), ``root``
    (its root's id, which all spans of one API call share) and
    ``thread``), in the order they opened, ``anchor_ns`` (add it to
    a span's time for the profiler's clock; None where nothing was
    recorded), ``rank`` (0 outside ranks), ``counters`` (the launch
    counters ``launch.*`` and :func:`count`'s, such as
    ``zkp.rows_verified`` and ``zkp.servers_dropped``: totals since the
    process started) and ``ranks``: the records of ranks that
    ``parallel.launch.run_ranks`` brought back, each with its rank."""
    return _record(clear=True)


def merge(rank: int, record: dict) -> None:
    """Keep a rank's record (from its :func:`take`) for this process's
    next :func:`take`, tagged with ``rank``; a record without spans is
    dropped."""
    if record["spans"] or record["ranks"]:
        with _lock:
            _merged.append(dict(record, rank=rank))


def _write_spans(path: str, record: dict) -> None:
    """Add the record's spans (and its ranks') to the Chrome trace at
    ``path``: complete events of category ``paillier_span``, one track a
    rank, in microseconds from the trace's ``baseTimeNanoseconds``.  The
    trace's own events are copied through unread."""
    rows = []
    for rec in [record] + record["ranks"]:
        if rec["anchor_ns"] is None:
            continue
        pid = f"paillier_tpu_torch spans, rank {rec['rank']}"
        rows += [(pid, s, rec["anchor_ns"]) for s in rec["spans"]]
    if not rows:
        return
    with open(path, "rb") as fh:
        head = fh.read(1 << 16)
    key = re.search(rb'"traceEvents":\s*\[', head)
    if key is None:
        return
    m = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', head)
    base = int(m.group(1)) if m else 0
    events = ",\n".join(json.dumps({
        "ph": "X", "cat": "paillier_span", "name": s["name"], "pid": pid,
        "tid": s["thread"], "ts": (s["start_ns"] + anchor - base) / 1e3,
        "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
        "args": dict(s["attrs"], root=s["root"])})
        for pid, s, anchor in rows)
    sep = "" if head[key.end():].lstrip().startswith(b"]") else ","
    tmp = path + ".spans"
    with open(path, "rb") as src, open(tmp, "wb") as dst:
        dst.write(head[:key.end()])
        dst.write(("\n" + events + sep).encode())
        src.seek(key.end())
        shutil.copyfileobj(src, dst)
    os.replace(tmp, path)
