"""The idle_ms.* readers (``benchmark/program_idle.py``) on a synthetic
trace and span record: idle time goes to the innermost open span, the
anchor places the spans on the device clock, the stages' idle and the
idle outside every span add up to the window's idle, rank 0's record is
the one read on four cards, and a reader returns None without a trace or
a record (as against a program that has no span recorder)."""

import numpy as np
import pytest

from benchmark import harness, program_idle
from benchmark.traces import Trace

STAGES = ("glue", "ladder", "encode", "decode", "host_int", "hash",
          "gather")


def _trace(intervals, shift=0):
    iv = np.array(intervals, dtype=np.int64).reshape(-1, 2) + shift
    return Trace(window_s=1.0, names=["k"], idx=np.zeros(len(iv), np.int64),
                 start=iv[:, 0], end=iv[:, 1])


def _span(name, a, b, parent=-1, thread=1, **attrs):
    return {"name": name, "attrs": attrs, "start_ns": a, "end_ns": b,
            "id": 0, "parent": parent, "root": 0, "thread": thread}


def _record(spans, anchor=0, rank=0, ranks=()):
    return {"rank": rank, "anchor_ns": anchor, "spans": spans,
            "counters": {}, "ranks": list(ranks)}


def _run(trace, requests=2):
    return harness.Run(ops=requests, ops_attempted=requests,
                       latencies=[0.1] * requests, window_s=1.0, setup_s=0.0,
                       spans={}, work=[], trace=trace)


# a root [0, 100) with a ladder [20, 60) and a decode [80, 95); the card
# busy over [0, 10), [30, 40), [70, 85)
SPANS = [_span("decrypt", 0, 100), _span("ladder", 20, 60, parent=0),
         _span("decode", 80, 95, parent=0)]
BUSY = [(0, 10), (30, 40), (70, 85)]


def test_idle_goes_to_the_innermost_span():
    got = program_idle.split(_trace(BUSY), _record(SPANS), 0, 100)
    # glue: [10, 20) + [60, 70) + [95, 100); ladder: [20, 30) + [40, 60);
    # decode: [85, 95)
    assert got == {"glue": 25, "ladder": 30, "decode": 10}


def test_the_latest_opened_span_is_the_innermost_across_threads():
    spans = [_span("prove", 0, 100, thread=1),
             _span("verify", 10, 50, thread=2),
             _span("hash", 30, 40, parent=0, thread=1)]
    got = program_idle.split(_trace([]), _record(spans), 0, 100)
    assert got == {"glue": 90, "hash": 10}


def test_the_anchor_maps_spans_onto_the_device_clock():
    anchor = 1_700_000_000_000_000_000
    shifted = [dict(s, start_ns=s["start_ns"] - anchor,
                    end_ns=s["end_ns"] - anchor) for s in SPANS]
    got = program_idle.split(_trace(BUSY), _record(shifted, anchor=anchor),
                             0, 100)
    assert got == {"glue": 25, "ladder": 30, "decode": 10}
    wrong = program_idle.split(_trace(BUSY), _record(shifted, anchor=anchor
                                                     + 30), 0, 100)
    assert wrong != got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stages_and_outside_add_up_to_the_window_idle(seed):
    rng = np.random.default_rng(seed)
    lo, hi = 0, 100_000
    busy = np.sort(rng.integers(lo - 500, hi + 500, size=(300, 2)), axis=1)
    spans = []
    for r in range(40):                       # nested calls, 2 threads
        a = int(rng.integers(lo - 1000, hi))
        b = a + int(rng.integers(1, 5000))
        spans.append(_span("encrypt", a, b, thread=r % 2))
        c = int(rng.integers(a, b))
        spans.append(_span(STAGES[r % 7], c, int(rng.integers(c, b + 1)),
                           parent=len(spans) - 1, thread=r % 2))
    tr = _trace(busy)
    got = program_idle.split(tr, _record(spans), lo, hi)
    s, e = np.clip(busy[:, 0], lo, hi), np.clip(busy[:, 1], lo, hi)
    mark = np.zeros(hi - lo, dtype=bool)
    for a, b in zip(s, e):
        mark[a - lo:b - lo] = True
    assert sum(got.values()) == int((~mark).sum())
    assert program_idle.OUTSIDE in got and "glue" in got
    assert set(got) <= set(STAGES) | {program_idle.OUTSIDE}


@pytest.fixture
def program(monkeypatch):
    """The program's take() replaced by one that hands over ``box[0]``."""
    from paillier_tpu_torch.ops import profiling
    box = [None]
    monkeypatch.setattr(profiling, "take", lambda: box[0])
    monkeypatch.setattr(program_idle, "_taken", (None, None))
    monkeypatch.setattr(program_idle, "_split", (None, None))
    return box


def test_readers_read_rank_0_per_request(program):
    program[0] = _record([], ranks=[_record(SPANS[:1], rank=1),
                                    _record(SPANS, rank=0)])
    run = _run(_trace(BUSY), requests=5)
    got = {name: harness.reader(f"idle_ms.{name}")(run) for name in STAGES}
    want = {"glue": 25, "ladder": 30, "encode": 0, "decode": 10,
            "host_int": 0, "hash": 0, "gather": 0}
    assert got == {k: pytest.approx(v / 1e6 / 5) for k, v in want.items()}


def test_a_reader_returns_none_without_a_trace_or_a_record(program,
                                                           monkeypatch):
    read = harness.reader("idle_ms.glue")
    program[0] = _record(SPANS)
    assert read(_run(None)) is None
    program[0] = _record([], anchor=None)
    assert read(_run(_trace(BUSY))) is None
    # a program without the recorder, as the parent of the readers has
    from paillier_tpu_torch.ops import profiling
    monkeypatch.delattr(profiling, "take")
    monkeypatch.setattr(program_idle, "_taken", (None, None))
    assert read(_run(_trace(BUSY))) is None
