"""The benchmark's harness: cells by name, the measured window, the result.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration's file, the traffic mix's data file
(``benchmark/traffic/<traffic>.json``, read by the generator of the op
kind it names, ``benchmark/ops/<op>.py``) and one reader a metric
(``benchmark/metrics/<metric>.py``).  A later cell, mix or metric is
added as files and entries; no file here changes.

A run: set-up (key, engines, inputs from the seed, one warm request at
the cell's shapes), then a closed loop that sends one request, waits
for its results on the host and sends the next, for ``--seconds``
seconds.  The window ends at the first completion after that, so a rate
is all the work of the window over all its time.  Then the program's
state is freed and the plain reference judges what the window produced.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# top-level module names nothing in a run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "paillier_tpu")


# -- cells, by name ---------------------------------------------------------

@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics,
    each read from its own file."""
    bench = bench or manifest()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def op_module(kind: str):
    """The module of the op kind a traffic mix names
    (``benchmark/ops/<kind>.py``)."""
    return importlib.import_module(f"benchmark.ops.{kind}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- spans ------------------------------------------------------------------

class Spans:
    """Harness spans around the calls into the program's layers.  Off,
    a span costs nothing; on (traced runs), each ends in
    ``torch.cuda.synchronize()`` on a CUDA device and is kept as (name,
    start ns, end ns) on the host's ``perf_counter_ns`` clock."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.sync = None
        if enabled and device is not None and str(device).startswith("cuda"):
            import torch
            self.sync = torch.cuda.synchronize
        self.items: list = []

    @contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.items.append((name, t0, time.perf_counter_ns()))

    def durations(self) -> dict:
        out: dict = {}
        for name, a, b in self.items:
            out.setdefault(name, []).append((b - a) / 1e9)
        return out


# -- the measured window ----------------------------------------------------

@dataclass
class Window:
    """What a closed-loop window did: per request its latency, what the
    op kept for the reference, and whether it failed."""

    start_wall: float = 0.0
    start_ns: int = 0
    end_ns: int = 0
    latencies: list = field(default_factory=list)
    records: list = field(default_factory=list)
    failed: list = field(default_factory=list)
    errors: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def measure(op, seconds: float, spans: Spans, agree=None) -> Window:
    """Send ``op``'s requests one after another (cycling over its
    list) until the first completion after ``seconds`` seconds.  A
    request's latency runs from its sending to ``op.call`` returning with
    its results on the host; ``op.keep`` then takes what the reference
    will judge.  ``agree(done) -> done`` lets ranks stop together."""
    win = Window(start_wall=time.time(), start_ns=time.perf_counter_ns())
    i = 0
    while True:
        req = op.requests[i % len(op.requests)]
        a = time.perf_counter_ns()
        try:
            with spans("request"):
                out = op.call(req)
            err = None
        except Exception:            # a request that raises has failed
            out, err = None, traceback.format_exc(limit=4)
        b = time.perf_counter_ns()
        win.latencies.append((b - a) / 1e9)
        if err is None:
            rec, ok = op.keep(i, req, out)
        else:
            rec, ok = None, False
            if len(win.errors) < 3:
                win.errors.append(err)
        win.records.append(rec)
        win.failed.append(not ok)
        win.end_ns = b
        i += 1
        done = (b - win.start_ns) / 1e9 >= seconds
        if agree is not None:
            done = agree(done)
        if done:
            return win


# -- what a run hands the metric readers ------------------------------------

@dataclass
class Run:
    """A run as the metric readers see it (rank 0's view on four cards).

    ``ops``: the ops of the window's requests that completed correctly;
    ``ops_attempted``: all of them; ``latencies``: seconds a request;
    ``window_s``; ``setup_s``; ``spans``: {name: [seconds, ..]};
    ``work``: the ladders the window's requests need (``roofline``
    items); ``trace``: the profiler's device events of the traced window
    (:class:`benchmark.traces.Trace`) or None."""

    ops: int
    ops_attempted: int
    latencies: list
    window_s: float
    setup_s: float
    spans: dict
    work: list
    trace: object = None

    def span_mean_ms(self, name: str):
        vals = self.spans.get(name)
        return 1e3 * sum(vals) / len(vals) if vals else None


def p95(values: list) -> float:
    """The nearest-rank 95th percentile: the smallest value with at least
    95% of the values at or below it."""
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def metrics_of(cell: Cell, run: Run, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer ones
    (traced), each from its reader; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: Cell, run: Run, window: Window, checks: dict,
                device: dict, traced: bool, failed_extra: int = 0) -> dict:
    """The run's last line.  ``checks``: {name: (value, limit)}, each
    number the comparison read beside its limit; it comes last."""
    failed = sum(window.failed) + failed_extra
    correct = (failed == 0 and len(window.failed) > 0
               and all(v <= lim for v, lim in checks.values()))
    out = {"correct": correct, "attempted": len(window.failed),
           "failed": failed, "metrics": metrics_of(cell, run, traced),
           "device": device}
    if traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def print_checks(checks: dict, requests: int) -> None:
    """The compared numbers beside their limits, as the last lines of
    standard error."""
    print(f"requests: {requests}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
