"""One run of one cell: set-up, the window, the reference, the result.

``run_cell`` is what ``benchmark/run.py`` calls on the card.  The tests
call it on the CPU at small sizes (``device="cpu"``, ``overrides``),
with ``fault`` to break the timed path underneath and see ``correct``
come out false; ``controls=True`` also judges the control (the
reference's own answers with the canonical form broken) on the same
window.
"""

from __future__ import annotations

import copy
import gc
import sys
import time

from benchmark import harness


def _cell(name: str, overrides: dict | None) -> harness.Cell:
    cell = harness.load_cell(name)
    for part in ("config", "traffic"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    return cell


def _work(op, n_requests: int) -> list:
    out = []
    for i in range(n_requests):
        out += op.work(op.requests[i % len(op.requests)])
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", fault: str | None = None,
             controls: bool = False, overrides: dict | None = None,
             t0: float | None = None) -> dict:
    """The result line of one run (``control_checks`` added where
    ``controls``).  Raises RuntimeError where a run loaded JAX or the
    JAX package."""
    t0 = time.time() if t0 is None else t0
    cell = _cell(name, overrides)
    mod = harness.op_module(cell.traffic["op"])
    if getattr(mod, "RANKED", False):
        world = (overrides or {}).get("world", cell.chips)
        return _ranked(mod, cell, seed, seconds, trace, device, fault,
                       controls, world, t0)
    import torch
    from benchmark.traces import Tracer
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = harness.Spans(trace, dev)
    t_op = time.time()
    op = mod.Op(cell, seed, dev, spans, fault)
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"set-up: {t_op - t0:.3f} s to the op, {time.time() - t_op:.3f} s"
          " in it (key, engines, inputs, warm request)", file=sys.stderr)
    spans.items.clear()                       # the warm request's spans
    tracer = Tracer(dev) if trace and cuda else None
    if tracer:
        tracer.start()
    win = harness.measure(op, seconds, spans)
    tr = tracer.stop(spans) if tracer else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    work = _work(op, len(win.records)) if trace else []
    op.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, bad = op.check(win, control=False)
    control = op.check(win, control=True)[0] if controls else None
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
    return _finish(cell, op.ops_per_request, win, bad, checks, control,
                   device_info, spans.durations(), work, tr,
                   win.start_wall - t0, trace, harness.forbidden_modules())


def _ranked(mod, cell, seed, seconds, trace, device, fault, controls,
            world, t0):
    results = mod.run_ranks(cell, seed, seconds, trace, device, fault,
                            world)
    r0 = results[0]
    win = harness.Window(start_wall=r0["start_wall"], start_ns=0,
                         end_ns=int(r0["window_s"] * 1e9),
                         latencies=r0["latencies"], records=r0["records"],
                         failed=[any(r["failed"][i] for r in results)
                                 for i in range(len(r0["failed"]))],
                         errors=r0["errors"])
    checks, bad = mod.check(cell, seed, results)
    control = mod.check(cell, seed, results, control=True)[0] \
        if controls else None
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": r0["kind"], "count": world,
                   "memory_peak_bytes": max(r["peak"] for r in results)}
    if trace and r0["trace"] is not None:
        device_info["busy_s"] = sum(r["busy_s"] for r in results) / world
        device_info["window_s"] = r0["trace_window_s"]
    forbidden = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in results)))
    return _finish(cell, cell.traffic["chunk"], win, bad, checks, control,
                   device_info, r0["spans"], [], r0["trace"],
                   r0["start_wall"] - t0, trace, forbidden)


def _finish(cell, per_request, win, bad, checks, control, device_info,
            spans, work, tr, setup_s, trace, forbidden) -> dict:
    if forbidden:
        print(f"a run loaded {', '.join(forbidden)}", file=sys.stderr)
        raise RuntimeError(f"forbidden modules loaded: {forbidden}")
    failed = [f or i in bad for i, f in enumerate(win.failed)]
    for err in win.errors:
        print(err, file=sys.stderr)
    ok_requests = len(failed) - sum(failed)
    run = harness.Run(ops=ok_requests * per_request,
                      ops_attempted=len(failed) * per_request,
                      latencies=win.latencies, window_s=win.seconds,
                      setup_s=setup_s, spans=spans, work=work, trace=tr)
    win = copy.copy(win)
    win.failed = failed
    out = harness.result_line(cell, run, win, checks, device_info, trace)
    harness.print_checks(checks, len(failed))
    if control is not None:
        last = out.pop("checks")                  # the checks stay last
        out["control_checks"] = {k: {"value": v, "limit": lim}
                                 for k, (v, lim) in control.items()}
        out["checks"] = last
    return out
