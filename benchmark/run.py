"""Run one cell of the benchmark of ``paillier_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cells are ``BENCHMARK.json``'s
``workloads``.  Prints the compared numbers beside their limits as the
last lines of standard error and one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, in a traced run ``breakdown``, and ``checks`` last): the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  Exits non-zero, printing no result, without as many CUDA
cards as the cell asks for, or where the run loaded JAX or the JAX
package.  Every process the run started (the reference's pool, the
ranks, multiprocessing's resource tracker) has ended before the result
is printed.
"""

import time

T0 = time.time()                       # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark import runner
    try:
        out = runner.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0)
    except RuntimeError as exc:
        print(f"run failed: {exc}", file=sys.stderr)
        return 3
    finally:
        left = reap()
    if left:
        print(f"killed processes {left}, which outlived the run",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _children() -> list[int]:
    """The pids whose parent is this process, from /proc."""
    me, out = os.getpid(), []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            out.append(int(d.name))
    return out


def reap(grace_s: float = 30.0) -> list[int]:
    """Join multiprocessing's children, stop its resource tracker, and
    wait for every other child of this process, killing one that has not
    ended after ``grace_s``.  Returns the pids that had to be killed."""
    import gc
    import multiprocessing as mp
    from multiprocessing import resource_tracker
    for p in mp.active_children():
        p.join(grace_s)
    gc.collect()                       # finalize pools' and queues' locks
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()                         # closes its pipe, waits for it
    killed = []
    deadline = time.monotonic() + grace_s
    for pid in _children():
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    killed.append(pid)
                    break
                time.sleep(0.05)
        except ChildProcessError:      # already waited for elsewhere
            pass
    return killed


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter shutdown: its finalizers could start multiprocessing's
    # resource tracker again after reap() has stopped it
    os._exit(code)
