"""B1_roofline: the least time of the shared-exponent sliding-window ladders
the window's ops run on kernel B1 (``benchmark.roofline``) over the
device time of the kernels whose name holds PATTERNS."""

from benchmark import roofline

PATTERNS = ("rns2_sliding_kernel",)


def read(run):
    if run.trace is None:
        return None
    items = [w for w in run.work if w["kernel"] == "B1"]
    busy = run.trace.kernel_s(*PATTERNS)
    if not items or busy <= 0:
        return None
    return 100.0 * sum(roofline.item_seconds(w) for w in items) / busy
