"""B2_roofline: the least time of the per-row-exponent fixed-window ladders
the window's ops run on kernel B2 (``benchmark.roofline``) over the
device time of the kernels whose name holds PATTERNS."""

from benchmark import roofline

PATTERNS = ("rns2_modexp_kernel",)


def read(run):
    if run.trace is None:
        return None
    items = [w for w in run.work if w["kernel"] == "B2"]
    busy = run.trace.kernel_s(*PATTERNS)
    if not items or busy <= 0:
        return None
    return 100.0 * sum(roofline.item_seconds(w) for w in items) / busy
