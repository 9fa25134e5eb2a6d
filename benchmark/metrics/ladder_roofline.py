"""ladder_roofline: the least time of every modular exponentiation
the window's ops need (``benchmark.roofline``: the fewest sliding-window
multiplies of each exponent at the int8 tensor-core peak) over the
device time of all kernels in the traced window.  The same work whatever
kernel carries it."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.work:
        return None
    busy = run.trace.kernel_s()
    if busy <= 0:
        return None
    least = sum(roofline.item_seconds(w) for w in run.work)
    return 100.0 * least / busy
