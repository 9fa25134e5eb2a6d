"""step_mfu: the least time of every modular exponentiation the window's
ops need (``benchmark.roofline``) over the traced window itself: the
whole step's share of the card's int8 peak, host time and idle gaps
included.  It bounds every kernel's roofline share from below in the
same cell."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.work or run.trace.window_s <= 0:
        return None
    least = sum(roofline.item_seconds(w) for w in run.work)
    return 100.0 * least / run.trace.window_s
