"""nccl_pct: the share of rank 0's traced window in which an NCCL kernel
ran (kernel names holding "nccl")."""

PATTERNS = ("nccl", "NCCL")


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.busy_s(*PATTERNS) / run.trace.window_s
