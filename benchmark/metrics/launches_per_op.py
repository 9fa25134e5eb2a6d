"""launches_per_op: kernel launches on the device in the traced window
(the profiler's kernel events, copies and fills left out) over the
window's ops (rank 0's on four cards)."""


def read(run):
    if run.trace is None or run.ops_attempted == 0:
        return None
    return run.trace.launches / run.ops_attempted
