"""ops_per_s: the ops of the window's requests that completed correctly,
over the window (from its start to the first completion after
``--seconds``)."""


def read(run):
    return run.ops / run.window_s if run.window_s > 0 else None
