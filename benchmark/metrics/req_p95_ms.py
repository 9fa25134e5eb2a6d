"""req_p95_ms: the nearest-rank 95th percentile of the latencies of all
the window's requests, each from its sending to its results on the
host."""

from benchmark.harness import p95


def read(run):
    return 1e3 * p95(run.latencies) if run.latencies else None
