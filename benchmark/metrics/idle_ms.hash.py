"""idle_ms.hash: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which ops.sha256.sha256_bytes (the
SHA-256's elementwise launches) was the innermost open span
(benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "hash")
