"""idle_ms.host_int: device-idle milliseconds a request of the traced
window (rank 0's on four cards) during which host big-integer work
(host.modinv_batch, const_mult's per-element digit strings, the
threshold Lagrange exponents, ops.random's unit sampling) was the
innermost open span (benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "host_int")
