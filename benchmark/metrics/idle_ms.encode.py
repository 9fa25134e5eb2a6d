"""idle_ms.encode: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which core.keys.encode_batch (Python
ints to limbs, then the copy to the device) was the innermost open span
(benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "encode")
