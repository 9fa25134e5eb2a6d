"""idle_ms.decode: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which core.keys.decode_batch (the copy
to the host, with its wait for the card, then limbs to ints) was the
innermost open span (benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "decode")
