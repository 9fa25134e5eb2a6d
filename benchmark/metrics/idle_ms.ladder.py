"""idle_ms.ladder: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which a ladder kernel's Python wrapper
(B1-B4w: operand checks, context packing, schedules, up to the launch)
was the innermost open span (benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "ladder")
