"""idle_ms.gather: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which parallel.collective._all_gather
(the NCCL or gloo gather of DDLEQ's sharded stages, with its host
copies) was the innermost open span (benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "gather")
