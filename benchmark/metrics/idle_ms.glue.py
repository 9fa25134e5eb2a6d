"""idle_ms.glue: device-idle milliseconds a request of the traced window
(rank 0's on four cards) during which a root span of the program (an API
call: encrypt, decrypt, const_mult, aggregate, add, partial, combine,
prove, verify) was itself the innermost open span: the host dispatching
the glue between the call's stages (limb and RNS converters, Toeplitz
products, vpu steps) (benchmark.program_idle)."""

from benchmark import program_idle


def read(run):
    return program_idle.idle_ms(run, "glue")
