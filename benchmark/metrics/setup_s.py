"""setup_s: from the start of the process to the first timed request:
imports, the CUDA context, key, engines, inputs and the warm request
(in a checkout's first run, the kernels' builds too)."""


def read(run):
    return run.setup_s
