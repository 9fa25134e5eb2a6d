"""api_ms.const_mult: the mean time of a call of homomorphic.const_mult with per-element weights
in the traced window, from the harness span "const_mult" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("const_mult")
