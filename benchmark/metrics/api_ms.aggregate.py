"""api_ms.aggregate: the mean time of a call of homomorphic.aggregate
in the traced window, from the harness span "aggregate" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("aggregate")
