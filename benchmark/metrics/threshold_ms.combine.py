"""threshold_ms.combine: the mean time of a call of threshold.combine
in the traced window, from the harness span "combine" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("combine")
