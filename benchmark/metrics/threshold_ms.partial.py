"""threshold_ms.partial: the mean time of a call of threshold.partial_decrypt_all
in the traced window, from the harness span "partial" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("partial")
