"""tzkp_ms.verify_combine: the mean time of a call of
threshold.combine_with_zkp_batch (every proof of every responding server
verified, the failing server dropped, the rest combined) in the traced
window, from the harness span "zkp_combine" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("zkp_combine")
