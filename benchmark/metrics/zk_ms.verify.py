"""zk_ms.verify: the mean time of a call of zk.ddleq.verify with mesh= (rank 0)
in the traced window, from the harness span "verify" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("verify")
