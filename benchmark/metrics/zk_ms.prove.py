"""zk_ms.prove: the mean time of a call of zk.ddleq.prove with mesh= (rank 0)
in the traced window, from the harness span "prove" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("prove")
