"""tzkp_ms.prove: the mean time of a call of
threshold.partial_decrypt_with_zkp_batch (every responding server's
partial decryptions and share proofs of a batch) in the traced window,
from the harness span "zkp_prove" (it ends in torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("zkp_prove")
