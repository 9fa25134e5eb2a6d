"""api_ms.decrypt: the mean time of a call of Decryptor.decrypt (CRT)
in the traced window, from the harness span "decrypt" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("decrypt")
