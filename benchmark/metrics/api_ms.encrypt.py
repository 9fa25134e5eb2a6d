"""api_ms.encrypt: the mean time of a call of Encryptor.encrypt
in the traced window, from the harness span "encrypt" (it ends in
torch.cuda.synchronize())."""


def read(run):
    return run.span_mean_ms("encrypt")
