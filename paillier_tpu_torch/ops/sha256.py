"""Batched SHA-256 on torch tensors, on the device of the input.

The port of ``paillier_tpu.ops.sha256`` (jnp there: the JAX module is no
Pallas kernel).  It hashes the Fiat-Shamir challenges of a batch of
proofs at once (reference: crypto/sha256 via random_oracle.go:4,
thresholdkey.go:5) with the reference's byte semantics: each big integer
is hashed as its minimal big-endian encoding (empty for zero), so message
lengths vary along the batch; assembly is elementwise masks and gathers.

:func:`sha256_bytes` takes a CPU tensor to the plain torch version,
:func:`sha256_bytes_plain`, and a CUDA tensor to the hand-written kernel
``paillier_tpu_torch/csrc/sha256.cu`` (one thread a message; its header
note gives the layout and what bounds it), built by
:mod:`..bigint.cuda_build` at first use and launched on PyTorch's current
stream.  There is no fallback: a CUDA tensor that the kernel does not
take, a failed build or a failed launch raises.

The plain version: torch has no uint32 add or shift on the CPU, so words
are int64 values below 2^32 and every sum is masked with 0xFFFFFFFF.  A
right rotation of a word x reads 32 bits of the 63-bit doubled word
x | (x << 32) (its top bit, which no rotation reads, dropped).  The batch
is the vector axis; the padding and block counts are masks, the blocks
and the 64 rounds sequential, so a message of N blocks costs about 2,500
elementwise ops a block, whatever the batch.
"""

from __future__ import annotations

import ctypes

import torch

from ..bigint import cuda_build
from .profiling import spanned

SOURCE = cuda_build.CSRC / "sha256.cu"

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

_M32 = 0xFFFFFFFF


def _dbl(x: torch.Tensor) -> torch.Tensor:
    """x | (x << 32) for words x < 2^32, less its bit 63: rotr(x, n) is
    (_dbl(x) >> n) & _M32 for 1 <= n <= 31."""
    return x | ((x & 0x7FFFFFFF) << 32)


def limbs_to_be_bytes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Limbs [B, L] (little-endian 16-bit) -> (bytes [B, 2L], len [B]).

    Bytes are the big-endian encoding padded with leading zeros to the
    full width; ``len`` is the minimal encoding length (0 for zero), as
    Go's Bytes() gives it.  Both int64 on x's device.
    """
    B, L = x.shape
    x = x.to(torch.int64)
    le = torch.stack([x & 0xFF, (x >> 8) & 0xFF], dim=-1).reshape(B, 2 * L)
    place = torch.arange(1, 2 * L + 1, device=x.device)
    length = ((le != 0) * place).amax(dim=-1)      # highest nonzero + 1
    return le.flip(-1), length


def concat_be(parts: list[tuple[torch.Tensor, torch.Tensor]],
              out_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the minimal encodings of full-width byte arrays.

    Each part is (bytes [B, W_i] big-endian with leading zeros, len [B]).
    Returns (buffer [B, out_len], total length [B]), each part's minimal
    suffix packed after the previous one from offset 0: one gather a part.
    """
    B = parts[0][0].shape[0]
    dev = parts[0][0].device
    buf = torch.zeros((B, out_len), dtype=torch.int64, device=dev)
    pos = torch.arange(out_len, device=dev)[None, :]
    offset = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for be, ln in parts:
        W = be.shape[-1]
        ln_c = ln.to(torch.int64)[:, None]
        # output position j in [offset, offset + len) reads
        # be[W - len + (j - offset)]
        src = (W - ln_c + (pos - offset)).clamp(0, W - 1)
        valid = (pos >= offset) & (pos < offset + ln_c)
        buf = torch.where(valid, torch.gather(be.to(torch.int64), -1, src),
                          buf)
        offset = offset + ln_c
    return buf, offset[:, 0]


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    vp = ctypes.c_void_p
    lib.sha256_launch.argtypes = [vp, vp, vp, ctypes.c_int,
                                  ctypes.c_longlong, vp]
    lib.sha256_launch.restype = ctypes.c_int
    _lib = lib
    return lib


@spanned("hash")
def sha256_bytes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row's first ``lengths[b]`` bytes (0..W).

    data: [B, W] of byte values; lengths: [B].  Returns the digests as
    int64 [B, 8] (big-endian 32-bit words, each < 2^32) on data's device.
    A CPU tensor (any integer type) runs :func:`sha256_bytes_plain`; a
    CUDA tensor, int64 and contiguous as :func:`concat_be` gives it,
    launches the kernel and adds one to ``sha256_bytes.launches``.
    """
    if data.device.type == "cpu":
        return sha256_bytes_plain(data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"the SHA-256 kernel runs on CUDA tensors, got "
                         f"{data.device}")
    if data.dtype != torch.int64 or data.dim() != 2:
        raise ValueError(f"data must be int64 [B, W], got {data.dtype} "
                         f"{tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    B, W = data.shape
    if (lengths.dtype != torch.int64 or tuple(lengths.shape) != (B,)
            or not lengths.is_contiguous() or lengths.device != data.device):
        raise ValueError(f"lengths must be contiguous int64 [{B}] on "
                         f"{data.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    lib = load()
    out = torch.empty((B, 8), dtype=torch.int64, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = lib.sha256_launch(data.data_ptr(), lengths.data_ptr(),
                                out.data_ptr(), B, W, stream)
    if err:
        raise RuntimeError(f"the SHA-256 kernel's launch failed: cudaError "
                           f"{err}")
    cuda_build.count_launch(sha256_bytes)
    return out


sha256_bytes.launches = 0


def sha256_bytes_plain(data: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """:func:`sha256_bytes` in plain torch, on data's device.

    data: integer [B, W] of byte values; lengths: integer [B].  Every row
    runs through the blocks that a W-byte message needs; a row's state
    stops at its own last block.
    """
    B, W = data.shape
    dev = data.device
    PAD = ((W + 9 + 63) // 64) * 64
    pos = torch.arange(PAD, device=dev)[None, :]
    lengths = lengths.to(torch.int64)
    ln = lengths[:, None]
    padded = torch.zeros((B, PAD), dtype=torch.int64, device=dev)
    padded[:, :W] = data.to(torch.int64)
    padded = torch.where(pos == ln, 0x80, padded)
    padded = torch.where(pos > ln, 0, padded)
    # the bit length, big-endian, in the last 8 bytes of the final block
    nblocks = (lengths + 9 + 63) // 64
    total = (nblocks * 64)[:, None]
    bitlen = (lengths * 8)[:, None]
    for i in range(8):
        padded = torch.where(pos == total - 1 - i, (bitlen >> (8 * i)) & 0xFF,
                             padded)
    words = ((padded[:, 0::4] << 24) | (padded[:, 1::4] << 16)
             | (padded[:, 2::4] << 8) | padded[:, 3::4]).t().contiguous()

    K = torch.tensor(_K, dtype=torch.int64, device=dev)[:, None]
    state = torch.tensor(_H0, dtype=torch.int64, device=dev)[:, None].repeat(
        1, B)                                                   # [8, B]
    for blk in range(PAD // 64):
        ws = torch.empty((64, B), dtype=torch.int64, device=dev)
        ws[:16] = words[16 * blk:16 * blk + 16]
        for t in range(16, 64, 2):       # words t and t + 1 are independent
            w15, w2 = ws[t - 15:t - 13], ws[t - 2:t]
            y15, y2 = _dbl(w15), _dbl(w2)
            s0 = (y15 >> 7) ^ (y15 >> 18) ^ (w15 >> 3)
            s1 = (y2 >> 17) ^ (y2 >> 19) ^ (w2 >> 10)
            ws[t:t + 2] = (ws[t - 16:t - 14] + s0 + ws[t - 7:t - 5]
                           + s1) & _M32
        kw = K + ws
        a, b, c, d, e, f, g, h = state.unbind(0)
        # bits above 32 of the rotations' xors are masked off at the end
        for t in range(64):
            ye = _dbl(e)
            t1 = (h + ((ye >> 6) ^ (ye >> 11) ^ (ye >> 25))
                  + (g ^ (e & (f ^ g))) + kw[t])
            ya = _dbl(a)
            t2 = ((ya >> 2) ^ (ya >> 13) ^ (ya >> 22)) + (
                (a & b) | (c & (a | b)))
            a, b, c, d, e, f, g, h = ((t1 + t2) & _M32, a, b, c,
                                      (d + t1) & _M32, e, f, g)
        new = (state + torch.stack([a, b, c, d, e, f, g, h])) & _M32
        # only rows whose message reaches this block advance
        state = torch.where(blk < nblocks, new, state)
    return state.t().contiguous()


def digest_to_ints(digest: torch.Tensor) -> list[int]:
    """Digests [B, 8] (32-bit words, big-endian order) -> 256-bit ints."""
    out = []
    for row in digest.cpu().tolist():
        v = 0
        for word in row:
            v = (v << 32) | int(word)
        out.append(v)
    return out
