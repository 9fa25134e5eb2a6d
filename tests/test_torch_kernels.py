"""Kernel B1 (paillier_tpu_torch/csrc/rns2_sliding.cu) and what surrounds
it: the wrapper's checks, the __dp4a matrix packing and the launch
counter.  This file imports no JAX, so its GPU tests also run on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On a machine without a GPU the ``cuda``-marked tests skip; the rest run
on the CPU.  Tolerance: exact (residues are integers).
"""

import random

import numpy as np
import pytest
import torch

from paillier_tpu_torch.bigint import rns2 as tr
from paillier_tpu_torch.bigint import sliding_kernel as sk

torch.set_num_threads(2)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.fixture(scope="module")
def eng256_cpu():
    return tr.Rns2Engine(_odd(random.Random(0xB1), 256), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA C++: needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def test_pack_dp4a_layout():
    """Word (q, j) holds rows 4q..4q+3 of column j, byte t = row 4q+t."""
    rng = np.random.default_rng(4)
    C = 128
    e = rng.integers(-128, 128, size=(C, C), dtype=np.int64)
    packed = sk._pack_dp4a(torch.as_tensor(e, dtype=torch.int8)).numpy()
    assert packed.shape == (C // 4, C) and packed.dtype == np.int32
    raw = packed.view(np.uint32)
    for t in range(4):
        byte = ((raw >> (8 * t)) & 0xFF).astype(np.int64)
        assert np.array_equal(np.where(byte > 127, byte - 256, byte),
                              e[t::4, :])
    # a dp4a product of packed words is the int8 matrix product
    lhs = rng.integers(-128, 128, size=(3, C), dtype=np.int64)
    lw = lhs.astype(np.int8).view(np.int32)          # [3, C/4] words
    acc = np.zeros((3, C), np.int64)
    for q in range(C // 4):
        for t in range(4):
            a = (lw[:, q:q + 1].view(np.uint32) >> (8 * t)) & 0xFF
            a = np.where(a > 127, a.astype(np.int64) - 256, a)
            b = (raw[q] >> (8 * t)) & 0xFF
            b = np.where(b > 127, b.astype(np.int64) - 256, b)
            acc += a * b[None, :]
    assert np.array_equal(acc, lhs @ e)


def test_wrapper_checks(eng256_cpu):
    ctx = eng256_cpu.ctx
    k = ctx.k
    ok = torch.zeros((3, 2 * k), dtype=torch.int32)
    sk._check(ctx, ok, 6)
    with pytest.raises(ValueError, match="int32"):
        sk._check(ctx, ok.long(), 6)
    with pytest.raises(ValueError, match="channels"):
        sk._check(ctx, ok[:, :-2], 6)
    with pytest.raises(ValueError, match="window"):
        sk._check(ctx, ok, 9)
    for k_bad in (384, 512, 96):
        bad = ctx._replace(ic1=torch.zeros((5, k_bad), dtype=torch.int32))
        with pytest.raises(ValueError, match="multiple of 64 up to 320"):
            sk._check(bad, torch.zeros((1, 2 * k_bad), dtype=torch.int32), 6)
    meta = torch.zeros((2, 2 * k), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sk.rns2_pow_sliding_b1(ctx, meta, tr.sliding_window_schedule(5, 6))


def test_cpu_tensor_takes_plain_version(eng256_cpu):
    eng = eng256_cpu
    n = eng.spec.N
    x = eng.encode([2, 3, n - 1])
    sched = tr.sliding_window_schedule(1000003, 6)
    before = sk.rns2_pow_sliding_b1.launches
    got = sk.rns2_pow_sliding_b1(eng.ctx, x, sched, 6)
    assert sk.rns2_pow_sliding_b1.launches == before
    assert torch.equal(got, sk.rns2_pow_sliding_plain(eng.ctx, x, sched, 6))
    assert eng.decode(got) == [pow(v, 1000003, n) for v in (2, 3, n - 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows", [(256, 13), (2048, 9)])
def test_kernel_b1_matches_plain_on_cuda(cuda_device, bits, rows):
    """Kernel B1 against the plain ladder on the same CUDA inputs (k = 64
    and k = 192): bit-identical, with fin and -2 skip steps, a ragged
    last tile, and equal to Python's pow."""
    rng = random.Random(bits)
    n = _odd(rng, bits)
    eng = tr.Rns2Engine(n, device=cuda_device)
    xs = [rng.randrange(n) for _ in range(rows)]
    fs = [rng.randrange(n) for _ in range(rows)]
    x, fin = eng.encode(xs), eng.encode(fs)
    e = rng.getrandbits(bits // 2) | (1 << (bits // 2 - 1))
    sched = list(tr.sliding_window_schedule(e, 6)) + [-2, -2]
    before = sk.rns2_pow_sliding_b1.launches
    got = sk.rns2_pow_sliding_b1(eng.ctx, x, sched, 6, fin=fin)
    want = tr.rns2_pow_sliding_plain(eng.ctx, x, sched, 6, fin=fin)
    assert sk.rns2_pow_sliding_b1.launches == before + 1
    assert torch.equal(got, want)
    assert eng.decode(got) == [pow(v, e, n) * f % n for v, f in zip(xs, fs)]
    one = sk.rns2_pow_sliding_b1(eng.ctx, x[0], sched, 6)    # [C] input
    assert eng.decode(one[None]) == [pow(xs[0], e, n)]


@pytest.mark.cuda
def test_slice_on_cuda(cuda_device):
    """Encryptor / Decryptor(crt=True) on the card equal the host formula
    and round-trip, each through kernel B1."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch.core.keys import decode_batch
    sk_, pk = pt.keygen(512, random.Random(5))
    rng = random.Random(6)
    ms = [rng.randrange(pk.n) for _ in range(20)]
    rs = [rng.randrange(1, pk.n) for _ in ms]
    before = sk.rns2_pow_sliding_b1.launches
    ct = pt.Encryptor(pk, device=cuda_device).encrypt(ms, rs)
    assert ct.c.is_cuda
    assert decode_batch(ct.c) == [(1 + m * pk.n) * pow(r, pk.n, pk.n2)
                                  % pk.n2 for m, r in zip(ms, rs)]
    assert pt.Decryptor(sk_, crt=True, device=cuda_device).decrypt(ct) == ms
    assert sk.rns2_pow_sliding_b1.launches == before + 3


@pytest.mark.cuda
def test_dot_i8_on_cuda(cuda_device):
    """The glue's int8 product on the card at the shapes the slice uses,
    including K < 128 at row counts cuBLASLt refuses unpadded."""
    from paillier_tpu_torch.bigint.limbmm import _dot_i8
    rng = np.random.default_rng(9)
    for M, K, N in ((1, 48, 54), (20, 96, 256), (17, 64, 56), (0, 8, 8),
                    (17, 128, 128), (33, 768, 96), (4096, 640, 640)):
        a = rng.integers(-128, 128, size=(M, K), dtype=np.int64)
        b = rng.integers(-128, 128, size=(K, N), dtype=np.int64)
        got = _dot_i8(torch.as_tensor(a, dtype=torch.int8, device=cuda_device),
                      torch.as_tensor(b, dtype=torch.int8, device=cuda_device))
        assert np.array_equal(got.cpu().numpy(), a @ b), (M, K, N)
