"""Kernels B1 (paillier_tpu_torch/csrc/rns2_sliding.cu), B2
(csrc/rns2_modexp.cu), B3 (csrc/rns2_fixed_base.cu), B4
(csrc/limb_modexp.cu) and B4w (csrc/limb_modexp_wide.cu) and what
surrounds them: the wrappers' checks, the
tensor-core matrix packing, B3's comb entry copies, the build hash, the
launch counters, the entry points' default device, and the threshold
path's kernel shapes and its batched SHA-256 on the card.  This
file imports no JAX, so its GPU tests also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On a machine without a GPU the ``cuda``-marked tests skip; the rest run
on the CPU.  Tolerance: exact (residues are integers).
"""

import random

import numpy as np
import pytest
import torch

from paillier_tpu_torch.bigint import cuda_build
from paillier_tpu_torch.bigint import fixed_base_kernel as fb
from paillier_tpu_torch.bigint import modexp_kernel as mx
from paillier_tpu_torch.bigint import mont_kernel as mk
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.bigint import rns2 as tr
from paillier_tpu_torch.bigint import sliding_kernel as sk
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.bigint.montgomery import exp_digits, n_digits_for_bits

torch.set_num_threads(2)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.fixture(scope="module")
def eng256_cpu():
    return tr.Rns2Engine(_odd(random.Random(0xB1), 256), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B4 are CUDA C++: need an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _b4(ctx, x, dig, window=4):
    """The register kernel B4 at its own lane rule (mont_kernel.launch),
    whichever kernel mont_pow_b4 would take for the shape."""
    b, d, squeeze = mk._operands(ctx, x, dig, window, "B4")
    out = mk.launch(ctx, b, d, window, mk.lanes_per_row(
        -(-ctx.n_limbs // 2), b.shape[0], 132))
    return out[0] if squeeze else out


def _rule_kernel(L, rows):
    """The launch counter of the kernel that mont_pow_b4 takes for rows
    of L limbs on this card (mont_kernel.variant)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (mk.mont_pow_b4 if mk.variant(L, rows, sms) == "B4"
            else mk.mont_pow_b4w)


def _mma_emulate(packed, lhs, k, c=None):
    """Kernel B1's base extension as rns2_mont_mma.cuh runs it, in numpy:
    for channel group cg and 64-digit slice s, lane (g, t) takes its A
    fragments (lo and hi, k32 steps u = 0, 1) as 16 bytes of ``packed``
    and its B fragments as bytes 64 s + 16 t .. + 15 of digit row 8 n + g;
    mma.m16n8k32 multiplies fragment row m, column kk of A with row kk,
    column n of B; the lane's sums (row m = g + 8 (j >> 1), column
    n = 2t + (j & 1)) are the lo / hi columns of channel 16 cg + m of
    batch row 8 n + 2t + (j & 1)."""
    R = lhs.shape[0]
    c = c or k                  # columns a half ([2k, 2c] matrices)
    G, S2 = c // 16, k // 32
    P = np.zeros((R, 2 * c), np.int64)
    pk = packed.reshape(G, S2, 2, 2, 32, 16).astype(np.int64)
    for nt in range(R // 8):
        rows = lhs[8 * nt:8 * nt + 8].astype(np.int64)
        acc = np.zeros((G, 2, 32, 4), np.int64)       # [cg, h, lane, j]
        for s in range(S2):
            for u in range(2):
                A = np.zeros((G, 2, 16, 32), np.int64)    # [cg, h, m, kk]
                Bm = np.zeros((32, 8), np.int64)          # [kk, n]
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for r in range(4):
                        for b in range(4):
                            A[:, :, g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + b] \
                                = pk[:, s, u, :, lane, 4 * r + b]
                    for j in range(2):
                        for b in range(4):
                            Bm[16 * j + 4 * t + b, g] = rows[
                                g, 64 * s + 16 * t + 8 * u + 4 * j + b]
                D = A @ Bm                                # [cg, h, m, n]
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for j in range(4):
                        acc[:, :, lane, j] += D[:, :, g + 8 * (j >> 1),
                                                2 * t + (j & 1)]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(4):
                ch = 16 * np.arange(G) + g + 8 * (j >> 1)
                row = 8 * nt + 2 * t + (j & 1)
                P[row, ch] = acc[:, 0, lane, j]
                P[row, c + ch] = acc[:, 1, lane, j]
    return P


@pytest.mark.parametrize("k", [64, 320])
def test_pack_mma_layout(k):
    """Kernel B1's tensor-core packing: unpacking gives E back, and the
    fragment products over the packed words (numpy emulation of the
    kernel's indexing) equal the int8 product lhs @ E (rns2._dot_i8)."""
    from paillier_tpu_torch.bigint.limbmm import _dot_i8
    rng = np.random.default_rng(k)
    C = 2 * k
    e = torch.as_tensor(rng.integers(-128, 128, size=(C, C)), dtype=torch.int8)
    packed = cuda_build.pack_mma(e)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == (k // 16, k // 32, 2, 2, 32, 16)
    # unpacking: (cg, s, u, h, g, t, j, i, b) back to rows (s, t, u, j, b)
    # and columns (h, cg, i, g)
    unpacked = packed.reshape(k // 16, k // 32, 2, 2, 8, 4, 2, 2, 4).permute(
        1, 5, 2, 6, 8, 3, 0, 7, 4).reshape(C, C)
    assert torch.equal(unpacked, e)
    # one fragment checked by hand: channel group 1, slice 0, step u = 1,
    # hi columns, lane (g, t) = (2, 3), register 3 (j = 1, i = 1), byte 2
    assert packed[1, 0, 1, 1, 4 * 2 + 3, 4 * 3 + 2] == \
        e[16 * 3 + 8 * 1 + 4 * 1 + 2, k + 16 * 1 + 8 * 1 + 2]
    lhs = torch.as_tensor(rng.integers(-128, 128, size=(16, C)),
                          dtype=torch.int8)
    want = _dot_i8(lhs, e).numpy()
    assert np.array_equal(want, lhs.numpy().astype(np.int64)
                          @ e.numpy().astype(np.int64))
    assert np.array_equal(_mma_emulate(packed.numpy(), lhs.numpy(), k), want)


def _tbl_fetch(tbl, dig, step, R, k, T, threads):
    """Kernel B3's copy of comb step ``step`` as rns2_mont_mma.cuh's
    tbl_fetch<R> runs it, in numpy: tbl_fetch(cx, o1, o2, tbl + step T 2k,
    rs = 0, dig + step, ds = D) over a block of ``threads`` threads, each
    copy 8 int16.  Returns the two [R k] operand halves and how often each
    element was written."""
    D = dig.shape[1]
    flat_tbl, flat_dig = tbl.reshape(-1), dig.reshape(-1)
    half = k // 8
    o = np.full((2, R * k), -1, np.int64)
    writes = np.zeros((2, R * k), np.int64)
    for tid in range(threads):
        for q in range(tid, R * 2 * half, threads):
            r = q // (2 * half)
            j = q - r * 2 * half
            h = int(j >= half)
            d = flat_dig[step + r * D]
            dst = r * k + 8 * (j - h * half)
            src = step * T * 2 * k + d * 2 * k + 8 * j
            assert dst % 8 == 0 and src % 8 == 0        # 16-byte aligned
            o[h, dst:dst + 8] = flat_tbl[src:src + 8]
            writes[h, dst:dst + 8] += 1
    return o, writes


@pytest.mark.parametrize("k", [64, 320, 512])
@pytest.mark.parametrize("R", [8, 16, 32])
def test_comb_fetch_layout(R, k):
    """Kernel B3's 16-byte copies of each row's comb entry: for random
    per-row digits, every step fills tile row r's operand [R][k] per base
    with exactly table[step 2^w + d_r], each element written once, every
    copy 16-byte aligned."""
    rng = np.random.default_rng(R * 1000 + k)
    D, T = 5, 16
    tbl = rng.integers(0, 1 << 14, size=(D * T, 2 * k))
    dig = rng.integers(0, T, size=(R, D))
    dig[-1] = 0                         # a zero-padded row
    for step in range(D):
        o, writes = _tbl_fetch(tbl, dig, step, R, k, T, threads=2 * k)
        assert (writes == 1).all()
        want = tbl[step * T + dig[:, step]]                 # [R, 2k]
        assert np.array_equal(o[0].reshape(R, k), want[:, :k])
        assert np.array_equal(o[1].reshape(R, k), want[:, k:])


def test_wrapper_checks(eng256_cpu):
    ctx = eng256_cpu.ctx
    k = ctx.k
    ok = torch.zeros((3, 2 * k), dtype=torch.int32)

    def check(c, x, window):
        cuda_build.check_operand(c, x, window, "B1")

    check(ctx, ok, 6)
    with pytest.raises(ValueError, match="int32"):
        check(ctx, ok.long(), 6)
    with pytest.raises(ValueError, match="channels"):
        check(ctx, ok[:, :-2], 6)
    with pytest.raises(ValueError, match="window"):
        check(ctx, ok, 9)
    for k_ok in (384, 512, 704):
        wide = ctx._replace(ic1=torch.zeros((5, k_ok), dtype=torch.int32))
        check(wide, torch.zeros((1, 2 * k_ok), dtype=torch.int32), 6)
    for k_bad in (768, 96, 1024):
        bad = ctx._replace(ic1=torch.zeros((5, k_bad), dtype=torch.int32))
        with pytest.raises(ValueError, match="B1 takes k a multiple of 64 "
                                             "up to 704"):
            check(bad, torch.zeros((1, 2 * k_bad), dtype=torch.int32), 6)
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


def test_cpu_tensor_with_fin_takes_plain_version(eng256_cpu):
    """B1's wrapper on CPU tensors with fin, -2 skip steps and a [C]
    input: the plain ladder, no launch, x^e * fin mod N."""
    eng = eng256_cpu
    n = eng.spec.N
    xs, fs = [5, n - 2, 7], [3, 1, n - 1]
    x, fin = eng.encode(xs), eng.encode(fs)
    sched = list(tr.sliding_window_schedule(65537, 6)) + [-2, -2]
    before = sk.rns2_pow_sliding_b1.launches
    got = sk.rns2_pow_sliding_b1(eng.ctx, x, sched, 6, fin=fin)
    one = sk.rns2_pow_sliding_b1(eng.ctx, x[1], sched, 6, fin=fin[1])
    assert sk.rns2_pow_sliding_b1.launches == before
    assert torch.equal(got, sk.rns2_pow_sliding_plain(eng.ctx, x, sched, 6,
                                                      fin=fin))
    assert eng.decode(got) == [pow(v, 65537, n) * f % n
                               for v, f in zip(xs, fs)]
    assert torch.equal(one, got[1])


def test_b2_wrapper_checks(eng256_cpu):
    """Kernel B2's wrapper refuses what the kernel does not take, before
    it would build or launch: dtype, shape, window and k range, digit
    shape and range, non-CUDA devices."""
    ctx = eng256_cpu.ctx
    k = ctx.k
    ok = torch.zeros((3, 2 * k), dtype=torch.int32)
    dig = torch.zeros(5, dtype=torch.int32)
    meta = ok.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        mx.rns2_pow_b2(ctx, meta, dig)
    for x, window, match in ((ok.long(), 4, "int32"), (ok[:, :-2], 4,
                             "channels"), (ok, 9, "window"),
                             (ok, 0, "window")):
        with pytest.raises(ValueError, match=match):
            cuda_build.check_operand(ctx, x, window, "B2")
    for k_bad in (768, 96):
        bad = ctx._replace(ic1=torch.zeros((5, k_bad), dtype=torch.int32))
        with pytest.raises(ValueError, match="B2 takes k a multiple of 64 "
                                             "up to 704"):
            cuda_build.check_operand(
                bad, torch.zeros((1, 2 * k_bad), dtype=torch.int32), 4, "B2")
    mx._check_digits(dig, 3, 4)
    mx._check_digits(torch.full((3, 7), 15, dtype=torch.int64), 3, 4)
    for d, match in ((torch.full((5,), 16), "below|lie in"),
                     (torch.full((5,), -1), "lie in"),
                     (torch.zeros((2, 5), dtype=torch.int32), "rows"),
                     (torch.zeros((3, 0), dtype=torch.int32), "at least"),
                     (torch.zeros((1, 3, 5), dtype=torch.int32), "integers"),
                     (torch.zeros(5), "integers")):
        with pytest.raises(ValueError, match=match):
            mx._check_digits(d, 3, 4)


@pytest.mark.parametrize("per_row", [False, True])
def test_b2_cpu_tensor_takes_plain_version(eng256_cpu, per_row):
    eng = eng256_cpu
    n = eng.spec.N
    xs = [2, 3, n - 1, 12345]
    x = eng.encode(xs)
    es = [1000003, 0, 65537, n - 2] if per_row else [1000003] * 4
    nd = n_digits_for_bits(max(e.bit_length() for e in es), 4)
    dig = np.stack([exp_digits(e, 4, nd) for e in es])
    digits = torch.as_tensor(dig if per_row else dig[0])
    before = mx.rns2_pow_b2.launches
    got = mx.rns2_pow_b2(eng.ctx, x, digits, 4)
    assert mx.rns2_pow_b2.launches == before
    assert torch.equal(got, mx.rns2_pow_plain(eng.ctx, x, digits, 4))
    assert torch.equal(got, tr.rns2_pow(eng.ctx, x, digits, 4))
    assert eng.decode(got) == [pow(v, e, n) for v, e in zip(xs, es)]


def test_build_hash_covers_included_headers(tmp_path):
    """An edit of a header that a kernel source includes changes the
    build's name, so a stale library is never loaded."""
    for name in ("rns2_sliding.cu", "rns2_modexp.cu", "rns2_fixed_base.cu"):
        assert [f.name for f in cuda_build.source_files(
            cuda_build.CSRC / name)] == [
            name, "rns2_mont_mma.cuh", "rns2_mont.cuh"]
    assert [f.name for f in cuda_build.source_files(
        cuda_build.CSRC / "limb_modexp.cu")] == ["limb_modexp.cu"]
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "a.cuh"\n#include <cstdint>\n')
    assert [f.name for f in cuda_build.source_files(src)] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = cuda_build.source_hash(src)
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert cuda_build.source_hash(src) != before


def test_b3_wrapper_checks(eng256_cpu):
    """Kernel B3's wrapper refuses what the kernel does not take, before
    it would build or launch, and takes a CPU table to the plain comb."""
    eng = eng256_cpu
    n = eng.spec.N
    table = tr.build_fixed_base_table(eng, 3, 4, 4)         # D = 4 digits
    dig = torch.as_tensor([[1, 2, 3, 4], [0, 0, 0, 15]])
    before = fb.rns2_pow_fixed_base_b3.launches
    got = fb.rns2_pow_fixed_base_b3(eng.ctx, table, dig, 4)
    assert fb.rns2_pow_fixed_base_b3.launches == before
    assert eng.decode(got) == [pow(3, 0x1234, n), pow(3, 15, n)]
    with pytest.raises(ValueError, match="CUDA"):
        fb.rns2_pow_fixed_base_b3(eng.ctx, table.to("meta"), dig, 4)


def test_b4_wrapper_constants_and_cpu_path():
    """Kernel B4's wrapper: a CPU tensor runs the plain ladder without a
    launch; the kernel's constants are n, R^2 mod n and the low word of
    -n^-1 mod R, rebuilt for R = 2^(16 (L + 1)) at an odd L; rows per
    block follow the shared memory of a row."""
    rng = random.Random(0xB4)
    for bits, L in ((96, 6), (80, 5), (2048, 128)):
        n = _odd(rng, bits)
        ctx = tmont.make_mont_ctx(n, device="cpu")
        kn, n0, r2, Lk = mk._kernel_ctx(ctx)
        assert Lk == L + L % 2 and kn.dtype == torch.int32
        R = 1 << (16 * Lk)
        assert int(n0[0]) % (1 << 32) == (-pow(n, -1, 1 << 32)) % (1 << 32)
        want = tmont.make_mont_ctx(n, Lk, device="cpu")
        assert torch.equal(kn.long(), want.n)
        assert torch.equal(r2.long(), want.r2)
        assert int(sum(int(v) << (16 * i) for i, v in enumerate(r2))) == \
            R * R % n
    stacked = tmont.stack_mont_ctx([_odd(rng, 80) for _ in range(3)], 5,
                                   device="cpu")
    kn, n0, r2, Lk = mk._kernel_ctx(stacked)
    assert kn.shape == (3, 6) and n0.shape == (3,) and r2.shape == (3, 6)
    assert mk.rows_per_block(5124, 32) == 32          # nw = 64, w = 4
    assert mk.rows_per_block(10244, 32) == 22         # nw = 128, w = 4
    with pytest.raises(ValueError, match="window"):
        mk.rows_per_block(300000, 32)
    n = _odd(rng, 128)
    ctx = tmont.make_mont_ctx(n, device="cpu")
    xs = [2, 3, n - 1]
    x = torch.as_tensor(host.ints_to_limbs(xs, 8).astype(np.int64))
    digits = torch.as_tensor(exp_digits(65537, 4, 5))
    before = mk.mont_pow_b4.launches
    got = mk.mont_pow_b4(ctx, x, digits, 4)
    assert mk.mont_pow_b4.launches == before
    assert host.limbs_to_ints(got.numpy()) == [pow(v, 65537, n) for v in xs]
    with pytest.raises(ValueError, match="CUDA"):
        mk.mont_pow_b4(ctx, x.to("meta"), digits, 4)


def test_b4_launch_shape():
    """Kernel B4's launch shape: the fewest lanes a row (4 to 32) whose
    rows give 6 warps an SM, else the most; every lane count leaves a
    number of words a lane that the kernel takes; the words are padded to
    a multiple of the lanes and the constants rebuilt for the larger R."""
    # an H100's 132 SMs: extract_randomness at levels 1 and 2, the
    # Fermat batch, and the row counts on either side of each change of
    # the fastest lane count in the sweep of PERF.md §6 (L = 128, 256)
    assert mk.lanes_per_row(64, 4096, 132) == 8
    assert mk.lanes_per_row(64, 2048, 132) == 16
    assert mk.lanes_per_row(64, 1024, 132) == 32
    assert mk.lanes_per_row(32, 64, 132) == 32
    assert [mk.lanes_per_row(64, rows, 132) for rows in (1536, 1792, 3072,
                                                         3584)
            ] == [32, 16, 16, 8]
    assert [mk.lanes_per_row(128, rows, 132) for rows in (1024, 2048, 4096)
            ] == [32, 16, 16]
    assert [mk.lanes_per_row(nw, 1, 132) for nw in (1, 3, 5, 8, 48, 100)
            ] == [4, 4, 4, 8, 32, 32]
    assert [mk.lanes_per_row(nw, 10 ** 6, 132) for nw in (3, 8, 48, 100)
            ] == [4, 4, 16, 32]
    for nw in range(1, 129):
        for rows in (1, 1024, 4096, 10 ** 6):
            tpi = mk.lanes_per_row(nw, rows, 132)
            assert mk.padded_words(nw, tpi) // tpi in mk.WORDS_PER_LANE
    rng = random.Random(0xB45)
    n = _odd(rng, 80)                                   # L = 5, nw = 3
    ctx = tmont.make_mont_ctx(n, device="cpu")
    kn, n0, r2, Lk = mk._kernel_ctx(ctx, mk.padded_words(3, 4))
    assert Lk == 8 and kn.shape == (8,)
    assert int(n0[0]) % (1 << 32) == (-pow(n, -1, 1 << 32)) % (1 << 32)
    assert host.limbs_to_ints(r2[None].long().numpy()) == [
        (1 << 256) % n]


M32 = (1 << 32) - 1


def _lookahead(gen, prop):
    """limb_modexp.cu lookahead(): the carries into each lane and out of
    the group of a sum whose lanes generate or propagate one."""
    G = sum(1 << lane for lane, v in enumerate(gen) if v)
    P = sum(1 << lane for lane, v in enumerate(prop) if v)
    assert not G & P                     # never both in one lane
    c = ((G | P) + G) ^ (G | P) ^ G
    return [(c >> lane) & 1 for lane in range(len(gen))], (c >> len(gen)) & 1


def _lanes_mont_mul(a, b, n, n0):
    """One Montgomery product as kernel B4's mont_mul computes it, lane by
    lane, in Python: a, b, n are [tpi][W] words (lane l holds words
    l W .. l W + W - 1).  Returns the lanes' words of a b R^-1 mod n,
    R = 2^(32 tpi W), and checks the kernel's bounds on the way."""
    tpi, W = len(a), len(a[0])
    t = [[0] * W for _ in range(tpi)]
    cy = [0] * tpi                       # pending at each lane's word 0
    tx = 0                               # top lane: the bit above the top
    for src in range(tpi):
        for wb in range(W):
            bi = b[src][wb]                                  # broadcast
            m = ((t[0][0] + a[0][0] * bi) * n0) & M32        # from lane 0
            u, co = [], []
            for lane in range(tpi):
                c1, c2, ul = cy[lane], 0, []
                for w in range(W):
                    p = a[lane][w] * bi + t[lane][w] + c1
                    c1 = p >> 32
                    q = m * n[lane][w] + (p & M32) + c2
                    c2 = q >> 32
                    assert p < 1 << 64 and q < 1 << 64
                    ul.append(q & M32)
                u.append(ul)
                co.append(c1 + c2)                           # < 2^33
            assert u[0][0] == 0
            new_t, new_cy = [], []
            for lane in range(tpi):
                top = lane == tpi - 1
                above = tx if top else u[lane + 1][0]        # shfl_down
                s = above + co[lane]
                new_t.append(u[lane][1:] + [s & M32])
                if top:
                    tx = s >> 32
                below = co[lane - 1] if lane else 0          # shfl_up
                new_cy.append((u[lane][0] + below) >> 32 if lane else 0)
            t, cy = new_t, new_cy
            assert max(cy) <= 2 and tx <= 1
    # resolve: each lane's own pending carry, then the carries between
    # lanes by lookahead
    gen, prop = [], []
    for lane in range(tpi):
        c = cy[lane]
        for w in range(W):
            v = t[lane][w] + c
            t[lane][w], c = v & M32, v >> 32
        gen.append(c != 0)
        prop.append(all(x == M32 for x in t[lane]))
    cin, cout = _lookahead(gen, prop)
    for lane in range(tpi):
        c = cin[lane]
        for w in range(W):
            v = t[lane][w] + c
            t[lane][w], c = v & M32, v >> 32
    tx += cout
    # conditional subtract of n, borrows by the same lookahead
    d, gen, prop = [], [], []
    for lane in range(tpi):
        bw, dl = 0, []
        for w in range(W):
            v = t[lane][w] - n[lane][w] - bw
            dl.append(v & M32)
            bw = int(v < 0)
        d.append(dl)
        gen.append(bw != 0)
        prop.append(all(x == 0 for x in dl))
    bin_, bout = _lookahead(gen, prop)
    for lane in range(tpi):
        bw = bin_[lane]
        for w in range(W):
            v = d[lane][w] - bw
            d[lane][w] = v & M32
            bw = int(v < 0)
    return d if tx != 0 or bout == 0 else t


def _to_lanes(v, tpi, W):
    return [[(v >> (32 * (lane * W + w))) & M32 for w in range(W)]
            for lane in range(tpi)]


def _from_lanes(lanes):
    W = len(lanes[0])
    return sum(x << (32 * (lane * W + w)) for lane, ws in enumerate(lanes)
               for w, x in enumerate(ws))


@pytest.mark.parametrize("nw,tpi", [
    (3, 4), (8, 4), (8, 8), (8, 16), (8, 32), (32, 4), (32, 8), (32, 16),
    (32, 32), (64, 8), (64, 16), (64, 32), (384, 32)])
def test_b4_lane_arithmetic(nw, tpi):
    """Kernel B4's Montgomery product with a group of ``tpi`` lanes a row,
    emulated lane by lane (word broadcasts of b_i and m_i, carry-save
    words, the carry and borrow lookahead across lanes, the conditional
    subtract) on nw-word moduli padded to tpi * W words: equal to
    a b R^-1 mod n in Python integers and to the plain mont_mul, on
    random operands, all-ones words and moduli just below 2^(32 nw)."""
    W = mk.padded_words(nw, tpi) // tpi
    assert W in mk.WORDS_PER_LANE
    R = 1 << (32 * tpi * W)
    top = 1 << (32 * nw)
    rng = random.Random(nw * 64 + tpi)
    moduli = [_odd(rng, 32 * nw), top - 1, top - 3,
              top - (1 << (32 * nw // 2)) + 1, (top >> 1) + 1]
    for n in moduli:
        n0 = (-pow(n, -1, 1 << 32)) % (1 << 32)
        ctx = tmont.make_mont_ctx(n, 2 * tpi * W, device="cpu")
        for a, b in [(rng.randrange(n), rng.randrange(n)), (n - 1, n - 1),
                     (R - 1, n - 1), (R - 1, rng.randrange(n)), (0, n - 1),
                     (1, 1), (rng.randrange(R), 1)]:
            got = _from_lanes(_lanes_mont_mul(
                _to_lanes(a, tpi, W), _to_lanes(b, tpi, W),
                _to_lanes(n, tpi, W), n0))
            want = a * b * pow(R, -1, n) % n
            assert got == want, (n, a, b)
            if a < n:
                plain = tmont.mont_mul(
                    ctx, *(torch.as_tensor(host.ints_to_limbs(
                        [v], 2 * tpi * W).astype(np.int64)) for v in (a, b)))
                assert host.limbs_to_ints(plain.numpy()) == [want]


def _b1_against_plain(eng, rng, rows, e_bits, fin, tile):
    """Kernel B1 against the plain ladder on ``rows`` rows, whose tile the
    launcher's rule must pick as ``tile`` (row counts chosen for an H100's
    132 SMs): bit-identical, one launch, and (on up to 65 rows) equal to
    Python's pow."""
    assert sk.load().rns2_sliding_rows(rows, eng.spec.k) == tile, \
        "the row counts are chosen for an H100 (132 SMs)"
    n = eng.spec.N
    xs = [rng.randrange(n) for _ in range(rows)]
    fs = [rng.randrange(n) for _ in range(rows)] if fin else [1] * rows
    x = eng.encode(xs)
    f = eng.encode(fs) if fin else None
    e = rng.getrandbits(e_bits) | (1 << (e_bits - 1))
    sched = list(tr.sliding_window_schedule(e, 6)) + [-2, -2]
    want = tr.rns2_pow_sliding_plain(eng.ctx, x, sched, 6, fin=f)
    before = sk.rns2_pow_sliding_b1.launches
    got = sk.rns2_pow_sliding_b1(eng.ctx, x, sched, 6, fin=f)
    assert sk.rns2_pow_sliding_b1.launches == before + 1
    assert torch.equal(got, want), (rows, tile, fin)
    m = min(rows, 65)              # Python's pow on the first rows only
    assert eng.decode(want[:m]) == [pow(v, e, n) * w % n
                                    for v, w in zip(xs[:m], fs[:m])]
    return eng, x, xs, sched, e


@pytest.mark.cuda
@pytest.mark.parametrize("fin", [True, False])
@pytest.mark.parametrize("bits,rows,tile", [
    (256, 13, 8), (2048, 9, 8), (256, 1, 8), (256, 33, 8), (2048, 31, 8),
    (2048, 65, 8), (4096, 33, 8), (4096, 1063, 16), (4096, 2143, 32),
    (2048, 2143, 32)])
def test_kernel_b1_matches_plain_on_cuda(cuda_device, bits, rows, tile, fin):
    """Kernel B1 against the plain ladder on the same CUDA inputs (k = 64,
    192 and 320) with tiles of 8, 16 and 32 rows, each picked by the
    launcher's rule, on row counts that are not a multiple of a tile:
    bit-identical, with and without fin, with -2 skip steps, and equal to
    Python's pow."""
    rng = random.Random(bits + rows)
    eng = tr.Rns2Engine(_odd(rng, bits), device=cuda_device)
    assert eng.spec.k == {256: 64, 2048: 192, 4096: 320}[bits]
    eng, x, xs, sched, e = _b1_against_plain(
        eng, rng, rows, min(bits // 2, 512), fin, tile)
    one = sk.rns2_pow_sliding_b1(eng.ctx, x[0], sched, 6)    # [C] input
    assert eng.decode(one[None]) == [pow(xs[0], e, eng.spec.N)]


def test_entry_points_default_to_the_card():
    """Every entry point of the port runs on the card unless the caller
    asks for the CPU."""
    import inspect
    import paillier_tpu_torch as pt
    from paillier_tpu_torch.core import decrypt as cdec
    from paillier_tpu_torch.core import keygen as ckg
    from paillier_tpu_torch.core.keys import PublicKey
    for fn in (pt.Encryptor, pt.nested_encrypt, pt.Decryptor,
               pt.nested_decrypt, cdec.decrypt_nested_layer, PublicKey.device,
               ckg.keygen, ckg.device_batched_prime):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_encryptor_without_cuda_raises():
    """On a machine without CUDA, Encryptor(pk) raises: it does not go on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    import paillier_tpu_torch as pt
    _, pk = pt.keygen(128, random.Random(12), device_primes=False,
                      device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        pt.Encryptor(pk)
    assert pk.device().device.type == "cuda"


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


@pytest.mark.cuda
@pytest.mark.parametrize("fin", [True, False])
@pytest.mark.parametrize("bits,rows,tile", [
    (4600, 11, 8), (6144, 9, 8), (8192, 5, 8), (6144, 33, 8), (8192, 65, 8),
    (7168, 9, 8), (7680, 31, 8), (4600, 1039, 16), (6144, 1039, 16),
    (8192, 1039, 16)])
def test_kernel_b1_wide_matches_plain_on_cuda(cuda_device, bits, rows, tile,
                                              fin):
    """Kernel B1 on wide contexts: k = 384 (no pre-reduction), k = 512 (n^3
    of a 2048-bit key), k = 576 and 640, and k = 704 (n^2 of a 4096-bit
    key), tiles of 8 and 16 rows picked by the launcher's rule, with and
    without fin, ragged last tiles: bit-identical to the plain ladder and
    to pow."""
    rng = random.Random(bits + rows)
    eng = tr.Rns2Engine(_odd(rng, bits), device=cuda_device)
    assert eng.spec.k == {4600: 384, 6144: 512, 7168: 576, 7680: 640,
                          8192: 704}[bits]
    _b1_against_plain(eng, rng, rows, 96, fin, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows,window", [(256, 13, 4), (256, 5, 1),
                                              (256, 9, 8), (4096, 9, 4),
                                              (6144, 3, 4)])
def test_kernel_b2_matches_plain_on_cuda(cuda_device, bits, rows, window):
    """Kernel B2 against the plain ladder at k = 64, 320 and 512, shared and
    per-row digits (a zero exponent and zero digits included): bit-identical
    and equal to Python's pow."""
    rng = random.Random(bits + window)
    n = _odd(rng, bits)
    eng = tr.Rns2Engine(n, device=cuda_device)
    xs = [rng.randrange(n) for _ in range(rows)]
    x = eng.encode(xs)
    es = [rng.getrandbits(64) for _ in range(rows - 1)] + [0]
    nd = n_digits_for_bits(64, window)
    per = torch.as_tensor(np.stack([exp_digits(e, window, nd) for e in es]),
                          device=cuda_device)
    for digits, want_e in ((per, es), (per[0], [es[0]] * rows)):
        before = mx.rns2_pow_b2.launches
        got = mx.rns2_pow_b2(eng.ctx, x, digits, window)
        want = mx.rns2_pow_plain(eng.ctx, x, digits, window)
        assert mx.rns2_pow_b2.launches == before + 1
        assert torch.equal(got, want)
        assert eng.decode(got) == [pow(v, e, n) for v, e in zip(xs, want_e)]
    one = mx.rns2_pow_b2(eng.ctx, x[0], per[0], window)     # [C] input
    assert eng.decode(one[None]) == [pow(xs[0], es[0], n)]


@pytest.mark.cuda
def test_level2_and_homomorphic_on_cuda(cuda_device):
    """Level-2 encryption / decryption, nested_add and a per-element
    const_mult on the card, through kernels B1 and B2."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch import homomorphic as hom
    sk_, pk = pt.keygen(512, random.Random(7))
    rng = random.Random(8)
    b1_0, b2_0 = sk.rns2_pow_sliding_b1.launches, mx.rns2_pow_b2.launches
    m2 = [rng.randrange(pk.n2) for _ in range(6)] + [0]
    c2 = pt.Encryptor(pk, 2, rng=rng, device=cuda_device).encrypt(m2)
    assert pt.Decryptor(sk_, 2, device=cuda_device).decrypt(c2) == m2
    xs = [rng.randrange(pk.n) for _ in range(5)]
    ys = [rng.randrange(pk.n) for _ in range(5)]
    nx = pt.nested_encrypt(pk, xs, rng, device=cuda_device)
    cy = pt.Encryptor(pk, rng=rng, device=cuda_device).encrypt(ys)
    assert pt.nested_decrypt(sk_, hom.nested_add(pk, nx, cy),
                             device=cuda_device) == [
        (a + b) % pk.n for a, b in zip(xs, ys)]
    ks = [rng.randrange(pk.n) for _ in ys]
    dec = pt.Decryptor(sk_, crt=True, device=cuda_device)
    assert dec.decrypt(hom.const_mult(pk, cy, ks)) == [
        a * k % pk.n for a, k in zip(ys, ks)]
    assert sk.rns2_pow_sliding_b1.launches > b1_0
    assert mx.rns2_pow_b2.launches == b2_0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows,tile,e_bits,fin", [
    (256, 13, 8, 64, True), (256, 5, 8, 4, False), (256, 9, 8, 8, True),
    (4096, 9, 8, 60, False), (4096, 1055, 8, 64, True),
    (4096, 1063, 16, 60, False), (4096, 2143, 32, 64, True),
    (6144, 5, 8, 64, True), (6144, 1039, 16, 60, False),
    (8192, 37, 8, 64, True), (8192, 1039, 16, 60, False)])
def test_kernel_b3_matches_plain_on_cuda(cuda_device, bits, rows, tile,
                                         e_bits, fin):
    """Kernel B3 against the plain comb at k = 64, 320, 512 and 704, with
    tiles of 8, 16 and 32 rows, each picked by the launcher's rule (row
    counts chosen for an H100's 132 SMs), ragged last tiles, 1, 2, 15 and
    16 digits, with and without fin, and zero digits: bit-identical, one
    launch, and the first 65 rows equal to Python's pow."""
    rng = random.Random(bits + rows + e_bits)
    n = _odd(rng, bits)
    eng = tr.Rns2Engine(n, device=cuda_device)
    assert eng.spec.k == {256: 64, 4096: 320, 6144: 512, 8192: 704}[bits]
    assert fb.load().rns2_fixed_base_rows(rows, eng.spec.k) == tile, \
        "the row counts are chosen for an H100 (132 SMs)"
    base = rng.randrange(2, n)
    es = [rng.getrandbits(e_bits) for _ in range(rows - 1)] + [0]
    fs = [rng.randrange(n) for _ in range(rows)] if fin else [1] * rows
    nd = n_digits_for_bits(e_bits, 4)
    dig = torch.as_tensor(np.stack([exp_digits(e, 4, nd) for e in es]),
                          device=cuda_device)
    table = tr.build_fixed_base_table(eng, base, nd, 4)
    f = eng.encode(fs) if fin else None
    before = fb.rns2_pow_fixed_base_b3.launches
    got = fb.rns2_pow_fixed_base_b3(eng.ctx, table, dig, 4, fin=f)
    want = tr.rns2_pow_fixed_base_plain(eng.ctx, table, dig, 4, fin=f)
    assert fb.rns2_pow_fixed_base_b3.launches == before + 1
    assert torch.equal(got, want)
    m = min(rows, 65)              # Python's pow on the first rows only
    rows_pow = list(range(m - 1)) + [rows - 1]          # the zero exponent
    assert eng.decode(got[rows_pow]) == [pow(base, es[i], n) * fs[i] % n
                                         for i in rows_pow]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows", [(256, 37), (80, 5), (2048, 3),
                                       (1024, 37), (2048, 21), (4096, 7),
                                       (1536, 11), (112, 3)])
def test_kernel_b4_matches_plain_on_cuda(cuda_device, bits, rows):
    """Kernel B4 against the plain ladder at L = 16, 64, 128 and 256, L = 96
    (padded to 128) and odd L (80 and 112 bits), with the lanes a row the
    launcher picks for a few rows (4 to 32): shared and per-row digits on a
    shared modulus, and per-row
    moduli with per-row exponents (the Fermat batch's form), on row
    counts that leave a block's tail ragged: equal limbs and equal to
    Python's pow."""
    rng = random.Random(bits + 4)
    L = host.limbs_for_bits(bits)
    tpi = mk.lanes_per_row(-(-L // 2), rows, 132)
    assert tpi == {16: 8, 5: 4, 128: 32, 64: 32, 256: 32, 96: 32, 7: 4}[L]
    assert rows % (mk.BLOCK_THREADS // tpi)
    n = _odd(rng, bits)
    ctx = tmont.make_mont_ctx(n, device=cuda_device)
    xs = [rng.randrange(n) for _ in range(rows)]
    x = torch.as_tensor(host.ints_to_limbs(xs, L).astype(np.int64),
                        device=cuda_device)
    es = [rng.getrandbits(64) for _ in range(rows - 1)] + [0]
    nd = n_digits_for_bits(64, 4)
    per = torch.as_tensor(np.stack([exp_digits(e, 4, nd) for e in es]),
                          device=cuda_device)
    for digits, want_e in ((per, es), (per[0], [es[0]] * rows)):
        before = mk.mont_pow_b4.launches
        got = _b4(ctx, x, digits, 4)
        assert mk.mont_pow_b4.launches == before + 1
        assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, digits, 4))
        assert host.limbs_to_ints(got.cpu().numpy()) == [
            pow(v, e, n) for v, e in zip(xs, want_e)]
    mods = [_odd(rng, bits) for _ in range(rows)]
    sctx = tmont.stack_mont_ctx(mods, L, device=cuda_device)
    got = _b4(sctx, x, per, 4)
    assert torch.equal(got, tmont.mont_pow_digits_plain(sctx, x, per, 4))
    assert host.limbs_to_ints(got.cpu().numpy()) == [
        pow(v, e, m) for v, e, m in zip(xs, es, mods)]


@pytest.mark.cuda
@pytest.mark.parametrize("tpi,rows", [(4, 1), (4, 45), (8, 3), (8, 45),
                                      (16, 5), (16, 45), (32, 2), (32, 45)])
def test_kernel_b4_lanes_and_blocks_on_cuda(cuda_device, tpi, rows):
    """Kernel B4 with every lane count it takes (4 to 32 lanes a row, 8 to
    1 words a lane at L = 64), per-row moduli and digits on fewer rows
    than a block holds and on 45 rows, which leave the last block ragged
    at every lane count: equal to the plain ladder and Python's pow."""
    rng = random.Random(tpi * 100 + rows)
    assert rows < mk.BLOCK_THREADS // tpi or rows % (mk.BLOCK_THREADS // tpi)
    mods = [_odd(rng, 1024) for _ in range(rows)]
    sctx = tmont.stack_mont_ctx(mods, 64, device=cuda_device)
    xs = [rng.randrange(m) for m in mods]
    x = torch.as_tensor(host.ints_to_limbs(xs, 64).astype(np.int64),
                        device=cuda_device)
    es = [rng.getrandbits(96) for _ in range(rows - 1)] + [0]
    dig = torch.as_tensor(np.stack([exp_digits(e, 4, 24) for e in es]),
                          device=cuda_device)
    before = mk.mont_pow_b4.launches
    got = mk.launch(sctx, x, dig, 4, tpi)
    assert mk.mont_pow_b4.launches == before + 1
    assert torch.equal(got, tmont.mont_pow_digits_plain(sctx, x, dig, 4))
    assert host.limbs_to_ints(got.cpu().numpy()) == [
        pow(v, e, m) for v, e, m in zip(xs, es, mods)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows,tile,window", [
    (4096, 33, 8, 4), (4096, 1063, 16, 1), (4096, 2143, 32, 8),
    (4096, 2143, 32, 4), (6144, 1039, 16, 4), (6144, 33, 8, 8)])
def test_kernel_b2_tiles_on_cuda(cuda_device, bits, rows, tile, window):
    """Kernel B2 with tiles of 8, 16 and 32 rows, each picked by the
    launcher's rule (row counts chosen for an H100's 132 SMs), on ragged
    row counts at k = 320 and 512, windows 1, 4 and 8, shared and per-row
    digits with a zero exponent: bit-identical to the plain ladder, one
    launch each, and the first 65 rows equal to Python's pow."""
    rng = random.Random(bits + rows + window)
    n = _odd(rng, bits)
    eng = tr.Rns2Engine(n, device=cuda_device)
    assert mx.load().rns2_modexp_rows(rows, eng.spec.k) == tile, \
        "the row counts are chosen for an H100 (132 SMs)"
    xs = [rng.randrange(n) for _ in range(rows)]
    x = eng.encode(xs)
    es = [rng.getrandbits(64) for _ in range(rows - 2)] + [0, (1 << 64) - 1]
    nd = n_digits_for_bits(64, window)
    per = torch.as_tensor(np.stack([exp_digits(e, window, nd) for e in es]),
                          device=cuda_device)
    m = min(rows, 65)              # Python's pow on the first rows only
    for digits, want_e in ((per, es), (per[-1], [es[-1]] * rows)):
        before = mx.rns2_pow_b2.launches
        got = mx.rns2_pow_b2(eng.ctx, x, digits, window)
        assert mx.rns2_pow_b2.launches == before + 1
        assert torch.equal(got, mx.rns2_pow_plain(eng.ctx, x, digits, window))
        assert eng.decode(got[:m]) == [pow(v, e, n) for v, e in
                                       zip(xs[:m], want_e[:m])]


# rows at which the launcher's rule picks each tile at k = 256 (DDLEQ's
# p^3 / q^3 halves): searched on the card, not assumed
_K256_ROWS = (1, 5, 13, 33, 65, 129, 257, 529, 1063, 1553, 2143, 3001,
              4099, 5120)


def _rows_for_tile(rule, k, tile):
    for rows in _K256_ROWS:
        if rule(rows, k) == tile:
            return rows
    pytest.fail(f"the tile rule picks no {tile}-row tile at k = {k} for "
                f"any of {_K256_ROWS} rows")


@pytest.mark.cuda
@pytest.mark.parametrize("fin", [True, False])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_kernel_b1_k256_tiles_on_cuda(cuda_device, tile, fin):
    """Kernel B1 at k = 256 (a 3,072-bit modulus: the width of DDLEQ's
    p^3 and q^3 ladders at 2048 bits) with each tile of 8, 16 and 32
    rows, on a row count at which the launcher's rule picks it:
    bit-identical to the plain ladder and to pow."""
    rng = random.Random(0x256 + tile)
    eng = tr.Rns2Engine(_odd(rng, 3072), device=cuda_device)
    assert eng.spec.k == 256
    rows = _rows_for_tile(sk.load().rns2_sliding_rows, 256, tile)
    _b1_against_plain(eng, rng, rows, 96, fin, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_kernel_b2_k256_tiles_on_cuda(cuda_device, tile):
    """Kernel B2 at k = 256 with each tile, per-row and shared digits (a
    zero exponent included): bit-identical to the plain ladder, one
    launch each, and the first 65 rows equal to pow."""
    rng = random.Random(0xB256 + tile)
    n = _odd(rng, 3072)
    eng = tr.Rns2Engine(n, device=cuda_device)
    assert eng.spec.k == 256
    rows = _rows_for_tile(mx.load().rns2_modexp_rows, 256, tile)
    xs = [rng.randrange(n) for _ in range(rows)]
    x = eng.encode(xs)
    es = [rng.getrandbits(64) for _ in range(rows - 1)] + [0]
    per = torch.as_tensor(np.stack([exp_digits(e, 4, 16) for e in es]),
                          device=cuda_device)
    m = min(rows, 65)
    for digits, want_e in ((per, es), (per[0], [es[0]] * rows)):
        before = mx.rns2_pow_b2.launches
        got = mx.rns2_pow_b2(eng.ctx, x, digits, 4)
        assert mx.rns2_pow_b2.launches == before + 1
        assert torch.equal(got, mx.rns2_pow_plain(eng.ctx, x, digits, 4))
        assert eng.decode(got[:m]) == [pow(v, e, n) for v, e in
                                       zip(xs[:m], want_e[:m])]


@pytest.mark.cuda
def test_ddleq_on_cuda(cuda_device):
    """DDLEQ at a 256-bit key on the card: prove (with the p^3/q^3 split:
    B1 7, B2 8, B4 1; without: B1 6, B2 5, B4 1) and verify (B1 2, B2 1),
    each with one SHA-256 launch, give the CPU's proof and verdicts from
    the same inputs and seed; a tampered instance fails its proof only;
    the two-chunk pipeline's verdicts equal the serial ones."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch.core.keys import Ciphertext
    from paillier_tpu_torch.ops import sha256 as sha
    from paillier_tpu_torch.zk import ddleq as zd

    def counts():
        return (sk.rns2_pow_sliding_b1.launches, mx.rns2_pow_b2.launches,
                mk.mont_pow_b4.launches, sha.sha256_bytes.launches)

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    skey, pk = pt.keygen(256, random.Random(0xDD), device="cpu")
    rng = random.Random(0xDE)
    ct1 = pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(5)],
                            rng, device="cpu")
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    want = zd.prove(skey, ct1, ct2, a_l, b_l, 8, random.Random(3))
    g1 = Ciphertext(c=ct1.c.to(cuda_device), level=2)
    g2 = Ciphertext(c=ct2.c.to(cuda_device), level=2)
    for use_crt, launches in ((True, (7, 8, 1, 1)), (False, (6, 5, 1, 1))):
        c0 = counts()
        got = zd.prove(skey, g1, g2, a_l, b_l, 8, random.Random(3),
                       use_crt=use_crt)
        assert delta(c0) == launches
        for f in ("x", "y", "alpha", "e", "f"):
            assert getattr(got, f).device.type == "cuda"
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    c0 = counts()
    assert zd.verify(pk, g1, g2, got) == [True] * 5
    assert delta(c0) == (2, 1, 0, 1)
    ints = got.to_ints()
    ints["f"][2][1] = (ints["f"][2][1] + 1) % pk.n3
    bad = zd.DDLEQProof.from_ints(L=pk.device(cuda_device).L,
                                  device=cuda_device, **ints)
    assert zd.verify(pk, g1, g2, bad) == [True, True, False, True, True]
    jobs = [(g1, g2, a_l, b_l, random.Random(10 + i)) for i in range(2)]
    c0 = counts()
    assert list(zd.pipeline_prove_verify(skey, jobs, 8, verify_pk=pk)) == \
        [[True] * 5] * 2
    assert delta(c0) == (18, 18, 2, 4)


@pytest.mark.cuda
def test_alt_extract_and_prime_search_on_cuda(cuda_device):
    """Alternative encryption (B3, one launch per call) at levels 1 and 2,
    extract_randomness (B4) and the device prime search (B4, one launch
    per Fermat batch) on the card."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch import homomorphic as hom
    from paillier_tpu_torch.core import keygen as kg
    from paillier_tpu_torch.core.keys import decode_batch
    sk_, pk = pt.keygen(512, random.Random(9))
    rng = random.Random(10)
    for level in (1, 2):
        ms = [rng.randrange(pk.plaintext_modulus(level)) for _ in range(6)]
        rs = [rng.randrange(1, pk.n) for _ in ms]
        b3 = fb.rns2_pow_fixed_base_b3.launches
        ct = pt.Encryptor(pk, level, pt.ALTERNATIVE,
                          device=cuda_device).encrypt(ms, rs)
        assert fb.rns2_pow_fixed_base_b3.launches == b3 + 1
        N = pk.modulus_for_level(level)
        hs = pk.device(cuda_device).hs_int_for_level(level)
        assert decode_batch(ct.c) == [pow(1 + pk.n, m, N) * pow(hs, r % pk.k, N)
                                      % N for m, r in zip(ms, rs)]
        assert pt.Decryptor(sk_, level, device=cuda_device).decrypt(ct) == ms
        reg = pt.Encryptor(pk, level, device=cuda_device).encrypt(ms, rs)
        b4 = mk.mont_pow_b4.launches
        assert hom.extract_randomness(sk_, reg) == rs
        assert mk.mont_pow_b4.launches == b4 + 1
    b4, batches = mk.mont_pow_b4.launches, kg.device_batched_prime.batches
    p = pt.device_batched_prime(256, random.Random(11),
                                congruent_3_mod_4=True, device=cuda_device)
    assert p.bit_length() == 256 and p % 4 == 3 and host.is_probable_prime(p)
    assert mk.mont_pow_b4.launches - b4 == \
        kg.device_batched_prime.batches - batches > 0


# -- the threshold path's shapes (paillier_tpu_torch/threshold) -----------

@pytest.mark.cuda
def test_kernel_b1_threshold_exponent_on_cuda(cuda_device):
    """Kernel B1 at k = 320 on 33 rows with a 4,100-bit shared exponent
    (partial decryption's 2*delta*s_i at 2048 bits), in 8-row tiles:
    bit-identical to the plain ladder and equal to Python's pow."""
    rng = random.Random(4100)
    eng = tr.Rns2Engine(_odd(rng, 4096), device=cuda_device)
    assert eng.spec.k == 320
    _b1_against_plain(eng, rng, 33, 4100, False, 8)


@pytest.mark.cuda
def test_kernel_b2_stacked_lagrange_rows_on_cuda(cuda_device):
    """Kernel B2 on the 12,288 stacked rows of combine's Lagrange ladder
    at k = 320 (3 servers x 4096 ciphertexts, above the 1024-8192 rows of
    the tile sweeps; the launcher's rule takes 32-row tiles), with each
    server's 4 digits of |2 lambda| per row and with 4 shared digits:
    bit-identical to the plain ladder, one launch each, and equal to
    Python's pow on rows of each server."""
    rng = random.Random(12288)
    n = _odd(rng, 4096)
    eng = tr.Rns2Engine(n, device=cuda_device)
    rows = 3 * 4096
    assert mx.load().rns2_modexp_rows(rows, eng.spec.k) == 32, \
        "the row count is chosen for an H100 (132 SMs)"
    xs = [rng.randrange(n) for _ in range(rows)]
    x = eng.from_limbs(torch.as_tensor(
        host.ints_to_limbs(xs, 256).astype(np.int64), device=cuda_device))
    lam2 = (720, 720, 240)              # servers {1, 2, 3} of l = 5
    per = torch.as_tensor(np.repeat(np.stack(
        [exp_digits(v, 4, 4) for v in lam2]), 4096, axis=0),
        device=cuda_device)
    check = [0, 4095, 4096, 8191, 8192, rows - 1]
    for digits, es in ((per, [lam2[i // 4096] for i in check]),
                       (per[-1], [lam2[-1]] * len(check))):
        before = mx.rns2_pow_b2.launches
        got = mx.rns2_pow_b2(eng.ctx, x, digits, 4)
        assert mx.rns2_pow_b2.launches == before + 1
        assert torch.equal(got, mx.rns2_pow_plain(eng.ctx, x, digits, 4))
        assert eng.decode(got[check]) == [pow(xs[i], e, n)
                                          for i, e in zip(check, es)]


@pytest.mark.cuda
def test_kernel_b4_verification_keys_on_cuda(cuda_device):
    """Kernel B4 at L = 256 (n^2 of a 2048-bit key) on 5 rows with
    per-row 1,025-digit exponents, the threshold verification keys'
    shape (32 lanes a row): the last 32 digits bit-identical to the plain
    ladder, all 1,025 equal to Python's pow."""
    rng = random.Random(1025)
    n2 = _odd(rng, 4096)
    ctx = tmont.make_mont_ctx(n2, device=cuda_device)
    assert ctx.n_limbs == 256 and mk.lanes_per_row(128, 5, 132) == 32
    xs = [rng.randrange(n2) for _ in range(5)]
    es = [rng.getrandbits(4100) | (1 << 4099) for _ in range(5)]
    dig = torch.as_tensor(np.stack([exp_digits(e, 4, 1025) for e in es]),
                          device=cuda_device)
    x = torch.as_tensor(host.ints_to_limbs(xs, 256).astype(np.int64),
                        device=cuda_device)
    got = _b4(ctx, x, dig[:, -32:], 4)
    assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig[:, -32:],
                                                        4))
    before = mk.mont_pow_b4.launches
    got = _b4(ctx, x, dig, 4)
    assert mk.mont_pow_b4.launches == before + 1
    assert host.limbs_to_ints(got.cpu().numpy()) == [
        pow(v, e, n2) for v, e in zip(xs, es)]


@pytest.mark.cuda
def test_sha256_on_cuda(cuda_device):
    """The port's batched SHA-256 on CUDA tensors against hashlib, the
    padding edges among the lengths: one launch of the kernel
    (csrc/sha256.cu)."""
    import hashlib
    from paillier_tpu_torch.ops import sha256 as sha
    rng = random.Random(256)
    lens = [0, 1, 55, 56, 63, 64, 119, 120] + [rng.randrange(600)
                                               for _ in range(24)]
    msgs = [bytes(rng.getrandbits(8) for _ in range(n)) for n in lens]
    data = torch.zeros((len(msgs), 600), dtype=torch.int64)
    for i, m in enumerate(msgs):
        data[i, :len(m)] = torch.tensor(list(m), dtype=torch.int64)
    before = sha.sha256_bytes.launches
    got = sha.sha256_bytes(data.to(cuda_device),
                           torch.tensor(lens, device=cuda_device))
    assert sha.sha256_bytes.launches == before + 1
    assert got.device.type == "cuda"
    assert sha.digest_to_ints(got) == [
        int.from_bytes(hashlib.sha256(m).digest(), "big") for m in msgs]


# the widths of the hashed buffers at 2048 bits: DDLEQ's c2 || x || y ||
# alpha (768 + 256 + 256 + 768 bytes) and the threshold proofs'
# a || b || c^4 || c_i^2 (512 + 512 + 2048 + 1024)
SHA_WIDTHS = (2048, 4096)


def _sha_rows(rng, W, lens):
    """int64 [len(lens), W] of seeded random bytes in every position (a
    row's bytes past its length must not count) and the messages."""
    data = np.frombuffer(rng.randbytes(len(lens) * W), np.uint8).reshape(
        len(lens), W).astype(np.int64)
    return data, [bytes(data[i, :n].astype(np.uint8)) for i, n in
                  enumerate(lens)]


@pytest.mark.cuda
@pytest.mark.parametrize("W", SHA_WIDTHS)
def test_sha256_kernel_vs_hashlib_and_plain(cuda_device, W):
    """The kernel against hashlib and against the plain version on the
    same CUDA tensor: the padding edges 0, 1, 55, 56, 63, 64, 119, 120,
    W - 1 and W among 75 rows of mixed lengths (a batch that is not a
    multiple of the kernel's 32 rows a block), random bytes past each
    length; one launch, and the plain version none."""
    import hashlib
    from paillier_tpu_torch.ops import sha256 as sha
    rng = random.Random(W)
    lens = [0, 1, 55, 56, 63, 64, 119, 120, W - 1, W]
    lens += [rng.randrange(W + 1) for _ in range(65)]
    rng.shuffle(lens)
    data, msgs = _sha_rows(rng, W, lens)
    x = torch.as_tensor(data, device=cuda_device)
    ln = torch.as_tensor(lens, dtype=torch.int64, device=cuda_device)
    before = sha.sha256_bytes.launches
    got = sha.sha256_bytes(x, ln)
    assert sha.sha256_bytes.launches == before + 1
    assert got.dtype == torch.int64 and tuple(got.shape) == (75, 8)
    assert torch.equal(got, sha.sha256_bytes_plain(x, ln))
    assert sha.sha256_bytes.launches == before + 1
    assert sha.digest_to_ints(got) == [
        int.from_bytes(hashlib.sha256(m).digest(), "big") for m in msgs]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 1280])
def test_sha256_kernel_batch_sizes(cuda_device, rows):
    """Batches below, at and past one block of 32 rows and DDLEQ's 1,280
    rows a rank at W = 2,048, lengths near the full width as DDLEQ's
    minimal encodings give them: equal to hashlib on every row."""
    import hashlib
    from paillier_tpu_torch.ops import sha256 as sha
    rng = random.Random(rows)
    lens = [2048 - rng.randrange(9) for _ in range(rows)]
    data, msgs = _sha_rows(rng, 2048, lens)
    got = sha.sha256_bytes(torch.as_tensor(data, device=cuda_device),
                           torch.as_tensor(lens, device=cuda_device))
    assert sha.digest_to_ints(got) == [
        int.from_bytes(hashlib.sha256(m).digest(), "big") for m in msgs]


@pytest.mark.cuda
def test_sha256_kernel_refusals(cuda_device):
    """The wrapper refuses, with no launch, what the kernel does not take:
    int32 bytes, a non-contiguous buffer, a 1-D buffer, lengths of
    another type, shape or device."""
    from paillier_tpu_torch.ops import sha256 as sha
    data = torch.zeros((4, 64), dtype=torch.int64, device=cuda_device)
    ln = torch.full((4,), 10, dtype=torch.int64, device=cuda_device)
    before = sha.sha256_bytes.launches
    cases = [(data.to(torch.int32), ln, "int64"),
             (torch.zeros((64, 4), dtype=torch.int64,
                          device=cuda_device).t(), ln, "contiguous"),
             (data[:, ::2], ln, "contiguous"),
             (data[0], ln[:1], "int64 \\[B, W\\]"),
             (data, ln.to(torch.int32), "lengths"),
             (data, ln[:3], "lengths"),
             (data, ln.cpu(), "lengths")]
    for d, n, match in cases:
        with pytest.raises(ValueError, match=match):
            sha.sha256_bytes(d, n)
    assert sha.sha256_bytes.launches == before


@pytest.mark.cuda
def test_threshold_on_cuda(cuda_device):
    """(3, 5)-threshold at 512 bits on the card: the verification keys
    (one B4 launch), partial_decrypt_all (a B1 launch a server), combine
    (one B2 launch), a proof batch (one B1, one B2 for both commitments,
    one SHA-256) and its verification (two B2, one SHA-256); plaintexts
    round-trip and the proofs verify."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch import threshold as thr
    from paillier_tpu_torch.ops import sha256 as sha

    def counts():
        return (sk.rns2_pow_sliding_b1.launches, mx.rns2_pow_b2.launches,
                mk.mont_pow_b4.launches, sha.sha256_bytes.launches)

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    c0 = counts()
    keys = thr.ThresholdKeyGenerator(512, 5, 3, random.Random(5),
                                     device=cuda_device).generate()
    assert delta(c0) == (0, 0, 1, 0)
    tpk = keys[0].public()
    assert tpk.vi == tuple(pow(tpk.v, tpk.delta * k.share, tpk.n2)
                           for k in keys)
    rng = random.Random(6)
    ms = [rng.randrange(tpk.n) for _ in range(6)] + [0]
    ct = pt.Encryptor(tpk, rng=rng, device=cuda_device).encrypt(ms)
    c0 = counts()
    shares = thr.partial_decrypt_all([keys[0], keys[2], keys[4]], ct)
    assert thr.combine(tpk, shares) == ms
    assert delta(c0) == (3, 1, 0, 0)
    c0 = counts()
    proofs = thr.partial_decrypt_with_zkp(keys[1], ct, rng)
    assert thr.verify_proofs(proofs, device=cuda_device) == [True] * 7
    assert delta(c0) == (1, 3, 0, 2)
    assert all(thr.verify_proof(p) for p in proofs[:2])


def test_b4_wide_rows_take_eight_words_a_lane():
    """Rows of 129 to 256 words (L = 257 to 512 limbs, moduli up to 8192
    bits, n^2 of a 4096-bit key) run 32 lanes a row, padded to 256 words
    (8 a lane, the kernel's widest case) whatever the batch; rows up to
    128 words and fewer lanes keep nw rounded up to a multiple of the
    lanes."""
    for nw in range(129, 257):
        for rows in (1, 5, 4096, 10 ** 6):
            assert mk.lanes_per_row(nw, rows, 132) == 32
        assert mk.padded_words(nw, 32) == 256
    assert [mk.padded_words(nw, 32) for nw in (1, 33, 97, 128)] == [
        32, 64, 128, 128]
    assert (mk.padded_words(128, 16), mk.padded_words(100, 8)) == (128, 104)


def test_b4_rows_past_256_words_take_twelve_words_a_lane():
    """Rows of 257 to 384 words (L = 513 to 768 limbs, moduli up to
    12,288 bits, n^3 of a 4096-bit key) run 32 lanes of 12 words (the
    register kernel's widest case), padded to 384 words, whatever the
    batch.  The variant rule: kernel B4w takes every modulus past 768
    limbs (one limb more: 769) and, below them, a batch of few rows
    (mont_kernel.variant by rows and SMs; a batch that fills the card
    stays on the register kernel B4); B4w pads rows to 32-word
    multiples and keeps its table in shared memory up to 1,888 words at
    window 4, in global memory past them."""
    assert mk.REGISTER_MAX_LIMBS == 768 and max(mk.WORDS_PER_LANE) == 12
    for nw in range(257, 385):
        for rows in (1, 64, 4096, 10 ** 6):
            assert mk.lanes_per_row(nw, rows, 132) == 32
        assert mk.padded_words(nw, 32) == 384
    # one row's table at window 4: 16 entries of 384 words (24,576 B)
    assert 16 * 384 * 4 == 24576
    assert mk.rows_per_block(24576, 128 // 32) == 4
    assert (mk.variant(768), mk.variant(769)) == ("B4", "B4w")
    assert (mk.variant(768, 64, 132), mk.variant(768, 1024, 132)) == (
        "B4w", "B4")
    assert mk.wide_words(769) == 416 and mk.wide_mode(416, 4) == 0
    assert (mk.wide_mode(1888, 4), mk.wide_mode(2912, 4)) == (0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [12288, 11000])
def test_kernel_b4_l768_on_cuda(cuda_device, bits):
    """Kernel B4 at L = 768 (n^3 of a 4096-bit key; 32 lanes of 12 words)
    and at 688 limbs (padded to 768): 33 rows against the plain ladder on
    the card over 8 shared and 8 per-row digits, and 4 rows over a
    256-bit exponent against Python's pow."""
    rng = random.Random(bits)
    m = _odd(rng, bits)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    L = ctx.n_limbs
    assert mk.lanes_per_row(L // 2, 33, 132) == 32
    assert mk.padded_words(L // 2, 32) == 384
    xs = [rng.randrange(m) for _ in range(32)] + [m - 1]
    x = torch.as_tensor(host.ints_to_limbs(xs, L).astype(np.int64),
                        device=cuda_device)
    per = torch.as_tensor(np.stack([exp_digits(rng.getrandbits(32), 4, 8)
                                    for _ in xs]), device=cuda_device)
    for dig in (per[0], per):
        before = mk.mont_pow_b4.launches
        got = _b4(ctx, x, dig, 4)
        assert mk.mont_pow_b4.launches == before + 1
        assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig, 4))
    e = rng.getrandbits(256) | 1 << 255
    got = _b4(ctx, x[:4], torch.as_tensor(
        exp_digits(e, 4, 64), device=cuda_device), 4)
    assert host.limbs_to_ints(got.cpu().numpy()) == [pow(v, e, m)
                                                     for v in xs[:4]]


@pytest.mark.cuda
def test_level2_4096_round_trip_on_cuda(cuda_device):
    """A 4096-bit key at level 2 on the card: the limb route (kernel B4 at
    L = 768) for Encryptor(pk, 2), regular and alternative, Decryptor(sk,
    2) and the nested functions, with their exact B4 launches (level 1
    stays on B1); 2 rows equal the host formula."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch import homomorphic as hom
    from paillier_tpu_torch.bigint.engine import LimbEngine
    sk_, pk = pt.keygen(4096, random.Random(4096), device_primes=False)
    dk = pk.device(cuda_device)
    assert isinstance(dk.engine(2), LimbEngine)
    assert not isinstance(dk.engine(1), LimbEngine)
    rng = random.Random(0x4096)
    ms = [rng.randrange(pk.n2) for _ in range(6)] + [0, pk.n2 - 1]
    rs = [rng.randrange(1, pk.n) for _ in ms]
    launches = (sk.rns2_pow_sliding_b1, mx.rns2_pow_b2, _rule_kernel(768, 8))

    def run(fn, want):
        before = [w.launches for w in launches]
        out = fn()
        assert [w.launches - b for w, b in zip(launches, before)] == want
        return out

    dec = pt.Decryptor(sk_, 2, device=cuda_device)
    ct = run(lambda: pt.Encryptor(pk, 2, device=cuda_device).encrypt(ms, rs),
             [0, 0, 1])
    n3 = pk.n3
    assert pt.decode_batch(ct.c[:2]) == [
        pow(1 + pk.n, m, n3) * pow(r, pk.n2, n3) % n3
        for m, r in zip(ms[:2], rs[:2])]
    assert run(lambda: dec.decrypt(ct), [0, 0, 1]) == ms
    alt = run(lambda: pt.Encryptor(pk, 2, "alternative", rng=rng,
                                   device=cuda_device).encrypt(ms),
              [0, 0, 1])
    assert dec.decrypt(alt) == ms
    xs = [rng.randrange(pk.n) for _ in range(4)]
    ys = [rng.randrange(pk.n) for _ in range(4)]
    assert _rule_kernel(768, 4) is launches[2]
    nx = run(lambda: pt.nested_encrypt(pk, xs, rng, device=cuda_device),
             [1, 0, 1])
    yct = pt.Encryptor(pk, device=cuda_device).encrypt(ys)
    na = run(lambda: hom.nested_add(pk, nx, yct), [0, 0, 1])
    got = run(lambda: pt.nested_decrypt(sk_, na, device=cuda_device),
              [1, 0, 1])
    assert got == [(a + b) % pk.n for a, b in zip(xs, ys)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8192, 6144])
def test_kernel_b4_l512_verification_keys_on_cuda(cuda_device, bits):
    """Kernel B4 at L = 512 (n^2 of a 4096-bit key; 32 lanes of 8 words)
    and L = 384 (padded to 512): the verification keys of a (5, 3) key,
    5 rows of one base with per-row exponents delta * s_i of ~8,200 bits,
    through ThresholdKeyGenerator(4096)._verification_keys (one launch)
    equal to the kernel called directly; the last 4 digits bit-identical
    to the plain ladder on the card, rows 0 and 4 equal to Python's pow
    (an 8,200-bit exponent at 8,192 bits takes seconds on the host)."""
    from paillier_tpu_torch.threshold import ThresholdKeyGenerator
    rng = random.Random(bits)
    m = _odd(rng, bits)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    nw = ctx.n_limbs // 2
    assert (mk.lanes_per_row(nw, 5, 132), mk.padded_words(nw, 32)) == (32, 256)
    v = rng.randrange(2, m)
    shares = [rng.getrandbits(bits) for _ in range(5)]
    exps = [120 * s for s in shares]
    kern = _rule_kernel(ctx.n_limbs, 5)
    before = kern.launches
    vk = ThresholdKeyGenerator(4096, 5, 3, device=cuda_device
                               )._verification_keys(v, shares, 120, m)
    assert kern.launches == before + 1
    nd = n_digits_for_bits(max(e.bit_length() for e in exps), 4)
    dig = torch.as_tensor(np.stack([exp_digits(e, 4, nd) for e in exps]),
                          device=cuda_device)
    x = torch.as_tensor(host.ints_to_limbs([v] * 5, ctx.n_limbs)
                        .astype(np.int64), device=cuda_device)
    got = _b4(ctx, x, dig, 4)
    assert host.limbs_to_ints(got.cpu().numpy()) == vk
    assert torch.equal(_b4(ctx, x, dig[:, -4:], 4),
                       tmont.mont_pow_digits_plain(ctx, x, dig[:, -4:], 4))
    assert [vk[0], vk[4]] == [pow(v, exps[0], m), pow(v, exps[4], m)]


def _parallel_case(dev):
    """Inputs at 256 bits for the two-rank and NCCL tests, and what one
    process on ``dev`` makes of them: the aggregate of 8 ciphertexts at
    levels 1 and 2, the plaintexts of 4 threshold ciphertexts (64-bit
    (4, 3) key), and DDLEQ proofs of 2 nested ciphertexts (secpar 8)."""
    import dataclasses

    import paillier_tpu_torch as pt
    from paillier_tpu_torch.core.keys import Ciphertext, decode_batch
    from paillier_tpu_torch.threshold import ThresholdKeyGenerator
    from paillier_tpu_torch.zk import ddleq as zd
    from torch_ranks import (aggregate_body, combine_body, ddleq_body)
    skey, pk = pt.keygen(256, random.Random(0x9A), device_primes=False)
    rng = random.Random(0x9B)
    vals = [rng.randrange(1000) for _ in range(8)]
    cts = {lv: pt.Encryptor(pk, lv, rng=rng, device=dev).encrypt(vals).c
           for lv in (1, 2)}
    keys = ThresholdKeyGenerator(64, 4, 3, random.Random(0x9C),
                                 device=dev).generate()
    tpk = keys[0].public()
    ms = [rng.randrange(tpk.n) for _ in range(4)]
    tct = pt.Encryptor(tpk, rng=rng, device=dev).encrypt(ms).c
    ct1 = pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(2)], rng,
                            device=dev)
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    want = dict(
        sums={lv: decode_batch(pt.homomorphic.aggregate(
            pk, Ciphertext(c=c, level=lv)).c[None])[0]
            for lv, c in cts.items()},
        ms=ms,
        proofs={crt: zd.prove(skey, ct1, ct2, a_l, b_l, 8, random.Random(0x9D),
                              use_crt=crt) for crt in (True, False)})
    calls = [
        (aggregate_body, (dataclasses.replace(pk),
                          {lv: c.cpu().numpy() for lv, c in cts.items()},
                          "cuda")),
        (combine_body, ([dataclasses.replace(k) for k in keys],
                        tct.cpu().numpy(), 2, "cuda")),
        (ddleq_body, (dataclasses.replace(skey), ct1.c.cpu().numpy(),
                      ct2.c.cpu().numpy(), a_l, b_l, 8, 0x9D, (1, 2, 1),
                      "cuda"))]
    return calls, want


def _check_parallel(results, want):
    """Every rank's results equal one process's, with exact launches:
    aggregate none; combine B1 2 (its two servers), B2 1 (their Lagrange
    powers); prove with and without the split B1 13, B2 13, B4 2,
    SHA-256 2; verify B1 2, B2 1, SHA-256 1."""
    none = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "SHA": 0}
    for agg, comb, dd in results:
        assert agg["sums"] == want["sums"] and agg["on_device"]
        assert agg["launches"] == none
        assert comb["plain"] == want["ms"]
        assert comb["launches"] == dict(none, B1=2, B2=1)
        for crt, proof in want["proofs"].items():
            for f in ("x", "y", "alpha", "e", "f"):
                assert np.array_equal(dd["proofs"][crt][f],
                                      getattr(proof, f).cpu().numpy()), f
        assert dd["prove_launches"] == dict(none, B1=13, B2=13, B4=2,
                                            SHA=2)
        assert dd["verify_launches"] == dict(none, B1=2, B2=1, SHA=1)
        assert (dd["ok"], dd["bad"]) == ([True, True], [True, False])
        assert dd["piped"] == [[True], [True, True], [True]]


@pytest.mark.cuda
def test_parallel_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks share one card (gloo gathers host copies):
    sharded_aggregate at levels 1 and 2, distributed_combine on a
    (2 servers x 1 batch) mesh and DDLEQ with mesh= (prove with and
    without the split, verify, a tampered instance, the 3-chunk
    pipeline) equal one process's results on the card."""
    from torch_ranks import bodies, run_ranks
    for mod in (sk, mx, fb, mk):
        mod.load()                  # built before the ranks start
    calls, want = _parallel_case(cuda_device)
    _check_parallel(run_ranks(bodies, 2, calls, init_dir=tmp_path,
                              timeout=300), want)


@pytest.mark.cuda
def test_parallel_nccl_across_cards(cuda_device, tmp_path):
    """One NCCL rank a card (device tensors gathered on the card): the
    same checks as the two gloo ranks, on every card of the machine."""
    from torch_ranks import bodies, run_ranks
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("NCCL across ranks needs two or more cards")
    for mod in (sk, mx, fb, mk):
        mod.load()
    calls, want = _parallel_case(cuda_device)
    _check_parallel(run_ranks(bodies, world, calls, init_dir=tmp_path,
                              timeout=300, backend="nccl"), want)


# -- probes P1-P5 (paillier_tpu_torch/probes, csrc/probe_*.cu) ------------

@pytest.mark.parametrize("lanes", [768, 384])
def test_pack_mma_rectangular(lanes):
    """The probes' packings of [640, 768] and [640, 384] (halves of
    lanes / 2 columns): the fragment products over the packed words equal
    the int8 product."""
    from paillier_tpu_torch.bigint.limbmm import _dot_i8
    rng = np.random.default_rng(lanes)
    e = torch.as_tensor(rng.integers(-128, 128, size=(640, lanes)),
                        dtype=torch.int8)
    packed = cuda_build.pack_mma(e)
    assert tuple(packed.shape) == (lanes // 32, 10, 2, 2, 32, 16)
    lhs = torch.as_tensor(rng.integers(-128, 128, size=(8, 640)),
                          dtype=torch.int8)
    assert np.array_equal(_mma_emulate(packed.numpy(), lhs.numpy(), 320,
                                       lanes // 2), _dot_i8(lhs, e).numpy())


_SASS_LABELS = """
        Function : _ZN6probes9loop_testEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;
        /*0020*/               @P0 BRA `(.L_x_1) ;
        /*0030*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0040*/              @!P1 BRA `(.L_x_0) ;
.L_x_1:
        /*0050*/                   F2I.FLOOR.NTZ R2, R3 ;
        /*0060*/                   EXIT ;
        Function : _ZN6vpuops10vpu_kernelILi7EEEvPKiPKfPiii
        /*0000*/                   F2I.TRUNC.NTZ R2, R3 ;
        /*0010*/                   F2I.FLOOR.NTZ R2, R3 ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x7, PT ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
"""


def test_sass_loop_ops():
    """Loops are found by backward branches to labels or addresses; a
    forward branch opens none; only loop instructions count."""
    from paillier_tpu_torch.probes import sass_faults
    loops = cuda_build.sass_loop_ops(_SASS_LABELS)
    assert loops == {
        "_ZN6probes9loop_testEv": ["IMMA.16832.S8.S8", "BRA", "IADD3", "BRA"],
        "_ZN6vpuops10vpu_kernelILi7EEEvPKiPKfPiii": [
            "F2I.FLOOR.NTZ", "ISETP.GE.AND", "BRA"]}
    assert sass_faults(_SASS_LABELS, {"loop_test": [("IMMA", 1)],
                                      r"vpu_kernelILi7E": [("F2I", 1)]}) == []
    faults = sass_faults(_SASS_LABELS, {"loop_test": [("F2I", 1)],
                                        r"vpu_kernelILi7E": [("F2I", 2)],
                                        "missing": [("IMMA", 1)]})
    assert len(faults) == 3 and "no function matches missing" in faults
    # a (pattern, least, most) entry also bounds the count from above
    assert sass_faults(_SASS_LABELS, {"loop_test": [("BRA", 0, 2)]}) == []
    faults = sass_faults(_SASS_LABELS, {"loop_test": [("IMMA", 0, 0)]})
    assert faults == ["_ZN6probes9loop_testEv: 1 IMMA in its loops, want "
                      "0..0"]


def test_probe_wrappers_on_the_cpu():
    """A CPU tensor takes the plain version without building anything; a
    tensor on another device, a wrong variant or a wrong shape raises."""
    from paillier_tpu_torch import probes
    from paillier_tpu_torch.probes import dotchain, dotvar, pad, vpuops
    x, mlo, mhi = dotvar.inputs(rows=3)
    before = dotvar.dotvar.launches
    assert torch.equal(dotvar.dotvar(x, mlo, mhi, 1, "wide1"),
                       dotvar.dotvar_plain(x, mlo, mhi, 1, "wide1"))
    assert dotvar.dotvar.launches == before
    with pytest.raises(ValueError, match="variant"):
        dotvar.dotvar_plain(x, mlo, mhi, 1, "split3")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dotchain.dotchain(x.to("meta"), mlo, mhi, 1)
    with pytest.raises(ValueError, match="int8"):
        probes.check(x.int(), "x", torch.int8, (None, probes.D))
    with pytest.raises(ValueError, match="lanes"):
        pad.inputs(512)
    with pytest.raises(ValueError, match="op"):
        vpuops.vpuops_plain(*vpuops.inputs(rows=2), 1, "div")
    with pytest.raises(ValueError, match="tile"):
        probes.pick_tile(12, 100)


def test_probes_entry_point_on_the_cpu(capsys):
    """``python -m paillier_tpu_torch.probes --device cpu --steps 2`` runs
    every probe's plain version at the scripts' shapes, 2 steps each, and
    prints a line for each case with its bound."""
    from paillier_tpu_torch.probes import __main__ as cli
    from paillier_tpu_torch.probes import dotvar, overlap, pad, vpuops
    cli.main(["--device", "cpu", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    count = {p: sum(ln.startswith(p + " ") for ln in lines)
             for p in ("P1", "P2", "P3", "P4", "P5")}
    assert count == {"P1": len(dotvar.VARIANTS), "P2": 6,
                     "P3": len(overlap.MODES), "P4": len(pad.WIDTHS) + 2,
                     "P5": len(vpuops.OPS)}
    assert all("bound" in ln and " 2 steps" in ln
               for ln in lines if ln.startswith(("P1", "P2", "P3")))
    with pytest.raises(SystemExit):
        cli.main(["p6", "--device", "cpu"])


def _probe_cases():
    from paillier_tpu_torch.probes.cases import CASES
    return [pytest.param(c, id=f"{c.probe}-{c.case}") for c in CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _probe_cases())
def test_probe_matches_plain_on_cuda(cuda_device, case):
    """Every variant of P1-P5 (``probes.cases``) is bit-identical to its
    plain version on CUDA inputs, at each tile and on ragged row counts
    (1, 37, 300); one launch per call, counted by the case's wrapper."""
    from paillier_tpu_torch.probes import dotchain, dotvar, overlap, pad
    from paillier_tpu_torch.probes import vpuops
    wrappers = (dotvar.dotvar, dotchain.dotchain, overlap.overlap, pad.pad,
                pad.roll, vpuops.vpuops)
    for rows in (1, 37, 300):
        for tile in (8, 16, 32) if case.tiled else (None,):
            before = [w.launches for w in wrappers]
            got, want = case.run(rows, tile, cuda_device)
            assert [w.launches - b for w, b in zip(wrappers, before)] == [
                int(w is case.wrapper) for w in wrappers]
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w), (case.probe, case.case, rows, tile)


@pytest.mark.cuda
def test_probe_sass_loops_hold_their_ops(cuda_device):
    """The SASS of P1-P4 holds IMMA inside each kernel's loop, and each of
    P5's op classes sits inside its loop once for every value a thread
    holds (the op was not folded or hoisted)."""
    from paillier_tpu_torch.probes import (dotchain, dotvar, overlap, pad,
                                           sass_faults, vpuops)
    for mod in (dotvar, dotchain, overlap, pad, vpuops):
        mod.KERNEL.load()
        code = cuda_build.sass(mod.KERNEL.source)
        assert sass_faults(code, mod.SASS_EXPECT) == [], mod.__name__


def _b4w_rows(rng, moduli, rows, L, device):
    xs = [rng.randrange(moduli[i % len(moduli)]) for i in range(rows)]
    return xs, torch.as_tensor(host.ints_to_limbs(xs, L).astype(np.int64),
                               device=device)


def _wide_launch(fn):
    """fn()'s result, and the (B4, B4w) launches it made."""
    before = (mk.mont_pow_b4.launches, mk.mont_pow_b4w.launches)
    out = fn()
    return out, (mk.mont_pow_b4.launches - before[0],
                 mk.mont_pow_b4w.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,rows,window,mode", [
    (16384, 33, 4, 0), (24576, 17, 4, 0), (16384, 2, 8, 1),
    (16 * 5824, 2, 4, 1)])
def test_kernel_b4w_matches_plain_on_cuda(cuda_device, bits, rows, window,
                                          mode):
    """Kernel B4w through mont_pow_b4 past 768 limbs: L = 1,024 (n^2 of an
    8192-bit key) and 1,536 (its n^3) with the table in shared memory,
    L = 1,024 at window 8 and L = 5,824 (2,912 words) at window 4 with
    the table in global memory; shared and per-row digits bit-identical
    to the plain ladder on the card, one B4w launch and no B4 launch a
    call, and 2 rows equal to Python's pow."""
    rng = random.Random(bits + window)
    m = _odd(rng, bits)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    L = ctx.n_limbs
    assert mk.variant(L) == "B4w"
    assert mk.wide_mode(mk.wide_words(L), window) == mode
    xs, x = _b4w_rows(rng, [m], rows, L, cuda_device)
    nd = 4 if mode else 8
    per = torch.as_tensor(np.stack([exp_digits(rng.getrandbits(window * nd),
                                               window, nd) for _ in xs]),
                          device=cuda_device)
    for dig in (per[0], per):
        got, launches = _wide_launch(lambda: mk.mont_pow_b4(ctx, x, dig,
                                                            window))
        assert launches == (0, 1)
        assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig,
                                                            window))
    e = rng.getrandbits(128) | 1 << 127
    got = mk.mont_pow_b4(ctx, x[:2], torch.as_tensor(
        exp_digits(e, 4, 32), device=cuda_device), 4)
    assert host.limbs_to_ints(got.cpu().numpy()) == [pow(v, e, m)
                                                     for v in xs[:2]]


@pytest.mark.cuda
def test_kernel_b4w_per_row_moduli_on_cuda(cuda_device):
    """B4w with per-row moduli at 1,100 limbs (padded to 1,152, R^2
    rebuilt for the padded R) and per-row digits: bit-identical to the
    plain ladder on 9 rows, equal to pow on all."""
    rng = random.Random(1100)
    moduli = [_odd(rng, 16 * 1100) for _ in range(9)]
    ctx = tmont.stack_mont_ctx(moduli, 1100, device=cuda_device)
    assert mk.wide_words(1100) == 576
    xs, x = _b4w_rows(rng, moduli, 9, 1100, cuda_device)
    es = [rng.getrandbits(32) for _ in xs]
    dig = torch.as_tensor(np.stack([exp_digits(e, 4, 8) for e in es]),
                          device=cuda_device)
    got, launches = _wide_launch(lambda: mk.mont_pow_b4(ctx, x, dig, 4))
    assert launches == (0, 1)
    assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig, 4))
    assert host.limbs_to_ints(got.cpu().numpy()) == [
        pow(v, e, n) for v, e, n in zip(xs, es, moduli)]


@pytest.mark.cuda
def test_kernel_b4w_operands_in_global_memory_on_cuda(cuda_device):
    """Past 14,528 words (465k-bit moduli) B4w keeps a row's operands in
    global memory too (mode 2): one row at 14,560 words, window 1, a
    3-bit exponent, equal to pow (the plain ladder at this width does not
    fit the card's memory)."""
    rng = random.Random(14560)
    m = _odd(rng, 32 * 14560)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    assert mk.wide_mode(mk.wide_words(ctx.n_limbs), 1) == 2
    xs, x = _b4w_rows(rng, [m], 1, ctx.n_limbs, cuda_device)
    got, launches = _wide_launch(lambda: mk.mont_pow_b4(
        ctx, x, torch.as_tensor([1, 0, 1], device=cuda_device), 1))
    assert launches == (0, 1)
    assert host.limbs_to_ints(got.cpu().numpy()) == [pow(xs[0], 5, m)]


@pytest.mark.cuda
def test_kernel_b4w_matches_register_b4_at_l768_on_cuda(cuda_device):
    """At L = 768, the register kernel's widest width, B4w called
    directly (mont_pow_b4w) and B4 (mont_pow_b4) give the same limbs on
    33 rows over 8 per-row digits: one launch of each."""
    rng = random.Random(768)
    m = _odd(rng, 12288)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    xs, x = _b4w_rows(rng, [m], 33, 768, cuda_device)
    dig = torch.as_tensor(np.stack([exp_digits(rng.getrandbits(32), 4, 8)
                                    for _ in xs]), device=cuda_device)
    reg, launches = _wide_launch(lambda: _b4(ctx, x, dig, 4))
    assert launches == (1, 0)
    wide, launches = _wide_launch(lambda: mk.mont_pow_b4w(ctx, x, dig, 4))
    assert launches == (0, 1)
    assert torch.equal(wide, reg)


@pytest.mark.cuda
def test_kernel_b4w_failed_launch_raises(cuda_device, monkeypatch):
    """No fallback: a launch that the library refuses raises and counts
    nothing (the register kernel and the plain ladder are not tried)."""
    rng = random.Random(1)
    m = _odd(rng, 16384)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    _, x = _b4w_rows(rng, [m], 2, 1024, cuda_device)
    lib = mk.load_wide()
    assert lib.limb_modexp_wide_row_bytes(512, 4, 0) == \
        mk.wide_row_bytes(512, 4, 0)

    class Refusing:
        limb_modexp_wide_row_bytes = lib.limb_modexp_wide_row_bytes

        @staticmethod
        def limb_modexp_wide_launch(*args):
            return 1                          # cudaErrorInvalidValue

    monkeypatch.setattr(mk, "_wide_lib", Refusing)
    monkeypatch.setattr(mk, "mont_pow_digits_plain", None)
    before = (mk.mont_pow_b4.launches, mk.mont_pow_b4w.launches)
    with pytest.raises(RuntimeError, match="kernel B4w launch failed"):
        mk.mont_pow_b4(ctx, x, [1, 2], 4)
    assert (mk.mont_pow_b4.launches, mk.mont_pow_b4w.launches) == before


def _b4w_operands(ctx, x, dig, window=4):
    """(base, int32 digits) as mont_pow_b4w checks them"""
    b, d, _ = mk._operands(ctx, x, dig, window, "B4w")
    return b, d


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_kernel_b4w_every_warp_count_on_cuda(cuda_device, cluster):
    """The block (or cluster) a row of B4w at every warp count the rule
    can give a cluster size (one column pair a thread, 32 w c >= nw, up
    to 32 warps) and at counts that leave threads two or three pairs or
    none: L = 1,024 (512 words) on 9 rows over 4 per-row digits,
    bit-identical to the plain ladder on the card, one B4w launch a
    call; the rule's own shape among them where it picks this cluster."""
    rng = random.Random(1024 + cluster)
    m = _odd(rng, 16384)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    xs, x = _b4w_rows(rng, [m], 9, 1024, cuda_device)
    dig = torch.as_tensor(np.stack([exp_digits(rng.getrandbits(16), 4, 4)
                                    for _ in xs]), device=cuda_device)
    want = tmont.mont_pow_digits_plain(ctx, x, dig, 4)
    b, d = _b4w_operands(ctx, x, dig)
    nw = mk.wide_words(1024)
    warps = {1, 3, 8, 12, 32, -(-nw // (32 * cluster))}
    for w in sorted(v for v in warps if 32 * v * cluster <= 2 * nw):
        got, launches = _wide_launch(lambda: mk.launch_wide(
            ctx, b, d, 4, (w, cluster)))
        assert launches == (0, 1)
        assert torch.equal(got, want), (w, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 8])
def test_kernel_b4w_staged_table_on_cuda(cuda_device, cluster):
    """The table in global memory (mode 1: L = 5,824, 2,912 words, at
    window 4; L = 1,024 at window 8), each digit's entry staged into
    shared memory by cp.async before its squarings, on one block a row
    and on a cluster of 8: bit-identical to the plain ladder on 2 rows
    over 3 per-row digits, 2 rows equal to pow."""
    for bits, window in ((16 * 5824, 4), (16384, 8)):
        rng = random.Random(bits + cluster)
        m = _odd(rng, bits)
        ctx = tmont.make_mont_ctx(m, device=cuda_device)
        L = ctx.n_limbs
        nw = mk.wide_words(L)
        assert mk.wide_mode(nw, window) == 1
        xs, x = _b4w_rows(rng, [m], 2, L, cuda_device)
        es = [rng.getrandbits(3 * window) for _ in xs]
        dig = torch.as_tensor(np.stack([exp_digits(e, window, 3)
                                        for e in es]), device=cuda_device)
        b, d = _b4w_operands(ctx, x, dig, window)
        got, launches = _wide_launch(lambda: mk.launch_wide(
            ctx, b, d, window, (-(-nw // (32 * cluster)) if cluster > 1
                                else 32, cluster)))
        assert launches == (0, 1)
        assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig,
                                                            window))
        assert host.limbs_to_ints(got.cpu().numpy()) == [
            pow(v, e, m) for v, e in zip(xs, es)]


@pytest.mark.cuda
def test_kernel_b4w_per_row_moduli_on_a_cluster_on_cuda(cuda_device):
    """Per-row moduli at 1,100 limbs (padded to 1,152: R^2 and the
    Hensel-lifted n' rebuilt for the padded R, a row each) on clusters
    of 2 and 4 blocks: bit-identical to the plain ladder on 5 rows."""
    rng = random.Random(1101)
    moduli = [_odd(rng, 16 * 1100) for _ in range(5)]
    ctx = tmont.stack_mont_ctx(moduli, 1100, device=cuda_device)
    xs, x = _b4w_rows(rng, moduli, 5, 1100, cuda_device)
    dig = torch.as_tensor(np.stack([exp_digits(rng.getrandbits(16), 4, 4)
                                    for _ in xs]), device=cuda_device)
    want = tmont.mont_pow_digits_plain(ctx, x, dig, 4)
    b, d = _b4w_operands(ctx, x, dig)
    for cluster in (2, 4):
        got, _ = _wide_launch(lambda: mk.launch_wide(
            ctx, b, d, 4, (-(-576 // (32 * cluster)), cluster)))
        assert torch.equal(got, want), cluster


@pytest.mark.cuda
@pytest.mark.parametrize("L,rows", [(256, 5), (256, 64), (512, 5),
                                    (512, 16), (768, 16), (768, 64)])
def test_b4_or_b4w_by_the_rule_on_cuda(cuda_device, L, rows):
    """mont_pow_b4 at B4's widths (L = 256, 512, 768) on 5 to 64 rows
    launches the kernel that mont_kernel.variant names for the card's
    SMs, once; its output equals the plain ladder's and that of the
    other kernel (B4 through mont_kernel.launch at its lane rule, or B4w
    through mont_pow_b4w)."""
    rng = random.Random(L * rows)
    m = _odd(rng, 16 * L)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    xs, x = _b4w_rows(rng, [m], rows, L, cuda_device)
    dig = torch.as_tensor(exp_digits(rng.getrandbits(32), 4, 8),
                          device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kind = mk.variant(L, rows, sms)
    got, launches = _wide_launch(lambda: mk.mont_pow_b4(ctx, x, dig, 4))
    assert launches == ((1, 0) if kind == "B4" else (0, 1))
    assert torch.equal(got, tmont.mont_pow_digits_plain(ctx, x, dig, 4))
    b, d, _ = mk._operands(ctx, x, dig, 4, "B4")
    reg = mk.launch(ctx, b, d, 4, mk.lanes_per_row(-(-L // 2), rows, sms))
    wide = mk.mont_pow_b4w(ctx, x, dig, 4)
    assert torch.equal(reg, got) and torch.equal(wide, got)


@pytest.mark.cuda
def test_kernel_b4w_refused_shape_raises(cuda_device):
    """No fallback on a shape the kernel refuses: 33 warps a block, a
    cluster of 3 blocks, a cluster in mode 2, each raises RuntimeError
    ("kernel B4w launch failed") and counts no launch of either kernel;
    nothing is written to the output of a good call made before."""
    rng = random.Random(33)
    m = _odd(rng, 16384)
    ctx = tmont.make_mont_ctx(m, device=cuda_device)
    _, x = _b4w_rows(rng, [m], 2, 1024, cuda_device)
    b, d = _b4w_operands(ctx, x, [1, 2])
    good = mk.launch_wide(ctx, b, d, 4)
    for shape in ((33, 1), (8, 3), (0, 1)):
        before = (mk.mont_pow_b4.launches, mk.mont_pow_b4w.launches)
        with pytest.raises(RuntimeError, match="kernel B4w launch failed"):
            mk.launch_wide(ctx, b, d, 4, shape)
        assert (mk.mont_pow_b4.launches, mk.mont_pow_b4w.launches) == before
    torch.cuda.synchronize()
    assert torch.equal(good, tmont.mont_pow_digits_plain(ctx, x, d, 4))


@pytest.mark.cuda
def test_8192_bit_round_trip_on_cuda(cuda_device):
    """An 8192-bit key on the card, 4 rows: level 1 Encryptor (B4w at
    L = 1,024), Decryptor(crt=True) (two B1 ladders at k = 704) and
    crt=False (B4w), level 2 Encryptor and Decryptor (B4w at L = 1,536),
    each with its exact launches; 2 rows of each level equal the host
    formula (r^(n^s) by GMP where the native helper loads)."""
    import paillier_tpu_torch as pt
    from paillier_tpu_torch import native
    from paillier_tpu_torch.bigint.engine import LimbEngine
    sk_, pk = pt.keygen(8192, random.Random(8192), device=cuda_device)
    dk = pk.device(cuda_device)
    assert all(isinstance(dk.engine(lv), LimbEngine) for lv in (1, 2))
    launches = (sk.rns2_pow_sliding_b1, mx.rns2_pow_b2, mk.mont_pow_b4,
                mk.mont_pow_b4w)

    def run(fn, want):
        before = [w.launches for w in launches]
        out = fn()
        assert [w.launches - b for w, b in zip(launches, before)] == want
        return out

    rng = random.Random(0x8192)
    for level, mod in ((1, pk.n2), (2, pk.n3)):
        ms = [rng.randrange(pk.n ** level) for _ in range(3)] + [0]
        rs = [rng.randrange(1, pk.n) for _ in ms]
        ct = run(lambda: pt.Encryptor(pk, level, device=cuda_device)
                 .encrypt(ms, rs), [0, 0, 0, 1])
        rn = (native.powm_batch(rs[:2], pk.n ** level, mod)
              if native.available() else
              [pow(r, pk.n ** level, mod) for r in rs[:2]])
        gm = [(1 + m * pk.n + (level - 1) * m * (m - 1) // 2 * pk.n2) % mod
              for m in ms[:2]]                     # (1 + n)^m, binomially
        assert pt.decode_batch(ct.c[:2]) == [
            g * r % mod for g, r in zip(gm, rn)]
        dec = pt.Decryptor(sk_, level, device=cuda_device)
        assert run(lambda: dec.decrypt(ct), [0, 0, 0, 1]) == ms
        if level == 1:
            crt = pt.Decryptor(sk_, 1, crt=True, device=cuda_device)
            assert run(lambda: crt.decrypt(ct), [2, 0, 0, 0]) == ms

