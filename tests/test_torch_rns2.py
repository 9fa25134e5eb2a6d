"""Parity of the port's RNS engine (paillier_tpu_torch.bigint.rns2) with
the JAX package's (paillier_tpu.bigint.rns2), both on the CPU.

The same seeded inputs go through both; tolerance: exact (residues are
compared with np.array_equal, limbs after casting to uint32).  The JAX
side of the sliding ladder runs both as ``rns2_pow_sliding_jnp`` and as
the Pallas kernel in interpret mode, as tests/test_rns2.py runs it.
Kernel B1 itself needs a GPU: its tests are in test_torch_kernels.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paillier_tpu.bigint import rns2 as jr
from paillier_tpu.bigint.pallas_rns2 import rns2_pow_sliding_pallas
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.bigint import rns2 as tr
from paillier_tpu_torch.bigint import sliding_kernel

torch.set_num_threads(2)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _ctx_np(ctx):
    return {f: np.asarray(getattr(ctx, f)) for f in ctx._fields}


def _conv_np(conv):
    return dict(fwd=conv.fwd, all_m=conv.all_m_dev, all_inv=conv.all_inv_dev,
                w0=conv.w0, w1=conv.w1, rev=conv.rev, inv_b1=conv.inv_b1,
                M_limbs=conv.M_limbs)


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


def _same_limbs(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.fixture(scope="module")
def pair256():
    n = _odd(random.Random(0x5EED), 256)
    return n, jr.Rns2Engine(n), tr.Rns2Engine(n, device="cpu")


@pytest.fixture(scope="module")
def pair4096():
    """k = 320: the spec 2048-bit encryption runs mod n^2."""
    n = _odd(random.Random(4096), 4096)
    return n, jr.Rns2Engine(n), tr.Rns2Engine(n, device="cpu")


@pytest.mark.parametrize("which", ["pair256", "pair4096"])
def test_context_from_numpy_equals_own_build(which, request):
    n, jeng, teng = request.getfixturevalue(which)
    k = teng.spec.k
    assert teng.spec.all_m == jeng.spec.all_m
    conv = tr.context_from_numpy(**_ctx_np(jeng.ctx), device="cpu")
    assert teng.ctx.e1g.shape == (2 * k, 2 * k)
    for f in tr.Rns2Context._fields:
        assert torch.equal(getattr(conv, f), getattr(teng.ctx, f)), f
    jconv = {f: np.asarray(a) for f, a in _conv_np(jeng.converter).items()}
    own = _conv_np(teng.converter)
    port = _conv_np(tr.converter_from_numpy(teng.spec, teng.ctx,
                                            teng.converter.L, jconv))
    for f in jconv:
        assert np.array_equal(own[f].numpy(), jconv[f]), f
        assert torch.equal(port[f], own[f]), f


def test_context_from_numpy_rejects_nonzero_gap(pair256):
    _, jeng, _ = pair256
    arrs = _ctx_np(jeng.ctx)
    k, pk = jeng.ctx.k, jeng.ctx.pk
    assert pk > k, "spec must have a lane gap to strip"
    arrs["e1g"] = arrs["e1g"].copy()
    arrs["e1g"][0, k] = 1
    with pytest.raises(ValueError):
        tr.context_from_numpy(**arrs, device="cpu")


@pytest.mark.parametrize("lazy", [False, True])
def test_mont_mul_pair_k64(pair256, lazy):
    n, jeng, teng = pair256
    rng = random.Random(11)
    xs = jeng.encode([rng.randrange(n) for _ in range(12)])
    ys = jeng.encode([rng.randrange(n) for _ in range(12)])
    # a lazy chain gives signed near-canonical inputs as well
    zs = jr.rns2_mont_mul_values(jeng.ctx, xs, ys, lazy=True)
    for a, b in ((xs, ys), (zs, xs), (zs, zs)):
        want = jr.rns2_mont_mul_values(jeng.ctx, a, b, lazy=lazy)
        got = tr.rns2_mont_mul_values(teng.ctx, torch.as_tensor(np.array(a)),
                                      torch.as_tensor(np.array(b)), lazy)
        assert got.dtype == torch.int32
        assert _same(got, want)
    minv = pow(teng.spec.M, -1, n)
    got = tr.rns2_mont_mul_values(teng.ctx, torch.as_tensor(np.array(xs)),
                                  torch.as_tensor(np.array(ys)))
    assert teng.decode(got) == [x * y * minv % n for x, y in zip(
        jeng.decode(xs), jeng.decode(ys))]


def test_k320_multiply_and_converter_roundtrip(pair4096):
    """One exact multiply and a limb round trip at the 2048-bit
    encryption width (k = 320), 4 rows, no ladder."""
    n, jeng, teng = pair4096
    assert teng.spec.k == 320
    rng = random.Random(320)
    vals = [rng.randrange(n) for _ in range(3)] + [n - 1]
    L = host.limbs_for_bits(n.bit_length())
    limbs = host.ints_to_limbs(vals, L)
    jres = jeng.from_limbs(jnp.asarray(limbs))
    tres = teng.from_limbs(torch.as_tensor(limbs.astype(np.int64)))
    assert _same(tres, jres)
    jmul = jeng.mul(jres, jres[::-1])
    tmul = teng.mul(tres, tres.flip(0))
    assert _same(tmul, jmul)
    assert _same_limbs(teng.to_limbs(tmul), jeng.to_limbs(jmul))
    assert _same_limbs(teng.to_limbs_mod(tmul), jeng.to_limbs_mod(jmul))
    assert host.limbs_to_ints(teng.to_limbs_mod(tmul).numpy()) == [
        a * b % n for a, b in zip(vals, vals[::-1])]


def test_converters_and_one_plus_mul_k64(pair256):
    n, jeng, teng = pair256
    rng = random.Random(64)
    vals = [rng.randrange(n) for _ in range(8)] + [0, 1, n - 1]
    L = teng.converter.L
    limbs = host.ints_to_limbs(vals, L)
    jres = jeng.from_limbs(jnp.asarray(limbs))
    tres = teng.from_limbs(torch.as_tensor(limbs.astype(np.int64)))
    assert _same(tres, jres)
    assert _same_limbs(teng.to_limbs(tres), jeng.to_limbs(jres))
    assert host.limbs_to_ints(teng.to_limbs(tres).numpy()) == vals
    # to_limbs_mod of lazy ladder-range values (< lambda*N)
    jlazy = jr.rns2_mont_mul_values(jeng.ctx, jres, jres, lazy=True)
    tlazy = torch.as_tensor(np.array(jlazy))
    assert _same_limbs(teng.to_limbs_mod(tlazy), jeng.to_limbs_mod(jlazy))
    c = rng.getrandbits(128)
    crow = np.asarray([c % m for m in teng.spec.all_m], dtype=np.int32)
    xs = jeng.encode([rng.getrandbits(120) for _ in range(8)])
    want = jr.rns2_one_plus_mul(jeng.ctx, xs, jnp.asarray(crow))
    got = tr.rns2_one_plus_mul(teng.ctx, torch.as_tensor(np.array(xs)),
                               torch.as_tensor(crow))
    assert _same(got, want)


@pytest.mark.parametrize("window", [4, 5, 6])
def test_sliding_window_schedule(window):
    rng = random.Random(window)
    for e in (1, 2, 3, 5, 64, rng.getrandbits(200), rng.getrandbits(2048)):
        e = max(e, 1)
        assert np.array_equal(tr.sliding_window_schedule(e, window),
                              jr.sliding_window_schedule(e, window))


@pytest.mark.parametrize("window", [5, 6])
def test_plain_sliding_ladder_vs_jax(pair256, window):
    """The plain ladder against rns2_pow_sliding_jnp and the Pallas
    kernel (interpret mode): exponents 1, 2, 3 and a 130-bit one, each
    schedule padded with -2 skip steps to one length (one compile per
    window), with the fused exit operand ``fin``."""
    n, jeng, teng = pair256
    rng = random.Random(100 + window)
    xs = [rng.randrange(n) for _ in range(16)]
    fs = [rng.randrange(n) for _ in range(16)]
    jx, jfin = jeng.encode(xs), jeng.encode(fs)
    tx, tfin = teng.encode(xs), teng.encode(fs)
    exps = (1, 2, 3, rng.getrandbits(130) | (1 << 129))
    scheds = [tr.sliding_window_schedule(e, window) for e in exps]
    S = max(len(s) for s in scheds) + 2
    for e, s in zip(exps, scheds):
        padded = np.concatenate([s, np.full(S - len(s), -2, np.int32)])
        want = jr.rns2_pow_sliding_jnp(jeng.ctx, jx, jnp.asarray(padded),
                                       window, fin=jfin)
        got = tr.rns2_pow_sliding_plain(teng.ctx, tx, padded, window,
                                        fin=tfin)
        assert _same(got, want), e
        assert teng.decode(got) == [pow(x, e, n) * f % n
                                    for x, f in zip(xs, fs)]
        if e in (3, exps[-1]):
            pal = rns2_pow_sliding_pallas(jeng.ctx, jx, jnp.asarray(padded),
                                          window, block=8, interpret=True,
                                          fin=jfin)
            assert _same(got, pal), e
        # the unpadded schedule and fin=None (exit multiply by 1)
        plain1 = tr.rns2_pow_sliding_plain(teng.ctx, tx, s, window)
        assert teng.decode(plain1) == [pow(x, e, n) for x in xs]


def test_dispatch_cpu_tensor_runs_plain(pair256):
    n, _, teng = pair256
    xs = [3, 5, n - 2]
    x = teng.encode(xs)
    sched = tr.sliding_window_schedule(65537, 6)
    before = sliding_kernel.rns2_pow_sliding_b1.launches
    got = tr.rns2_pow_sliding(teng.ctx, x, sched, 6)
    assert sliding_kernel.rns2_pow_sliding_b1.launches == before
    assert torch.equal(got, tr.rns2_pow_sliding_plain(teng.ctx, x, sched, 6))
    out = teng.pow_shared(x, 65537)
    assert teng.decode(out) == [pow(v, 65537, n) for v in xs]
    assert teng.decode(teng.pow_shared(x, 0)) == [1, 1, 1]


@pytest.mark.slow
def test_full_2048_ladder_parity(pair4096):
    """r^n mod n^2 ladder at the production width: plain torch vs the
    JAX jnp ladder on 2 rows of a 2048-bit exponent."""
    n, jeng, teng = pair4096
    rng = random.Random(2048)
    xs = [rng.randrange(n) for _ in range(2)]
    fs = [rng.randrange(n) for _ in range(2)]
    e = rng.getrandbits(2048) | (1 << 2047)
    sched = tr.sliding_window_schedule(e, 6)
    want = jr.rns2_pow_sliding_jnp(jeng.ctx, jeng.encode(xs),
                                   jnp.asarray(sched), 6,
                                   fin=jeng.encode(fs))
    got = tr.rns2_pow_sliding_plain(teng.ctx, teng.encode(xs), sched, 6,
                                    fin=teng.encode(fs))
    assert _same(got, want)
    assert teng.decode(got) == [pow(x, e, n) * f % n for x, f in zip(xs, fs)]
