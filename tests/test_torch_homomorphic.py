"""The port's homomorphic operations against the JAX package's, both on
the CPU, at 128 bits.

The JAX key is forced onto its RNS engine (PAILLIER_TPU_FORCE_RNS=1 on a
fresh key, as tests/test_engine_paths.py does), so its const_mult, nested
ops and aggregate take the paths they take on an accelerator.  Inputs are
ciphertexts made on the host from seeded draws, fed to both packages;
randomness comes from one seed on each side.  Tolerance: exact (limbs
compared as uint32, plaintexts as ints).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import homomorphic as jhom
from paillier_tpu.core import keys as jkeys
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch import homomorphic as hom
from paillier_tpu_torch.bigint import modexp_kernel, sliding_kernel
from paillier_tpu_torch.core.keys import encode_batch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def keys():
    """(port secret key, JAX secret key on its RNS engine), one seed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAILLIER_TPU_FORCE_RNS", "1")
        tsk, _ = pt.keygen(128, random.Random(0x40))
        jsk, _ = jkeygen(128, random.Random(0x40))
        jsk = type(jsk)(**{f.name: getattr(jsk, f.name)
                           for f in dataclasses.fields(jsk)})   # fresh DeviceKey
        assert jsk.device().use_rns()
        yield tsk, jsk


def _enc1(sk, ms, rng):
    return [(1 + m * sk.n) * pow(rng.randrange(1, sk.n), sk.n, sk.n2) % sk.n2
            for m in ms]


def _enc2(sk, ms, rng):
    n3 = sk.n3
    return [pow(1 + sk.n, m, n3) * pow(rng.randrange(1, sk.n), sk.n2, n3) % n3
            for m in ms]


def _pair(sk, c_ints, level):
    """The same ciphertexts as (port, JAX) Ciphertext objects."""
    width = (level + 1) * sk.device("cpu").L
    return (pt.Ciphertext(c=encode_batch(c_ints, width, device="cpu"),
                          level=level),
            jkeys.Ciphertext(c=jkeys.encode_batch(c_ints, width), level=level))


def _same(tct, jct) -> bool:
    return (tct.level == jct.level and tct.method == jct.method
            and np.array_equal(tct.c.numpy().astype(np.uint32),
                               np.asarray(jct.c)))


def _inputs(sk, count, seed, level=1):
    rng = random.Random(seed)
    ms = [rng.randrange(sk.plaintext_modulus(level)) for _ in range(count)]
    enc = _enc1 if level == 1 else _enc2
    return ms, _pair(sk, enc(sk, ms, rng), level)


def test_add_sub_parity(keys):
    tsk, jsk = keys
    n = tsk.n
    xs, (tx, jx) = _inputs(tsk, 6, 1)
    ys, (ty, jy) = _inputs(tsk, 6, 2)
    zs, (tz, jz) = _inputs(tsk, 6, 3)
    got = hom.add(tsk, tx, ty, tz)
    assert got.method == pt.MIXED
    assert _same(got, jhom.add(jsk, jx, jy, jz))
    dec = pt.Decryptor(tsk, crt=True, device="cpu")
    assert dec.decrypt(got) == [(a + b + c) % n for a, b, c in zip(xs, ys, zs)]
    got = hom.sub(tsk, tx, ty)
    assert _same(got, jhom.sub(jsk, jx, jy))
    assert dec.decrypt(got) == [(a - b) % n for a, b in zip(xs, ys)]
    with pytest.raises(ValueError):
        hom.add(tsk, tx, _inputs(tsk, 6, 4, level=2)[1][0])


@pytest.mark.parametrize("kind", ["shared", "per_element", "zero",
                                  "per_element_zero"])
def test_const_mult_parity(keys, kind):
    """Shared k (sliding ladder), per-element ks (fixed-window ladder,
    digit count from the largest k), k = 0 both ways."""
    tsk, jsk = keys
    xs, (tx, jx) = _inputs(tsk, 6, 10)
    rng = random.Random(11)
    k = {"shared": rng.randrange(tsk.n), "zero": 0,
         "per_element": [rng.randrange(tsk.n) for _ in xs[:-1]] + [3],
         "per_element_zero": [0] * len(xs)}[kind]
    before = (sliding_kernel.rns2_pow_sliding_b1.launches,
              modexp_kernel.rns2_pow_b2.launches)
    got = hom.const_mult(tsk, tx, k)
    assert before == (sliding_kernel.rns2_pow_sliding_b1.launches,
                      modexp_kernel.rns2_pow_b2.launches)
    assert _same(got, jhom.const_mult(jsk, jx, k))
    ks = k if isinstance(k, list) else [k] * len(xs)
    assert pt.Decryptor(tsk, device="cpu").decrypt(got) == [
        x * kk % tsk.n for x, kk in zip(xs, ks)]


def test_randomize_parity(keys):
    tsk, jsk = keys
    xs, (tx, jx) = _inputs(tsk, 6, 20)
    got = hom.randomize(tsk, tx, random.Random(21))
    assert _same(got, jhom.randomize(jsk, jx, random.Random(21)))
    assert pt.Decryptor(tsk, device="cpu").decrypt(got) == xs
    assert not torch.equal(got.c, tx.c)


@pytest.mark.parametrize("count", [1, 5, 8])
def test_aggregate_parity(keys, count):
    """The RNS product tree with its M-power fix-up, odd and even counts."""
    tsk, jsk = keys
    xs, (tx, jx) = _inputs(tsk, count, 30 + count)
    got = hom.aggregate(tsk, tx)
    want = jhom.aggregate(jsk, jx, axis=0)
    assert got.c.shape == (2 * tsk.device("cpu").L,)
    assert _same(got, want)
    assert hom._tree_r_power(count) == jhom._tree_r_power(count)
    dec = pt.Decryptor(tsk, crt=True, device="cpu")
    assert dec.decrypt(pt.Ciphertext(c=got.c[None])) == [sum(xs) % tsk.n]


def test_aggregate_axis_and_streaming_parity(keys):
    tsk, jsk = keys
    xs, (tx, jx) = _inputs(tsk, 8, 40)
    got = hom.aggregate(tsk, pt.Ciphertext(c=tx.c.reshape(2, 4, -1)), axis=1)
    want = jhom.aggregate(jsk, jkeys.Ciphertext(c=jx.c.reshape(2, 4, -1)),
                          axis=1)
    assert _same(got, want)
    cuts = [(0, 3), (3, 7), (7, 8)]
    tchunks = [pt.Ciphertext(c=tx.c[a:b]) for a, b in cuts]
    jchunks = [jkeys.Ciphertext(c=jx.c[a:b]) for a, b in cuts]
    got = hom.aggregate_streaming(tsk, tchunks)
    assert _same(got, jhom.aggregate_streaming(jsk, jchunks))
    dec = pt.Decryptor(tsk, crt=True, device="cpu")
    assert dec.decrypt(pt.Ciphertext(c=got.c[None])) == [sum(xs) % tsk.n]
    with pytest.raises(ValueError):
        hom.aggregate_streaming(tsk, [])


def test_nested_ops_parity(keys):
    """nested_add / nested_sub (per-element ladders of 16L base-16 digits)
    and nested_randomize with fixed (a, b), against the JAX package."""
    tsk, jsk = keys
    n = tsk.n
    rng = random.Random(50)
    xs = [rng.randrange(n) for _ in range(6)]
    ys = [rng.randrange(n) for _ in range(6)]
    inner = _enc1(tsk, xs, rng)
    t2, j2 = _pair(tsk, _enc2(tsk, inner, rng), 2)
    t1, j1 = _pair(tsk, _enc1(tsk, ys, rng), 1)
    got = hom.nested_add(tsk, t2, t1)
    assert _same(got, jhom.nested_add(jsk, j2, j1))
    assert pt.nested_decrypt(tsk, got, device="cpu") == [
        (a + b) % n for a, b in zip(xs, ys)]
    got = hom.nested_sub(tsk, t2, t1)
    assert _same(got, jhom.nested_sub(jsk, j2, j1))
    assert pt.nested_decrypt(tsk, got, device="cpu") == [
        (a - b) % n for a, b in zip(xs, ys)]
    rs = [(rng.randrange(1, n), rng.randrange(1, n)) for _ in xs]
    got, a, b = hom.nested_randomize(tsk, t2, rs=rs)
    want, ja, jb = jhom.nested_randomize(jsk, j2, rs=rs)
    assert (a, b) == (ja, jb) and _same(got, want)
    assert pt.nested_decrypt(tsk, got, device="cpu") == xs
    got, a, b = hom.nested_randomize(tsk, t2, random.Random(51))
    assert (got.c.shape, len(a), len(b)) == (t2.c.shape, 6, 6)
    with pytest.raises(ValueError):
        hom.nested_add(tsk, t1, t2)
    with pytest.raises(ValueError):
        hom.nested_randomize(tsk, t1)


def test_extract_randomness_raises(keys):
    """extract_randomness (plain decryption, G^-m, one RNS product, the
    limb ladder of kernel B4's plain version) against the JAX package on
    its RNS engine, at levels 1 and 2: the same integers, and the
    randomness that encrypted."""
    tsk, jsk = keys
    rng = random.Random(60)
    for level in (1, 2):
        ms = [rng.randrange(tsk.plaintext_modulus(level)) for _ in range(3)]
        enc = _enc1 if level == 1 else _enc2
        c_ints = enc(tsk, ms, random.Random(0))
        # the rs of _enc1 / _enc2 are the draws of random.Random(0)
        r0 = random.Random(0)
        rs = [r0.randrange(1, tsk.n) for _ in ms]
        tct, jct = _pair(tsk, c_ints, level)
        got = hom.extract_randomness(tsk, tct)
        assert got == rs
        assert got == jhom.extract_randomness(jsk, jct)
