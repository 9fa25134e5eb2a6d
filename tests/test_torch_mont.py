"""The port's limb Montgomery layer (``bigint/montgomery.py``, what kernel
B4 computes) and its callers (``extract_randomness``,
``device_batched_prime``, ``keygen(device_primes=True)``) against the JAX
package, both on the CPU.

``mont_pow_digits_plain`` is held to ``_mont_pow_digits_jnp`` and to the
Pallas kernel ``mont_pow_pallas`` in interpret mode with shared and
per-row digits, as tests/test_rns.py runs them, and with per-row moduli
to a JAX ``vmap`` of the ladder over stacked contexts, as keygen's Fermat
batch runs it.  The same seeded inputs go to both sides; tolerance: exact
(limbs compared as uint32, integers as ints).
"""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.bigint import montgomery as jmont
from paillier_tpu.bigint.pallas_kernels import mont_pow_pallas
from paillier_tpu.core import homomorphic as jhom
from paillier_tpu.core import keygen as jkeygen_mod
from paillier_tpu.core import keys as jkeys
from paillier_tpu_torch import homomorphic as hom
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.core import keygen as tkeygen_mod
from paillier_tpu_torch.core.keys import decode_batch, encode_batch

torch.set_num_threads(2)


def _same_limbs(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.fixture(scope="module")
def mod128():
    """A 128-bit odd modulus (8 limbs), its two contexts and 8 bases."""
    rng = random.Random(0xB4)
    n = _odd(rng, 128)
    xs = [rng.randrange(n) for _ in range(7)] + [n - 1]
    L = host.limbs_for_bits(128)
    return (n, tmont.make_mont_ctx(n, device="cpu"), jmont.make_mont_ctx(n),
            xs, encode_batch(xs, L, device="cpu"),
            jnp.asarray(host.ints_to_limbs(xs, L)))


def test_ctx_and_products_vs_jax(mod128):
    """make_mont_ctx fields, mont_mul, to_mont, from_mont: the same limbs
    as the JAX package."""
    n, tctx, jctx, xs, tx, jx = mod128
    for f in tmont.MontCtx._fields:
        assert _same_limbs(getattr(tctx, f), getattr(jctx, f)), f
    ty, jy = tx.flip(0), jx[::-1]
    assert _same_limbs(tmont.mont_mul(tctx, tx, ty),
                       jmont.mont_mul(jctx, jx, jy))
    assert _same_limbs(tmont.to_mont(tctx, tx), jmont.to_mont(jctx, jx))
    assert _same_limbs(tmont.from_mont(tctx, tx), jmont.from_mont(jctx, jx))
    R = 1 << (16 * tctx.n_limbs)
    assert decode_batch(tmont.mont_mul(tctx, tx, ty)) == [
        a * b * pow(R, -1, n) % n for a, b in zip(xs, xs[::-1])]


@pytest.mark.parametrize("per_row", [False, True])
def test_ladder_vs_jax_and_pallas(mod128, per_row):
    """mont_pow_digits_plain == _mont_pow_digits_jnp == mont_pow_pallas
    (interpret mode), shared and per-row digits (zero exponent included),
    == pow; the dispatcher takes a CPU tensor to the plain ladder."""
    n, tctx, jctx, xs, tx, jx = mod128
    rng = random.Random(per_row)
    es = [rng.getrandbits(16) for _ in range(7)] + [0]
    nd = tmont.n_digits_for_bits(16, 4)
    dig = np.stack([tmont.exp_digits(e, 4, nd) for e in es])
    if not per_row:
        dig, es = dig[0], [es[0]] * 8
    got = tmont.mont_pow_digits_plain(tctx, tx, torch.as_tensor(dig), 4)
    assert got.dtype == torch.int64 and got.shape == tx.shape
    assert _same_limbs(got, jmont._mont_pow_digits_jnp(jctx, jx,
                                                       jnp.asarray(dig), 4))
    assert _same_limbs(got, mont_pow_pallas(jctx, jx, jnp.asarray(dig), 4,
                                            interpret=True))
    assert decode_batch(got) == [pow(x, e, n) for x, e in zip(xs, es)]
    assert torch.equal(tmont.mont_pow_digits(tctx, tx, dig, 4), got)


def test_per_row_moduli_vs_jax_vmap():
    """One modulus per row ([B, L] context fields, per-row exponents): the
    port's ladder == the JAX ladder vmapped over stacked contexts (the
    Fermat batch's form), at an odd L (5 limbs; the 6-limb case runs in
    test_device_batched_prime_parity), == pow."""
    rng = random.Random(0xF3)
    for bits in (80,):
        L = host.limbs_for_bits(bits)
        mods = [_odd(rng, bits) for _ in range(6)]
        xs = [rng.randrange(2, 1 << 20) for _ in mods]
        es = [m - 1 for m in mods]
        tctx = tmont.stack_mont_ctx(mods, L, device="cpu")
        digits = tmont.limbs_to_digits(encode_batch(es, L, device="cpu"), 4)
        got = tmont.mont_pow_digits_plain(
            tctx, encode_batch(xs, L, device="cpu"), digits, 4)
        jctxs = [jmont.make_mont_ctx(m, L) for m in mods]
        jctx = jmont.MontCtx(*[jnp.stack([getattr(c, f) for c in jctxs])
                               for f in jmont.MontCtx._fields])
        want = jax.vmap(
            lambda cx, b, d: jmont.mont_pow_digits(cx, b[None], d[None], 4)[0]
        )(jctx, jnp.asarray(host.ints_to_limbs(xs, L)),
          jnp.asarray(digits.numpy()))
        assert _same_limbs(got, want)
        assert decode_batch(got) == [pow(x, e, m)
                                     for x, e, m in zip(xs, es, mods)]


def test_mont_pow_and_fixed_base(mod128):
    """mont_pow (host exponent, 0 included) and mont_pow_fixed_base (one
    base, per-row exponents) equal the JAX functions."""
    n, tctx, jctx, xs, tx, jx = mod128
    e = random.Random(3).getrandbits(16) | 1 << 15   # the ladder test's shape
    assert _same_limbs(tmont.mont_pow(tctx, tx, e), jmont.mont_pow(jctx, jx, e))
    assert _same_limbs(tmont.mont_pow(tctx, tx, 0), jmont.mont_pow(jctx, jx, 0))
    es = [random.Random(i).getrandbits(40) for i in range(5)]
    nd = tmont.n_digits_for_bits(40, 4)
    dig = np.stack([tmont.exp_digits(v, 4, nd) for v in es])
    got = tmont.mont_pow_fixed_base(tctx, tx[1], torch.as_tensor(dig))
    assert _same_limbs(got, jmont.mont_pow_fixed_base(jctx, jx[1],
                                                      jnp.asarray(dig)))
    assert decode_batch(got) == [pow(xs[1], v, n) for v in es]


@pytest.fixture(scope="module")
def keys128():
    tsk, _ = pt.keygen(128, random.Random(0xE1))
    jsk, _ = jkeygen_mod.keygen(128, random.Random(0xE1))
    return tsk, jsk


@pytest.mark.parametrize("level", [1, 2])
def test_extract_randomness_vs_jax(keys128, level):
    """extract_randomness returns the rs that encrypted (regular
    encryption, both levels) and the JAX package's values
    (tests/test_core.py:240-252)."""
    tsk, jsk = keys128
    rng = random.Random(40 + level)
    ms = [rng.randrange(tsk.plaintext_modulus(level)) for _ in range(3)] + [0]
    rs = []
    while len(rs) < 4:
        r = rng.randrange(2, tsk.n)
        if math.gcd(r, tsk.n) == 1:
            rs.append(r)
    ct = pt.Encryptor(tsk.public(), level, device="cpu").encrypt(ms, rs)
    got = hom.extract_randomness(tsk, ct)
    assert got == rs
    jct = jkeys.Ciphertext(c=jkeys.encode_batch(decode_batch(ct.c),
                                                ct.c.shape[-1]), level=level)
    assert got == jhom.extract_randomness(jsk, jct)


def test_device_batched_prime_parity():
    """The same seed draws the same candidates and returns the same prime
    as the JAX package (host Miller-Rabin confirms it); one Fermat batch
    is counted per round (tests/test_core.py:46-57)."""
    before = tkeygen_mod.device_batched_prime.batches
    p = pt.device_batched_prime(96, random.Random(0xD0E1),
                                congruent_3_mod_4=True, batch=16,
                                device="cpu")
    assert tkeygen_mod.device_batched_prime.batches > before
    assert p == jkeygen_mod.device_batched_prime(
        96, random.Random(0xD0E1), congruent_3_mod_4=True, batch=16)
    assert p.bit_length() == 96 and p % 4 == 3 and pow(2, p - 1, p) == 1
    assert tkeygen_mod.sieve_candidates(64, 5, random.Random(2)) == \
        jkeygen_mod.sieve_candidates(64, 5, random.Random(2))


def test_keygen_device_primes_parity(monkeypatch):
    """keygen(device_primes=True) gives the JAX package's key; the auto
    rule sends keys of 2048 bits and more to the device search."""
    tsk, _ = pt.keygen(64, random.Random(0xD0E2), device_primes=True,
                       device="cpu")
    jsk, _ = jkeygen_mod.keygen(64, random.Random(0xD0E2), device_primes=True)
    for f in ("n", "g", "h", "k", "bits", "lam", "p", "q"):
        assert getattr(tsk, f) == getattr(jsk, f), f
    assert tsk.p % 4 == 3 and tsk.q % 4 == 3

    class Routed(Exception):
        pass

    def stub(*a, **k):
        raise Routed(k.get("device"))

    monkeypatch.setattr(tkeygen_mod, "device_batched_prime", stub)
    with pytest.raises(Routed, match="cuda"):
        pt.keygen(2048, random.Random(1))
    assert pt.keygen(128, random.Random(1))[0].bits == 128   # host search
