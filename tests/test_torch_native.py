"""The port's native GMP loader (``paillier_tpu_torch/native``) against the
pure-Python host paths and against the JAX package's loader.

Both packages build the same ``hostmath.cpp`` (the port keeps a
byte-for-byte copy); with both natives loaded, ``keygen(2048, rng)``
takes the host prime search in both and gives the same key.  Skips, as
tests/test_native.py does, where g++ or libgmp is missing.  Tolerance:
exact (Python ints).
"""

import os
import random

import pytest

from paillier_tpu import native as jnative
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch import keygen
from paillier_tpu_torch import native
from paillier_tpu_torch.bigint import host

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain/libgmp unavailable")

_HERE = os.path.dirname(os.path.abspath(__file__))


def test_source_is_the_jax_packages_copy():
    with open(os.path.join(_HERE, "..", "paillier_tpu", "native",
                           "hostmath.cpp"), "rb") as fh:
        jax_src = fh.read()
    with open(native._SRC, "rb") as fh:
        assert fh.read() == jax_src
    assert native.library_path().parent == native.BUILD_DIR
    assert host._native() is native


def test_against_python_paths():
    rng = random.Random(0x6A7)
    m = rng.getrandbits(1024) | (1 << 1023) | 1
    for _ in range(8):
        b, e = rng.randrange(m), rng.getrandbits(700)
        assert native.powm(b, e, m) == pow(b, e, m)
    vals = [rng.randrange(1, m) for _ in range(40)]
    vals = [v for v in vals if host.gcd(v, m) == 1]
    assert native.modinv_batch(vals, m) == [pow(v, -1, m) for v in vals]
    assert host.modinv_batch(vals, m) == [pow(v, -1, m) for v in vals]
    assert native.modinv(vals[0], m) == pow(vals[0], -1, m)
    with pytest.raises(ValueError):
        native.modinv_batch(vals[:3] + [0], m)
    p = host.random_prime(256, rng=random.Random(5))
    cands = [p * 3, p * 5, p, p + 2]
    assert native.first_prime(cands) == 2
    assert native.first_prime([4, 100, 561]) is None
    assert native.is_probable_prime(p) and host.is_probable_prime(p)
    assert not native.is_probable_prime(p * 3)
    assert not native.is_probable_prime(561)          # Carmichael


def test_no_native_switch(monkeypatch):
    monkeypatch.setenv("PAILLIER_TPU_NO_NATIVE", "1")
    assert not native.enabled()
    monkeypatch.delenv("PAILLIER_TPU_NO_NATIVE")
    assert native.enabled()


@pytest.mark.skipif(not jnative.available(),
                    reason="the JAX package's native runtime does not load")
def test_keygen_2048_matches_jax():
    """The default rule takes the host search in both packages, so one
    seed gives one key."""
    tsk, _ = keygen(2048, random.Random(0x2048))
    jsk, _ = jkeygen(2048, random.Random(0x2048))
    assert tsk.n == jsk.n and tsk.h == jsk.h
    assert tsk.n.bit_length() == 2048 and tsk.p % 4 == 3


@pytest.mark.skipif(not jnative.available(),
                    reason="the JAX package's native runtime does not load")
def test_powm_batch_gcd_mulmod_match_jax():
    """The three wrappers of the JAX loader the port lacked: the same
    values from the same inputs, and the same errors."""
    rng = random.Random(0xC6)
    m = rng.getrandbits(512) | 1
    e = rng.getrandbits(512)
    bases = [rng.getrandbits(520) for _ in range(17)] + [0, m]
    for threads in (1, 4):
        got = native.powm_batch(bases, e, m, threads=threads)
        assert got == jnative.powm_batch(bases, e, m, threads=threads)
        assert got == [pow(b, e, m) for b in bases]
    for _ in range(50):
        mod = rng.getrandbits(rng.randrange(8, 400)) | 1
        a, b = rng.getrandbits(380), rng.getrandbits(250)
        g = rng.getrandbits(64)
        assert native.gcd(a * g, mod * g) == jnative.gcd(a * g, mod * g)
        assert native.mulmod(a, b, mod) == jnative.mulmod(a, b, mod) \
            == a * b % mod
    assert native.gcd(0, 0) == jnative.gcd(0, 0) == 0
    for fn in (native, jnative):
        with pytest.raises(ValueError):
            fn.mulmod(3, 4, 0)
        with pytest.raises(ValueError):
            fn.powm_batch([3], 5, 0)
