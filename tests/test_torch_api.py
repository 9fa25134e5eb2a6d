"""The port's API against the JAX package's where PRs before it left
gaps: ``Encryptor.encrypt_zeros`` / ``encrypt_ones`` (bit-equal to the
JAX package's from the same ``random.Random`` state), the error that
names the RNS engine's modulus width, and the widths past it, which the
limb route takes (kernel B4 up to 768 limbs, B4w past them).  Tolerance:
exact (limbs compared as uint32).
"""

import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import mont_kernel, rns2
from paillier_tpu_torch.bigint.engine import LimbEngine, make_engine
from paillier_tpu_torch.bigint.montgomery import make_mont_ctx

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def keys():
    tsk, _ = pt.keygen(128, random.Random(0xA91))
    jsk, _ = jkeygen(128, random.Random(0xA91))
    return tsk, jsk


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("which", ["zeros", "ones"])
def test_encrypt_zeros_ones_parity(keys, level, which):
    tsk, jsk = keys
    enc = pt.Encryptor(tsk.public(), level, rng=random.Random(level),
                       device="cpu")
    jenc_ = jenc.Encryptor(jsk.public(), level, rng=random.Random(level))
    jct = getattr(jenc_, f"encrypt_{which}")(5)
    ct = getattr(enc, f"encrypt_{which}")(5)
    assert ct.level == level and ct.c.shape[0] == 5
    assert np.array_equal(ct.c.numpy().astype(np.uint32), np.asarray(jct.c))
    want = [0 if which == "zeros" else 1] * 5
    assert pt.Decryptor(tsk, level, device="cpu").decrypt(ct) == want


def _pk(bits):
    rng = random.Random(bits)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    return pt.SecretKey(n=n, g=n + 1, h=2, k=1 << (bits // 2), bits=bits,
                        lam=n - 1, p=3, q=5)


def test_modulus_width_error(monkeypatch):
    """A 4096-bit key at level 2 (n^3: 12,288 bits) is past the RNS
    engine: the factory gives it the limb engine (kernel B4 at 768
    limbs), on which the Encryptor and Decryptor build, and the RNS
    engine itself refuses the modulus.  An 8192-bit key is past it at
    both levels (n^2: 1,024 limbs, n^3: 1,536): its Encryptor builds at
    levels 1 and 2 and its Decryptor at level 1 on the limb engine
    (kernel B4w; tests/test_torch_wide.py builds the rest), where the RNS
    engine refuses both moduli.  Level 1 of a 4096-bit key (n^2: 8192
    bits) takes the RNS engine."""
    sk = _pk(4096)
    pk = sk.public()
    dk = pk.device("cpu")
    pt.Encryptor(pk, 2, device="cpu")
    pt.Decryptor(sk, 2, device="cpu")
    assert isinstance(dk.engine(2), LimbEngine)
    assert isinstance(sk.device("cpu").engine(2), LimbEngine)
    with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
        rns2.Rns2Engine(pk.n3, device="cpu")
    with monkeypatch.context() as m:          # the choice, without the build
        m.setattr(rns2, "Rns2Engine", lambda *a, **kw: "RNS")
        assert make_engine(pk.n2, 2 * dk.L, device="cpu") == "RNS"
    dk.check_level(1)
    dk.check_level(2)
    big = _pk(8192)
    bpk = big.public()
    bdk = bpk.device("cpu")
    for level in (1, 2):
        bdk.check_level(level)
        assert pt.Encryptor(bpk, level, device="cpu").dk is bdk
        assert isinstance(bdk.engine(level), LimbEngine)
        with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
            rns2.Rns2Engine(bpk.modulus_for_level(level), device="cpu")
    pt.Decryptor(big, 1, device="cpu")
    assert list(big.device("cpu")._engines) == [1]
    with pytest.raises(ValueError, match="level must be 1 or 2, got 3"):
        bdk.check_level(3)


def test_modulus_width_limit_is_the_specs():
    """MAX_MODULUS_BITS is the widest modulus Rns2Spec takes."""
    assert rns2.Rns2Spec((1 << rns2.MAX_MODULUS_BITS) - 1).k == 704
    with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
        rns2.Rns2Spec((1 << (rns2.MAX_MODULUS_BITS + 1)) - 1)


def test_b4_limb_error_names_the_modulus():
    """No modulus width raises any longer: a 12,304-bit modulus (769
    limbs, one over the register kernel B4's 768) is kernel B4w's, a
    12,288-bit one (n^3 of a 4096-bit key) B4's, and the ladder of both
    (the plain version on the CPU) at 769 limbs equals pow over a short
    exponent."""
    ctx = make_mont_ctx(_pk(12304).n, device="cpu")
    assert ctx.n_limbs == 769 and mont_kernel.variant(769) == "B4w"
    assert mont_kernel.variant(
        make_mont_ctx(_pk(12288).n, device="cpu").n_limbs) == "B4"
    rng = random.Random(769)
    n = _pk(12304).n
    x = rng.randrange(n)
    base = torch.as_tensor(np.asarray(
        [[(x >> (16 * i)) & 0xFFFF for i in range(769)]], dtype=np.int64))
    got = mont_kernel.mont_pow_b4(ctx, base, [0xB, 0x4], 4)
    assert sum(int(v) << (16 * i) for i, v in enumerate(got[0])) == \
        pow(x, 0xB4, n)
