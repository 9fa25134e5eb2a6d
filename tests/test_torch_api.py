"""The port's API against the JAX package's where PRs before it left
gaps: ``Encryptor.encrypt_zeros`` / ``encrypt_ones`` (bit-equal to the
JAX package's from the same ``random.Random`` state), and the errors
that name a size the port does not take (the RNS engine's modulus width
at ``DeviceKey`` / ``Encryptor`` / ``Decryptor``; kernel B4's limb
count).  Tolerance: exact (limbs compared as uint32).
"""

import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import mont_kernel, rns2
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


def test_modulus_width_error():
    """A 4096-bit key at level 2 (n^3: 12,288 bits) is beyond the RNS
    engine; the error names the key, the level, the modulus and the
    limit, raised where the object is built.  Level 1 (n^2: 8192 bits)
    is within it."""
    sk = _pk(4096)
    msg = (r"a 4096-bit key at level 2 has a 1228[6-8]-bit modulus n\^3; the "
           r"RNS engine takes moduli of at most 8661 bits")
    with pytest.raises(ValueError, match=msg):
        pt.Encryptor(sk.public(), 2, device="cpu")
    with pytest.raises(ValueError, match=msg):
        pt.Decryptor(sk, 2, device="cpu")
    with pytest.raises(ValueError, match=msg):
        sk.public().device("cpu").rns(2)
    sk.public().device("cpu").check_level(1)


def test_modulus_width_limit_is_the_specs():
    """MAX_MODULUS_BITS is the widest modulus Rns2Spec takes."""
    assert rns2.Rns2Spec((1 << rns2.MAX_MODULUS_BITS) - 1).k == 704
    with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
        rns2.Rns2Spec((1 << (rns2.MAX_MODULUS_BITS + 1)) - 1)


def test_b4_limb_error_names_the_modulus():
    """Kernel B4's width check (run before any launch) names the modulus
    bits: a 8192-bit key's n takes 512 limbs."""
    ctx = make_mont_ctx(_pk(8192).n, device="cpu")
    with pytest.raises(ValueError, match=r"kernel B4 takes moduli of at most "
                       r"4096 bits \(256 limbs\), got a 8192-bit modulus in "
                       r"512 limbs"):
        mont_kernel.check_width(ctx)
    mont_kernel.check_width(make_mont_ctx(_pk(4096).n, device="cpu"))
