"""The port's API against the JAX package's where PRs before it left
gaps: ``Encryptor.encrypt_zeros`` / ``encrypt_ones`` (bit-equal to the
JAX package's from the same ``random.Random`` state), and the errors
that name a size the port does not take (the RNS engine's modulus width
and, past it, kernel B4's limb count at ``DeviceKey`` / ``Encryptor`` /
``Decryptor``; kernel B4's own width check).  Tolerance: exact (limbs
compared as uint32).
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
    """A 4096-bit key at level 2 (n^3: 12,288 bits) is past the RNS
    engine: the Encryptor and Decryptor build on the limb route (kernel
    B4 at 768 limbs) and the RNS engine of that level still refuses.  An
    8192-bit key at level 2 (n^3: 1,536 limbs) is past both; the error
    names the key, the level, the modulus and both limits, raised where
    the object is built.  Level 1 of a 4096-bit key (n^2: 8192 bits)
    takes the RNS engine."""
    sk = _pk(4096)
    pk = sk.public()
    dk = pk.device("cpu")
    assert dk.limb_route(2) and not dk.limb_route(1)
    pt.Encryptor(pk, 2, device="cpu")
    pt.Decryptor(sk, 2, device="cpu")
    with pytest.raises(ValueError, match=(
            r"a 4096-bit key at level 2 has a 1228[6-8]-bit modulus n\^3; "
            r"the RNS engine takes moduli of at most 8661 bits")):
        dk.rns(2)
    dk.check_level(1)
    dk.check_level(2)
    big = _pk(8192)
    msg = (r"a 8192-bit key at level 2 has a 245[0-9][0-9]-bit modulus n\^3 "
           r"\(1536 limbs\); the RNS engine takes moduli of at most 8661 "
           r"bits and kernel B4 at most 12288 bits \(768 limbs\)")
    with pytest.raises(ValueError, match=msg):
        pt.Encryptor(big.public(), 2, device="cpu")
    with pytest.raises(ValueError, match=msg):
        pt.Decryptor(big, 2, device="cpu")
    with pytest.raises(ValueError, match=msg):
        big.public().device("cpu").check_level(2)


def test_modulus_width_limit_is_the_specs():
    """MAX_MODULUS_BITS is the widest modulus Rns2Spec takes."""
    assert rns2.Rns2Spec((1 << rns2.MAX_MODULUS_BITS) - 1).k == 704
    with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
        rns2.Rns2Spec((1 << (rns2.MAX_MODULUS_BITS + 1)) - 1)


def test_b4_limb_error_names_the_modulus():
    """Kernel B4's width check (run before any launch) names the modulus
    bits: a 12,304-bit modulus takes 769 limbs, one over the limit; a
    12,288-bit one (n^3 of a 4096-bit key) fits."""
    ctx = make_mont_ctx(_pk(12304).n, device="cpu")
    with pytest.raises(ValueError, match=r"kernel B4 takes moduli of at most "
                       r"12288 bits \(768 limbs\), got a 12304-bit modulus "
                       r"in 769 limbs"):
        mont_kernel.check_width(ctx)
    mont_kernel.check_width(make_mont_ctx(_pk(12288).n, device="cpu"))
