"""The port's level-2 (Damgard-Jurik s = 2) encryption, generic
decryption at levels 1 and 2 and the nested functions against the JAX
package, both on the CPU, plus the regular s = 2 cases of
tests/vectors.json.

The JAX key is forced onto its RNS engine (PAILLIER_TPU_FORCE_RNS=1 on a
fresh key, as tests/test_engine_paths.py does), so its Encryptor and
Decryptor take ``encrypt_with_r_rns_kernel`` and ``decrypt_kernel_rns``,
as on an accelerator.  Both packages get the same (m, r) or the same
seeded ``random.Random``.  Tolerance: exact (limbs compared as uint32,
plaintexts as ints).
"""

import dataclasses
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import decrypt as jdec
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core import keys as jkeys
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import host
from paillier_tpu_torch.core import encrypt as tenc
from paillier_tpu_torch.core.keys import decode_batch, encode_batch

torch.set_num_threads(2)

_KEY_FIELDS = ("n", "g", "h", "k", "bits", "lam", "p", "q")


@pytest.fixture(scope="module")
def keys():
    """(port secret key, JAX secret key on its RNS engine), one seed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAILLIER_TPU_FORCE_RNS", "1")
        tsk, _ = pt.keygen(128, random.Random(0x2D))
        jsk, _ = jkeygen(128, random.Random(0x2D))
        jsk = type(jsk)(**{f.name: getattr(jsk, f.name)
                           for f in dataclasses.fields(jsk)})   # fresh DeviceKey
        assert jsk.device().use_rns()
        yield tsk, jsk


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _cases(sk, level, count, seed):
    rng = random.Random(seed)
    mod = sk.plaintext_modulus(level)
    ms = [rng.randrange(mod) for _ in range(count - 3)] + [0, 1, mod - 1]
    rs = [rng.randrange(1, sk.n) for _ in ms]
    return ms, rs


def _host_enc(sk, level, ms, rs):
    ns, mod = sk.n ** level, sk.modulus_for_level(level)
    return [pow(1 + sk.n, m, mod) * pow(r, ns, mod) % mod
            for m, r in zip(ms, rs)]


@pytest.mark.parametrize("level", [1, 2])
def test_gm_binomial_parity(keys, level):
    """(1+n)^m by the binomial shortcut, limbs equal to the JAX package's
    (Toeplitz products and a Barrett fold in place of limb Montgomery)."""
    tsk, jsk = keys
    ms, _ = _cases(tsk, level, 6, level)
    width = level * tsk.device("cpu").L
    got = tenc.gm_binomial(tsk.device("cpu"),
                           encode_batch(ms, width, device="cpu"), level)
    want = jenc.gm_binomial(jsk.device(), jkeys.encode_batch(ms, width), level)
    assert np.array_equal(_u32(got), np.asarray(want))
    mod = tsk.modulus_for_level(level)
    assert decode_batch(got) == [pow(1 + tsk.n, m, mod) for m in ms]


def test_level2_encryption_parity(keys):
    tsk, jsk = keys
    ms, rs = _cases(tsk, 2, 6, 20)
    enc = pt.Encryptor(tsk.public(), pt.LEVEL_TWO, device="cpu")
    ct = enc.encrypt(ms, rs)
    assert (ct.level, ct.method) == (pt.LEVEL_TWO, pt.REGULAR)
    assert ct.c.shape == (6, 3 * enc.dk.L)
    # the JAX Encryptor runs encrypt_with_r_rns_kernel at level 2
    jct = jenc.Encryptor(jsk.public(), jkeys.LEVEL_TWO,
                         engine="rns").encrypt(ms, rs)
    assert np.array_equal(_u32(ct.c), np.asarray(jct.c))
    assert decode_batch(ct.c) == _host_enc(tsk, 2, ms, rs)
    # a limb tensor of plaintexts, and sampled randomness
    limbs = encode_batch(ms, enc.m_limbs, device="cpu")
    assert torch.equal(enc.encrypt(limbs, rs).c, ct.c)
    samp = pt.Encryptor(tsk.public(), 2, rng=random.Random(3), device="cpu")
    assert pt.Decryptor(tsk, 2, device="cpu").decrypt(samp.encrypt(ms)) == ms


@pytest.mark.parametrize("level", [1, 2])
def test_generic_decryptor_parity(keys, level):
    """Decryptor(crt=False) against the JAX decrypt_kernel_rns (same
    c^lambda ladder, recovery and lambda^-1 multiply)."""
    tsk, jsk = keys
    ms, rs = _cases(tsk, level, 6, 30 + level)
    c_ints = _host_enc(tsk, level, ms, rs)
    width = (level + 1) * tsk.device("cpu").L
    dec = pt.Decryptor(tsk, level, device="cpu")
    assert dec.crt is False
    got = dec.decrypt_array(pt.Ciphertext(
        c=encode_batch(c_ints, width, device="cpu"), level=level))
    assert got.shape == (6, level * tsk.device("cpu").L)
    jdk = jsk.device()
    ns = tsk.n ** level
    mu = jnp.asarray(host.int_to_limbs(pow(tsk.lam, -1, ns), level * jdk.L))
    inv2fac = jnp.asarray(host.int_to_limbs(
        tsk.n * pow(2, -1, tsk.n2) % tsk.n2, 2 * jdk.L))
    want = jdec.decrypt_kernel_rns(jdk, jdk.rns(level),
                                   jkeys.encode_batch(c_ints, width), level,
                                   tsk.lam, mu, inv2fac)
    assert np.array_equal(_u32(got), np.asarray(want))
    assert decode_batch(got) == ms
    jgot = jdec.Decryptor(jsk, level, engine="rns").decrypt(
        jkeys.Ciphertext(c=jkeys.encode_batch(c_ints, width), level=level))
    assert jgot == ms


def test_level2_crt_flag_is_dropped(keys):
    """Decryptor(sk, 2, crt=True) decrypts generically, as in JAX."""
    tsk, jsk = keys
    ms, rs = _cases(tsk, 2, 6, 40)
    ct = pt.Ciphertext(c=encode_batch(_host_enc(tsk, 2, ms, rs),
                                      3 * tsk.device("cpu").L, device="cpu"),
                       level=2)
    dec = pt.Decryptor(tsk, 2, crt=True, device="cpu")
    assert dec.crt is False and dec.decrypt(ct) == ms
    assert jdec.Decryptor(jsk, 2, crt=True).crt is False
    with pytest.raises(ValueError, match="level"):
        pt.Decryptor(tsk, 1, device="cpu").decrypt(ct)
    with pytest.raises(ValueError):
        pt.Decryptor(tsk, 3, device="cpu")
    with pytest.raises(ValueError):
        pt.Encryptor(tsk.public(), 3, device="cpu")


def test_nested_encrypt_decrypt_parity(keys):
    tsk, jsk = keys
    rng = random.Random(50)
    ms = [rng.randrange(tsk.n) for _ in range(5)] + [0]
    got = pt.nested_encrypt(tsk.public(), ms, random.Random(51), device="cpu")
    want = jenc.nested_encrypt(jsk.public(), ms, random.Random(51))
    assert got.level == pt.LEVEL_TWO
    assert np.array_equal(_u32(got.c), np.asarray(want.c))
    layer = pt.decrypt_nested_layer(tsk, got, device="cpu")
    jlayer = jdec.decrypt_nested_layer(jsk, want)
    assert (layer.level, layer.method) == (pt.LEVEL_ONE, pt.MIXED)
    assert np.array_equal(_u32(layer.c), np.asarray(jlayer.c))
    assert pt.nested_decrypt(tsk, got, device="cpu") == ms
    assert jdec.nested_decrypt(jsk, want) == ms
    with pytest.raises(ValueError):
        pt.decrypt_nested_layer(tsk, layer, device="cpu")


def test_vectors_level2_regular():
    """tests/vectors.json: every (key, method="regular", s=2) case
    encrypts to the pinned ciphertexts and decrypts back."""
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as fh:
        vectors = json.load(fh)
    n_cases = 0
    for entry in vectors["keys"]:
        sk = pt.SecretKey(**{f: entry[f] for f in _KEY_FIELDS})
        enc = pt.Encryptor(sk.public(), 2, device="cpu")
        dec = pt.Decryptor(sk, 2, device="cpu")
        for case in entry["cases"]:
            if case["method"] != "regular" or case["s"] != 2:
                continue
            ct = enc.encrypt(case["m"], case["r"])
            assert decode_batch(ct.c) == case["c"], entry["bits"]
            L = sk.device("cpu").L
            pinned = pt.Ciphertext(c=encode_batch(case["c"], 3 * L,
                                                  device="cpu"), level=2)
            assert dec.decrypt(pinned) == [m % sk.n2 for m in case["m"]]
            n_cases += 1
    assert n_cases == 2
