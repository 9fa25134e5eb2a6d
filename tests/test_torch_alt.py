"""The port's alternative encryption (c = G^m * h_s^r mod n^(s+1), r < K,
on the comb) against the JAX package's, both on the CPU, at levels 1 and
2, on 128- and 256-bit keys and on the ``alternative`` cases of
tests/vectors.json.

The JAX side runs its comb path (``Encryptor(..., engine="rns")``:
``alt_encrypt_comb_kernel`` on its RNS engine).  Both packages get the
same (m, r); every ciphertext round-trips through the port's Decryptor.
Tolerance: exact (limbs compared as uint32, plaintexts as ints).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core import keys as jkeys
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import fixed_base_kernel
from paillier_tpu_torch.core.keys import decode_batch, encode_batch

torch.set_num_threads(2)

_KEY_FIELDS = ("n", "g", "h", "k", "bits", "lam", "p", "q")


@pytest.fixture(scope="module", params=[128, 256])
def keys(request):
    """(port secret key, JAX secret key) from one seed."""
    bits = request.param
    tsk, _ = pt.keygen(bits, random.Random(bits + 3))
    jsk, _ = jkeygen(bits, random.Random(bits + 3))
    return tsk, jsk


def _host_alt(pk, level, ms, rs):
    N = pk.modulus_for_level(level)
    hs = (pow(pk.n - pk.h, pk.n, pk.n2) if level == 1
          else pow(pk.n2 - pk.h, pk.n2, pk.n3))
    return [pow(1 + pk.n, m, N) * pow(hs, r % pk.k, N) % N
            for m, r in zip(ms, rs)]


@pytest.mark.parametrize("level", [1, 2])
def test_alt_encryptor_parity(keys, level):
    tsk, jsk = keys
    rng = random.Random(level * 7 + tsk.bits)
    ms = [rng.randrange(tsk.plaintext_modulus(level)) for _ in range(5)] + [0]
    rs = [rng.randrange(1, tsk.n) for _ in ms]
    enc = pt.Encryptor(tsk.public(), level, pt.ALTERNATIVE, device="cpu")
    ct = enc.encrypt(ms, rs)
    assert ct.level == level and ct.method == pt.ALTERNATIVE
    got = ct.c.numpy()
    assert got.shape == (6, (level + 1) * enc.dk.L)
    jct = jenc.Encryptor(jsk.public(), level, method="alternative",
                         engine="rns").encrypt(ms, rs)
    assert np.array_equal(got.astype(np.uint32), np.asarray(jct.c))
    assert decode_batch(ct.c) == _host_alt(tsk, level, ms, rs)
    dec = pt.Decryptor(tsk, level, crt=level == 1, device="cpu")
    assert dec.decrypt(ct) == ms
    # a limb tensor of plaintexts, sampled randomness
    enc2 = pt.Encryptor(tsk.public(), level, pt.ALTERNATIVE,
                        rng=random.Random(level), device="cpu")
    limbs = encode_batch(ms, enc2.m_limbs, device="cpu")
    assert dec.decrypt(enc2.encrypt(limbs)) == ms


def test_alt_one_comb_per_call_and_cached_table(keys, monkeypatch):
    """One comb per encryption through the B3 wrapper, and the table is
    built once per key, level and window."""
    tsk, _ = keys
    pk = tsk.public()
    enc = pt.Encryptor(pk, pt.LEVEL_ONE, pt.ALTERNATIVE, device="cpu")
    dk = pk.device("cpu")
    assert dk.fixed_base(1, 4) is dk.fixed_base(1, 4)
    assert dk.fixed_base(1, 4).shape[0] == (tsk.bits // 2 // 4) * 16
    calls = []
    real = fixed_base_kernel.rns2_pow_fixed_base_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fixed_base_kernel, "rns2_pow_fixed_base_plain",
                        counting)
    ct = enc.encrypt([1, 2, 3], [5, 6, 7])
    assert len(calls) == 1
    assert decode_batch(ct.c) == _host_alt(tsk, 1, [1, 2, 3], [5, 6, 7])


def test_vectors_alternative():
    """tests/vectors.json: every (key, method="alternative", s) case
    encrypts to the pinned ciphertexts, and they decrypt back."""
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as fh:
        vectors = json.load(fh)
    n_cases = 0
    for entry in vectors["keys"]:
        sk = pt.SecretKey(**{f: entry[f] for f in _KEY_FIELDS})
        for case in entry["cases"]:
            if case["method"] != "alternative":
                continue
            level = case["s"]
            enc = pt.Encryptor(sk.public(), level, pt.ALTERNATIVE,
                               device="cpu")
            ct = enc.encrypt(case["m"], case["r"])
            assert decode_batch(ct.c) == case["c"], (entry["bits"], level)
            L = sk.device("cpu").L
            pinned = pt.Ciphertext(c=encode_batch(case["c"], (level + 1) * L,
                                                  device="cpu"), level=level)
            want = [m % sk.plaintext_modulus(level) for m in case["m"]]
            assert pt.Decryptor(sk, level, device="cpu").decrypt(pinned) == want
            assert len(case["m"]) == 6
            n_cases += 1
    assert n_cases == 4
