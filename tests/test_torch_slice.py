"""The port's first slice end to end on the CPU, against the JAX package:
keygen, regular level-1 encryption and CRT decryption at 128 and 256
bits, and the level-1 regular cases of tests/vectors.json.

Both packages get the same seeded ``random.Random`` state and the same
(m, r); tolerance: exact (ciphertext limbs compared as uint32, plaintexts
as Python ints).  The JAX side runs on its CPU backend: its Encryptor with
``engine="rns"`` (the fused-G^m RNS kernel) and its
``crt_decrypt_kernel_mm`` called directly, as on an accelerator.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.bigint.engine import make_engine as jmake_engine
from paillier_tpu.core import decrypt as jdec
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core import keys as jkeys
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch.bigint import sliding_kernel
from paillier_tpu_torch.core.keys import decode_batch, encode_batch
from paillier_tpu_torch.ops import profiling
from paillier_tpu_torch.ops import random as trand

torch.set_num_threads(2)

_KEY_FIELDS = ("n", "g", "h", "k", "bits", "lam", "p", "q")


@pytest.fixture(scope="module", params=[128, 256])
def keys(request):
    """(bits, port secret key, JAX secret key) from one seed."""
    bits = request.param
    tsk, tpk = pt.keygen(bits, random.Random(bits + 1))
    jsk, jpk = jkeygen(bits, random.Random(bits + 1))
    return bits, tsk, jsk


def _cases(sk, count, seed):
    rng = random.Random(seed)
    ms = [rng.randrange(sk.n) for _ in range(count - 2)] + [0, sk.n - 1]
    rs = [rng.randrange(1, sk.n) for _ in ms]
    return ms, rs


def _host_enc(pk, ms, rs):
    return [(1 + m * pk.n) * pow(r, pk.n, pk.n2) % pk.n2
            for m, r in zip(ms, rs)]


def test_keygen_parity(keys):
    bits, tsk, jsk = keys
    for f in _KEY_FIELDS:
        assert getattr(tsk, f) == getattr(jsk, f), f
    assert tsk.n.bit_length() == bits
    tpk = tsk.public()
    assert isinstance(tpk, pt.PublicKey) and not isinstance(tpk, pt.SecretKey)


def test_encryptor_parity(keys):
    bits, tsk, jsk = keys
    ms, rs = _cases(tsk, 8, bits)
    enc = pt.Encryptor(tsk.public(), pt.LEVEL_ONE, pt.REGULAR, device="cpu")
    ct = enc.encrypt(ms, rs)
    assert ct.level == pt.LEVEL_ONE and ct.method == pt.REGULAR
    got = ct.c.numpy()
    assert got.dtype == np.int64 and got.shape == (8, 2 * enc.dk.L)

    jpk = jsk.public()
    jct = jenc.Encryptor(jpk, jkeys.LEVEL_ONE, engine="rns").encrypt(ms, rs)
    assert np.array_equal(got.astype(np.uint32), np.asarray(jct.c))
    dk = jpk.device()
    eng = dk.rns(jkeys.LEVEL_ONE)
    nrow = np.asarray([jpk.n % mi for mi in eng.spec.all_m], np.int32)
    fused = jenc.encrypt_with_r_rns_fused_kernel(
        dk, eng, nrow, jkeys.encode_batch(ms, dk.L),
        jkeys.encode_batch(rs, 2 * dk.L), jpk.n)
    assert np.array_equal(got.astype(np.uint32), np.asarray(fused))
    assert decode_batch(ct.c) == _host_enc(tsk, ms, rs)


def test_crt_decryptor_parity(keys):
    bits, tsk, jsk = keys
    ms, rs = _cases(tsk, 8, bits + 7)
    L = tsk.device("cpu").L
    c_ints = _host_enc(tsk, ms, rs)
    ct = pt.Ciphertext(c=encode_batch(c_ints, 2 * L, device="cpu"))
    dec = pt.Decryptor(tsk, pt.LEVEL_ONE, crt=True, device="cpu")
    got = dec.decrypt_array(ct)

    cc = jdec._CrtConsts(jsk)
    plans = jdec._CrtMmPlans(jsk, cc, 2 * L)
    jc = jkeys.encode_batch(c_ints, 2 * L)
    eng_p = jmake_engine(cc.p2, plans.Lh)
    eng_q = jmake_engine(cc.q2, plans.Lh)
    want = jax.jit(lambda c: jdec.crt_decrypt_kernel_mm(
        jsk.device(), c, plans, eng_p, eng_q, jsk.p - 1, jsk.q - 1))(jc)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    assert dec.decrypt(ct) == ms


def test_roundtrip_sampled_randomness(keys):
    bits, tsk, _ = keys
    enc = pt.Encryptor(tsk.public(), rng=random.Random(bits), device="cpu")
    dec = pt.Decryptor(tsk, crt=True, device="cpu")
    ms = [0, 1, 2, tsk.n - 1, 12345]
    assert dec.decrypt(enc.encrypt(ms)) == ms
    limbs = encode_batch(ms, enc.m_limbs, device="cpu")   # a limb tensor
    assert dec.decrypt(enc.encrypt(limbs)) == ms


@pytest.mark.parametrize("level", [1, 2])
def test_sampled_randomness_is_the_per_row_draws(keys, level):
    """``encrypt(ms)`` draws r in batches: the ciphertext of
    ``encrypt(ms, rs)`` with rs drawn a row at a time from a twin
    generator, which ends in the same state; ``take()`` counts the rows."""
    bits, tsk, _ = keys
    pk = tsk.public()
    g = random.Random(bits * level)
    ms = [g.randrange(pk.n ** level) for _ in range(6)]
    before = profiling.take()["counters"].get("units.rows", 0)
    enc = pt.Encryptor(pk, level, rng=random.Random(bits + level),
                       device="cpu")
    got = enc.encrypt(ms)
    after = profiling.take()["counters"]["units.rows"]
    twin = random.Random(bits + level)
    rs = [trand.random_unit(pk.n, twin) for _ in ms]
    want = pt.Encryptor(pk, level, device="cpu").encrypt(ms, rs)
    assert torch.equal(got.c, want.c)
    assert enc.rng.getstate() == twin.getstate()
    assert after - before == len(ms)


def test_vectors_level1_regular():
    """tests/vectors.json: every (key, method="regular", s=1) case
    encrypts to the pinned ciphertexts and CRT-decrypts back."""
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as fh:
        vectors = json.load(fh)
    n_cases = 0
    for entry in vectors["keys"]:
        sk = pt.SecretKey(**{f: entry[f] for f in _KEY_FIELDS})
        enc = pt.Encryptor(sk.public(), device="cpu")
        dec = pt.Decryptor(sk, crt=True, device="cpu")
        for case in entry["cases"]:
            if case["method"] != "regular" or case["s"] != 1:
                continue
            ct = enc.encrypt(case["m"], case["r"])
            assert decode_batch(ct.c) == case["c"], entry["bits"]
            L = sk.device("cpu").L
            pinned = pt.Ciphertext(c=encode_batch(case["c"], 2 * L,
                                                  device="cpu"))
            assert dec.decrypt(pinned) == [m % sk.n for m in case["m"]]
            n_cases += 1
    assert n_cases == 2


def test_unported_paths_raise(keys):
    """The paths that raised before kernels B3 and B4 were ported now run:
    alternative encryption at both levels round-trips, extract_randomness
    returns the randomness; a bogus method is still a ValueError."""
    _, tsk, _ = keys
    pk = tsk.public()
    for level in (pt.LEVEL_ONE, pt.LEVEL_TWO):
        enc = pt.Encryptor(pk, level, method="alternative",
                           rng=random.Random(level), device="cpu")
        ct = enc.encrypt([5, 0])
        assert ct.method == pt.ALTERNATIVE
        assert pt.Decryptor(tsk, level, device="cpu").decrypt(ct) == [5, 0]
    ct = pt.Encryptor(pk, device="cpu").encrypt([5], [12345])
    assert pt.homomorphic.extract_randomness(tsk, ct) == [12345]
    with pytest.raises(ValueError):
        pt.Encryptor(pk, method="bogus", device="cpu")


def test_device_is_explicit_and_cpu_never_launches(keys):
    _, tsk, _ = keys
    pk = tsk.public()
    if not torch.cuda.is_available():
        # the entry points default to the card: without one they raise
        # instead of going on on the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            pt.Encryptor(pk)
        with pytest.raises((AssertionError, RuntimeError)):
            pt.Decryptor(tsk, crt=True)
    with pytest.raises(TypeError):
        pt.DeviceKey(pk)
    dk = pk.device("cpu")
    assert dk is pk.device(torch.device("cpu"))
    assert dk.engine(pt.LEVEL_ONE).ctx.device.type == "cpu"
    before = sliding_kernel.rns2_pow_sliding_b1.launches
    ct = pt.Encryptor(pk, rng=random.Random(3), device="cpu").encrypt([7])
    assert ct.c.device.type == "cpu"
    assert sliding_kernel.rns2_pow_sliding_b1.launches == before


def test_level_widen(keys):
    """The engine of a level takes limbs narrower than the ciphertext
    width and gives its results at that width."""
    _, tsk, _ = keys
    dk = tsk.device("cpu")
    eng = dk.engine(pt.LEVEL_ONE)
    x = torch.ones((2, 3), dtype=torch.int64)
    got = eng.to_limbs_mod(eng.from_limbs(x))
    assert got.shape == (2, 2 * dk.L)
    assert decode_batch(got) == [1 + (1 << 16) + (1 << 32)] * 2
    assert dk.limbs_for_level(2) == 3 * dk.L
