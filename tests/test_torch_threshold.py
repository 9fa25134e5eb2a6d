"""The port's (t, l)-threshold Paillier (``paillier_tpu_torch.threshold``)
against the JAX package's ``paillier_tpu.threshold``, both on the CPU.

Keys, safe primes, partial decryptions, combined plaintexts and the
share-decryption proofs (e, z) come out of both packages from the same
seeds and inputs: 64- and 128-bit threshold keys with l = 5, t = 3 (the
JAX suite's size), a few ciphertexts made by the JAX ``Encryptor``
(uint32 limbs carried over as the port's int64 limbs), and bench.py's
fixed 1024-bit safe primes for full-width 2048-bit keys.  The JAX side
runs as tests/test_threshold.py runs it (its default limb path on the
CPU); the port runs its kernels' plain versions (the tensors lie on the
CPU).  The JAX results are computed once per module: each distinct shape
costs a compile there.  Tolerance: none (every value is an integer).
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.bigint import host as jhost
from paillier_tpu.core import keys as jkeys_mod
from paillier_tpu.core.encrypt import Encryptor as JEncryptor
from paillier_tpu.threshold import decrypt as jdec
from paillier_tpu.threshold import keygen as jkg
from paillier_tpu.threshold import keys as jkeys
from paillier_tpu.threshold import safe_prime as jsp
from paillier_tpu.threshold import zkp as jzkp
from paillier_tpu_torch import homomorphic as hom
from paillier_tpu_torch import native as tnative
from paillier_tpu_torch.threshold import decrypt as tdec
from paillier_tpu_torch.threshold import keygen as tkg
from paillier_tpu_torch.threshold import keys as tkeys
from paillier_tpu_torch.threshold import safe_prime as tsp
from paillier_tpu_torch.threshold import zkp as tzkp

torch.set_num_threads(2)

CPU = "cpu"
KEY_SEED = 0x7E57
# bench.py's fixed 1024-bit safe primes (p = 2p' + 1) of its threshold
# configuration
SAFE_P1024 = int(
    "e422c56ca3c0f2d84f17306861a0b801cb6994fcccff85a797b18be4c14226fa"
    "77c2440b48dee0efa7aea10bab5a2a9a1fcd1095a4c221b3825c2dce2facd955"
    "c13c370de6c6d15cf850e4b47c52c83698afd26add3ae25953424839b657675a"
    "c2b3ec41729024ce3bfaf62c197377cb44a93f532b80d9040096f8c08ff7eb73", 16)
SAFE_Q1024 = int(
    "c35701846e378ba4ace9de4018b37137cc090f0fc2056b78502e38abe63cccb0"
    "efba37e3f16a8dcc12b9f655179794558fe416b9b5cf8d558e501a8226a3f4c8"
    "ed7d4a01d4038dc1d762f93bff23a33ec2604eb75afc06faefe359c44f20468c"
    "252742b742f10f07f075d57371d9b529bcab6a801db5c2e7324c7e905f12f807", 16)

_FIELDS = ("n", "g", "h", "k", "bits", "l", "t", "v", "vi", "id", "share")


def _same_key(tk, jk) -> bool:
    return all(getattr(tk, f) == getattr(jk, f) for f in _FIELDS)


def _limbs(j) -> torch.Tensor:
    """A JAX uint32 limb array as the port's int64 limbs."""
    return torch.as_tensor(np.asarray(j).astype(np.int64))


def _same_limbs(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


# ---------------------------------------------------------------------------
# Host arithmetic: the KATs and helpers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,b", [(11 * -7, 3 - 7), (77, -4), (-77, -4),
                                 (-1, 5), (0, -3), (123456789, 1000)])
def test_go_div_and_L(a, b):
    """Go's Euclidean division and L(u, n), negative operands too."""
    assert tdec.go_div(a, b) == jdec.go_div(a, b)
    assert tdec.L_int(a, b) == jdec.L_int(a, b)
    q = tdec.go_div(a, b)
    assert 0 <= a - q * b < abs(b)


def test_key_constants_and_public():
    """delta, combine_shares_constant and public() (a key with its own
    device cache) against the JAX keys; the reference's KATs."""
    base = dict(n=101 * 103, g=0, h=0, k=0, bits=14, l=6, t=3, v=5,
                vi=(1, 2, 3))
    tk = tkeys.ThresholdSecretKey(**base, id=2, share=862)
    jk = jkeys.ThresholdSecretKey(**base, id=2, share=862)
    assert tk.delta == jk.delta == 720
    assert tk.combine_shares_constant == jk.combine_shares_constant == 4558
    pub = tk.public()
    assert type(pub) is tkeys.ThresholdPublicKey
    assert dataclasses.asdict(pub) == dataclasses.asdict(jk.public())
    tk.device(CPU)
    assert pub._devices is not tk._devices and not pub._devices
    assert _same_key(tkeys.from_reference(jk), jk)
    assert type(tkeys.from_reference(jk.public())) is tkeys.ThresholdPublicKey
    assert tdec.partial_decrypt_int(tk, 56) == tkeys.PartialDecryption(
        2, jdec.partial_decrypt_int(jk, 56).decryption)


def test_compute_share_and_lambda():
    rng = random.Random(3)
    nm = rng.getrandbits(96) | 1
    coeffs = [rng.randrange(nm) for _ in range(4)]
    for i in range(6):
        assert (tkg.compute_share(coeffs, i, nm)
                == jkg.compute_share(coeffs, i, nm))
    assert tkg.compute_share([29, 88, 51], 2, 103) == 31
    tpk = tkeys.ThresholdPublicKey(n=1, g=2, h=0, k=0, bits=1, l=5, t=3)
    jpk = jkeys.ThresholdPublicKey(n=1, g=2, h=0, k=0, bits=1, l=5, t=3)
    for ids in ([1, 2, 3], [1, 3, 5], [2, 4, 5], [5, 1, 4, 2],
                [1, 2, 3, 4, 5]):
        for i in ids:
            assert (tdec.compute_lambda(tpk, i, ids)
                    == jdec.compute_lambda(jpk, i, ids))
    shares = [tkeys.PartialDecryption(1, 384111638639),
              tkeys.PartialDecryption(2, 235243761043)]
    kat = dict(n=637753, g=2, h=0, k=0, bits=1, l=2, t=2, v=70661107826)
    assert tdec.combine_ints(tkeys.ThresholdPublicKey(**kat), shares) == 100
    for bad in ([], [tkeys.PartialDecryption(0, 0)] * 2):
        with pytest.raises(ValueError):
            tdec.verify_partial_decryptions(tkeys.ThresholdPublicKey(**kat),
                                            bad)


# ---------------------------------------------------------------------------
# Safe primes and key generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64, 96])
def test_safe_prime_python_path(bits):
    """Below 128 bits both packages take the sieved Python loop: the same
    seed gives the same (p, q)."""
    got = tsp.generate_safe_prime(bits, rng=random.Random(bits))
    assert got == jsp.generate_safe_prime(bits, rng=random.Random(bits))
    p, q = got
    assert p == 2 * q + 1 and p.bit_length() == bits
    assert tsp.is_safe_prime(p)


@pytest.mark.skipif(not (tnative.available() and jhost._native()),
                    reason="native toolchain/libgmp unavailable")
@pytest.mark.parametrize("bits", [128, 512])
def test_safe_prime_native_path(bits):
    """At >= 128 bits both packages race the native runtime over the same
    candidates from the caller's rng: the same (p, q)."""
    got = tsp.generate_safe_prime(bits, rng=random.Random(bits))
    assert got == jsp.generate_safe_prime(bits, rng=random.Random(bits))
    assert tsp.is_safe_prime(got[0]) and got[0].bit_length() == bits


def test_safe_prime_errors():
    with pytest.raises(ValueError):
        tsp.generate_safe_prime(5)
    for bits in (64, 128):
        with pytest.raises(tsp.SafePrimeTimeout):
            tsp.generate_safe_prime(bits, timeout=0.0, rng=random.Random(1))


def test_generator_validation():
    for bits in (19, 16):
        with pytest.raises(ValueError):
            tkg.ThresholdKeyGenerator(bits, 4, 3, device=CPU)
    tkg.ThresholdKeyGenerator(18, 4, 3, device=CPU)
    gen = tkg.ThresholdKeyGenerator(32, 10, 3, random.Random(0), device=CPU)
    # thresholdkey_generator_test.go:314-324
    for dvk in (True, False):
        gen.device_verification_keys = dvk
        assert gen._verification_keys(54, [12, 90, 103], 3628800,
                                      101 * 101) == [6162, 304, 2728]
    with pytest.raises(ValueError):
        gen.generate_from_primes(9, 4, 7, 3)         # 9 not prime
    with pytest.raises(ValueError):
        gen.generate_from_primes(11, 4, 7, 3)        # 11 != 2*4+1


def test_b4_width_error_at_4096_bits():
    """Device verification keys of a 4096-bit key need n^2 at 512 limbs
    (kernel B4) and of an 8192-bit key at 1,024 (kernel B4w): both
    generators build, and the ladder (the plain version on the CPU)
    equals pow on a 4096-bit n's n^2 and on an 8192-bit n's n^2
    (16,384 bits) for 3 rows with short exponents."""
    for bits in (4096, 8192):
        gen = tkg.ThresholdKeyGenerator(bits, 5, 3, device=CPU)
        assert gen.device_verification_keys
        rng = random.Random(bits)
        n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        n2 = n * n
        v = rng.randrange(2, n2)
        shares = [rng.getrandbits(9) for _ in range(3)]
        assert gen._verification_keys(v, shares, 6, n2) == [
            pow(v, 6 * s, n2) for s in shares]
    tkg.ThresholdKeyGenerator(8192, 5, 3, device=CPU,
                              device_verification_keys=False)


@pytest.fixture(scope="module")
def keys64():
    """(port keys, JAX keys) of ThresholdKeyGenerator(64, 5, 3) from one
    seed; the port's verification keys on B4's plain ladder."""
    tk = tkg.ThresholdKeyGenerator(64, 5, 3, random.Random(KEY_SEED),
                                   device=CPU).generate()
    jk = jkg.ThresholdKeyGenerator(64, 5, 3,
                                   random.Random(KEY_SEED)).generate()
    return tk, jk


@pytest.mark.parametrize("bits", [64, 128])
def test_keygen_vs_jax(bits, keys64):
    if bits == 64:
        tk, jk = keys64
    else:
        tk = tkg.generate_threshold_keys(bits, 5, 3, random.Random(bits),
                                         device=CPU)
        jk = jkg.generate_threshold_keys(bits, 5, 3, random.Random(bits))
    assert len(tk) == 5 and [k.id for k in tk] == [1, 2, 3, 4, 5]
    for t, j in zip(tk, jk):
        assert type(t) is tkeys.ThresholdSecretKey
        assert _same_key(t, j)
    k0 = tk[0]
    assert k0.n.bit_length() == bits and k0.g == k0.n + 1
    for k in tk:
        assert k.vi[k.id - 1] == pow(k0.v, k0.delta * k.share, k0.n2)


def test_generate_from_primes_2048():
    """bench.py's 1024-bit safe primes: the full-width keys, host
    verification keys on both sides, equal the JAX package's."""
    p, q = SAFE_P1024, SAFE_Q1024
    args = (p, (p - 1) // 2, q, (q - 1) // 2)
    tk = tkg.ThresholdKeyGenerator(
        2048, 5, 3, random.Random(0x7357), device=CPU,
        device_verification_keys=False).generate_from_primes(*args)
    jk = jkg.ThresholdKeyGenerator(
        2048, 5, 3, random.Random(0x7357),
        device_verification_keys=False).generate_from_primes(*args)
    assert all(_same_key(t, j) for t, j in zip(tk, jk))
    assert tk[0].n.bit_length() == 2048
    gen = tkg.ThresholdKeyGenerator(2048, 5, 3, device=CPU,
                                    device_verification_keys=False)
    with pytest.raises(ValueError, match="safe primes"):
        gen.generate_from_primes(p + 2, (p + 1) // 2, q, (q - 1) // 2)


# ---------------------------------------------------------------------------
# Partial decryption and combining at 64 bits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flow(keys64):
    """The JAX keys carried across (``from_reference``), ciphertexts made
    by the JAX Encryptor, the JAX partial decryptions of every server,
    the JAX combine of servers {1, 2, 3} and the JAX host combine
    (combine_ints) of all five, row by row."""
    jk = keys64[1]
    tk = [tkeys.from_reference(k) for k in jk]
    jtpk = jk[0].public()
    rng = random.Random(0xC1)
    ms = [rng.randrange(jtpk.n) for _ in range(4)] + [0, 100]
    jct = JEncryptor(jtpk, 1, rng=rng).encrypt(ms)
    jparts = [jdec.partial_decrypt(k, jct) for k in jk]
    jcomb = {(1, 2, 3): jdec.combine(jtpk, jparts[:3])}
    rows = [jdec.combine_ints(jtpk, [
        jkeys.PartialDecryption(p.id, v)
        for p, v in zip(jparts, col)]) for col in zip(
            *[jkeys_mod.decode_batch(p.c) for p in jparts])]
    jcomb[(1, 2, 3, 4, 5)] = rows
    ct = pt.Ciphertext(c=_limbs(jct.c))
    return dict(tk=tk, jk=jk, tpk=tk[0].public(), ms=ms, jct=jct, ct=ct,
                jparts=jparts, jcomb=jcomb)


def test_partial_decrypt_vs_jax(flow):
    """partial_decrypt gives JAX's limbs for every server;
    partial_decrypt_all equals a partial_decrypt call per server."""
    tk, ct = flow["tk"], flow["ct"]
    parts = [tdec.partial_decrypt(k, ct) for k in tk]
    for got, want in zip(parts, flow["jparts"]):
        assert got.id == want.id
        assert _same_limbs(got.c, want.c)
    for subset in ((0, 1, 2), (4, 2, 0, 3)):
        stacked = tdec.partial_decrypt_all([tk[i] for i in subset], ct)
        for got, i in zip(stacked, subset):
            assert got.id == parts[i].id
            assert torch.equal(got.c, parts[i].c)


@pytest.mark.parametrize("ids", [(1, 2, 3), (1, 2, 3, 4, 5)])
def test_combine_vs_jax(flow, ids):
    """{1, 2, 3} has negative Lagrange weights; all five servers too."""
    tk, ct, ms = flow["tk"], flow["ct"], flow["ms"]
    shares = tdec.partial_decrypt_all([tk[i - 1] for i in ids], ct)
    got = tdec.combine(flow["tpk"], shares)
    assert got == flow["jcomb"][ids] == ms
    vals = [tkeys.PartialDecryption(s.id, pt.decode_batch(s.c)[0])
            for s in shares]
    assert tdec.combine_ints(flow["tpk"], vals) == ms[0]


def test_combine_errors_and_homomorphic(flow):
    tk, ct, tpk = flow["tk"], flow["ct"], flow["tpk"]
    one = tdec.partial_decrypt(tk[0], pt.Ciphertext(c=ct.c[:1]))
    with pytest.raises(ValueError, match="Threshold not meet"):
        tdec.combine(tpk, [one])
    with pytest.raises(ValueError, match="same server"):
        tdec.combine(tpk, [one, one, one])
    # thresholdkey_test.go:238-266: add, then decrypt with {2, 4, 5}
    c3 = hom.add(tpk, pt.Ciphertext(c=ct.c[:2]), pt.Ciphertext(c=ct.c[2:4]))
    shares = tdec.partial_decrypt_all([tk[1], tk[3], tk[4]], c3)
    ms = flow["ms"]
    assert tdec.combine(tpk, shares) == [(ms[0] + ms[2]) % tpk.n,
                                         (ms[1] + ms[3]) % tpk.n]


# ---------------------------------------------------------------------------
# Share-decryption proofs at 64 bits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def proofs(flow):
    """Proofs of servers 1 and 2 on the flow's ciphertexts, each package
    from the same seed per server, and the JAX verifier's verdicts on
    server 1's proofs as they are and with the first e changed; the
    port's proofs of server 3 too."""
    jp = [jzkp.partial_decrypt_with_zkp(flow["jk"][i], flow["jct"],
                                        random.Random(0x2C0 + i))
          for i in range(2)]
    tp = [tzkp.partial_decrypt_with_zkp(flow["tk"][i], flow["ct"],
                                        random.Random(0x2C0 + i))
          for i in range(3)]
    tampered = [dataclasses.replace(jp[0][0], e=jp[0][0].e ^ 1)] + jp[0][1:]
    jverdicts = (jzkp.verify_proofs(jp[0]), jzkp.verify_proofs(tampered))
    return dict(jp=jp, tp=tp, jverdicts=jverdicts)


def test_proofs_vs_jax(proofs):
    """The same seed gives JAX's (decryption, e, z, c) for every row."""
    for tps, jps in zip(proofs["tp"][:2], proofs["jp"], strict=True):
        assert len(tps) == len(jps) == 6
        for t, j in zip(tps, jps):
            assert (t.id, t.decryption, t.e, t.z, t.c) == (
                j.id, j.decryption, j.e, j.z, j.c)
            assert dataclasses.asdict(t.key) == dataclasses.asdict(j.key)
            assert tzkp.verify_proof(t)


def test_verify_proofs_vs_jax(proofs):
    """verify_proofs agrees with the JAX verifier on valid proofs and on
    proofs whose challenge was changed."""
    tps = proofs["tp"][0]
    tampered = [dataclasses.replace(tps[0], e=tps[0].e ^ 1)] + tps[1:]
    got = (tzkp.verify_proofs(tps, device=CPU),
           tzkp.verify_proofs(tampered, device=CPU))
    assert got == proofs["jverdicts"] == ([True] * 6, [False] + [True] * 5)
    assert not tzkp.verify_proof(tampered[0])


def test_combine_with_zkp_filters_a_tampered_server(flow, proofs):
    tp = [list(p) for p in proofs["tp"]]
    extra = tzkp.partial_decrypt_with_zkp(flow["tk"][3], flow["ct"],
                                          random.Random(7))
    tp[0][1] = dataclasses.replace(tp[0][1], e=687687678)
    assert tzkp.combine_with_zkp(flow["tpk"], tp + [extra], device=CPU) \
        == flow["ms"]


def test_verify_partial_decryption_and_decryption(flow, proofs):
    tk = flow["tk"]
    tzkp.verify_partial_decryption(tk[0], random.Random(11), device=CPU)
    bad = dataclasses.replace(tk[1], share=tk[1].share + 1)
    with pytest.raises(ValueError, match="Invalid share"):
        tzkp.verify_partial_decryption(bad, random.Random(11), device=CPU)
    # thresholdkey_test.go:357-394, on the first ciphertext
    row = [p[0] for p in proofs["tp"]]
    cval, m = row[0].c, flow["ms"][0]
    tzkp.verify_decryption(flow["tpk"], cval, m, row, device=CPU)
    with pytest.raises(ValueError, match="decrypted message"):
        tzkp.verify_decryption(flow["tpk"], cval, m + 1, row, device=CPU)
    with pytest.raises(ValueError, match="encrypted message"):
        tzkp.verify_decryption(flow["tpk"], cval + 1, m, row, device=CPU)


# ---------------------------------------------------------------------------
# The pinned threshold transcript of tests/vectors.json
# ---------------------------------------------------------------------------

def test_vectors_threshold():
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as fh:
        tv = json.load(fh)["threshold"]
    base = dict(n=tv["n"], g=tv["g"], h=tv["h"], k=tv["k"], bits=tv["bits"],
                l=tv["l"], t=tv["t"], v=tv["v"], vi=tuple(tv["vi"]))
    tpk = tkeys.ThresholdPublicKey(**base)
    c, msg = tv["c"], tv["m"]
    for sh, want in zip(tv["shares"], tv["partials"]):
        tsk = tkeys.ThresholdSecretKey(**base, id=sh["id"], share=sh["share"])
        assert tdec.partial_decrypt_int(tsk, c).decryption == want
    # the pinned transcripts verify, on the host and batched; each
    # server's proof with e + 1 fails
    good, bad = [], []
    for zk, want in zip(tv["zkps"], tv["partials"]):
        pd = tkeys.PartialDecryptionZKP(id=zk["id"], decryption=want,
                                        key=tpk, e=zk["e"], z=zk["z"], c=c)
        good.append(pd)
        bad.append(dataclasses.replace(pd, e=zk["e"] + 1))
        assert tzkp.verify_proof(pd) and not tzkp.verify_proof(bad[-1])
    assert tzkp.verify_proofs(good, device=CPU) == [True] * 5
    assert tzkp.verify_proofs(bad, device=CPU) == [False] * 5
    shares = [tkeys.PartialDecryption(id=sh["id"], decryption=pdv)
              for sh, pdv in zip(tv["shares"], tv["partials"])]
    assert tdec.combine_ints(tpk, shares[:tv["t"]]) == msg
