"""The port's DDLEQ proofs (``paillier_tpu_torch.zk.ddleq``) against the
JAX package's ``paillier_tpu.zk.ddleq``, both on the CPU, and the port's
own checks at 256 bits.

Both packages prove on the same 128-bit key (one seed), the same
nested ciphertexts (the port's int64 limbs carried over as uint32), the
same (a, b) lists and the same seeded ``random.Random``: the proofs must
be bit-identical, with and without the prover's p^3/q^3 CRT split, and
the verifiers must give the same verdicts.  The JAX side runs as
tests/test_ddleq.py runs it (its default engine on the CPU); the port
runs its kernels' plain versions (the tensors lie on the CPU).  The JAX
results are module fixtures of one shape (3 proofs x 8 instances): each
JAX shape costs a compile.  Tolerance: none (every value is an integer).
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu.core.keys import Ciphertext as JCiphertext
from paillier_tpu.zk import ddleq as jd
from paillier_tpu_torch.bigint.engine import CrtSplit
from paillier_tpu_torch.core.keys import (LEVEL_ONE, LEVEL_TWO, Ciphertext,
                                          SecretKey, decode_batch,
                                          encode_batch)
from paillier_tpu_torch.ops.oracle import oracle_bit
from paillier_tpu_torch.zk import ddleq as zd

torch.set_num_threads(2)

CPU = "cpu"
SECPAR = 8
FIELDS = ("x", "y", "alpha", "e", "f")


def _jct(ct: Ciphertext) -> JCiphertext:
    import jax.numpy as jnp
    return JCiphertext(c=jnp.asarray(ct.c.numpy().astype(np.uint32)),
                       level=ct.level)


def _nested(pk, count, rng):
    return pt.nested_encrypt(pk, [rng.randrange(pk.n) for _ in range(count)],
                             rng, device=CPU)


def _tamper(proof: zd.DDLEQProof, pk, L) -> zd.DDLEQProof:
    ints = proof.to_ints()
    ints["f"][0][0] = (ints["f"][0][0] + 1) % pk.n3
    return zd.DDLEQProof.from_ints(L=L, device=CPU, **ints)


@pytest.fixture(scope="module")
def case():
    """The port's and the JAX package's 128-bit keys from one seed, three
    nested ciphertexts and their nested_randomize (a, b), an unrelated
    nested ciphertext, and the JAX proofs (CRT split and full width) and
    verdicts (honest, one tampered instance, unrelated ciphertext)."""
    sk, pk = pt.keygen(128, random.Random(0xDD), device=CPU)
    jsk, jpk = jkeygen(128, random.Random(0xDD))
    assert (sk.n, sk.p, sk.q) == (jsk.n, jsk.p, jsk.q)
    rng = random.Random(0xDD1)
    ct1 = _nested(pk, 3, rng)
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    ct3 = _nested(pk, 3, rng)
    j1, j2, j3 = _jct(ct1), _jct(ct2), _jct(ct3)
    jproofs = {crt: jd.prove(jsk, j1, j2, a_l, b_l, SECPAR,
                             random.Random(0xDD2), use_crt=crt)
               for crt in (True, False)}
    jp = jproofs[True]
    ints = jp.to_ints()
    ints["f"][0][0] = (ints["f"][0][0] + 1) % pk.n3
    jtampered = jd.DDLEQProof.from_ints(L=pk.device(CPU).L, **ints)
    jverdicts = {"honest": jd.verify(jpk, j1, j2, jp),
                 "tampered": jd.verify(jpk, j1, j2, jtampered),
                 "unrelated": jd.verify(jpk, j1, j3, jp)}
    return dict(sk=sk, pk=pk, ct1=ct1, ct2=ct2, ct3=ct3, a=a_l, b=b_l,
                jproofs=jproofs, jverdicts=jverdicts)


@pytest.fixture(scope="module")
def port_proof(case):
    return zd.prove(case["sk"], case["ct1"], case["ct2"], case["a"],
                    case["b"], SECPAR, random.Random(0xDD2))


@pytest.mark.parametrize("use_crt", [True, False])
def test_proof_matches_jax(case, port_proof, use_crt):
    """Same key, ciphertexts, (a, b) and rng seed: x, y, alpha, e and f
    equal the JAX package's limb for limb, with and without the split."""
    tp = port_proof if use_crt else zd.prove(
        case["sk"], case["ct1"], case["ct2"], case["a"], case["b"], SECPAR,
        random.Random(0xDD2), use_crt=False)
    jp = case["jproofs"][use_crt]
    assert tp.secpar == jp.secpar == SECPAR
    for name in FIELDS:
        got = getattr(tp, name)
        assert got.dtype == torch.int64 and got.device.type == CPU
        assert np.array_equal(got.numpy().astype(np.uint32),
                              np.asarray(getattr(jp, name))), name


@pytest.mark.parametrize("which", ["honest", "tampered", "unrelated"])
def test_verdicts_match_jax(case, port_proof, which):
    """verify gives the JAX package's verdicts on the honest proof, on a
    proof with one tampered instance (only its proof fails) and against
    an unrelated nested ciphertext (every proof fails)."""
    pk, ct1 = case["pk"], case["ct1"]
    L = pk.device(CPU).L
    proof, ct2 = {"honest": (port_proof, case["ct2"]),
                  "tampered": (_tamper(port_proof, pk, L), case["ct2"]),
                  "unrelated": (port_proof, case["ct3"])}[which]
    got = zd.verify(pk, ct1, ct2, proof)
    assert got == case["jverdicts"][which]
    assert got == {"honest": [True] * 3, "tampered": [False, True, True],
                   "unrelated": [False] * 3}[which]


def test_pipeline_matches_serial(case):
    """pipeline_prove_verify over two chunks (the first 1 and 2
    ciphertexts) gives the verdicts of a serial prove + verify of each
    chunk with the same rng, in order; a chunk whose ct1 is unrelated to
    its ct2 cannot be proven."""
    c = case
    pk = c["pk"]
    secpar = 4

    def chunk(i):
        return (Ciphertext(c=c["ct1"].c[:i + 1], level=LEVEL_TWO),
                Ciphertext(c=c["ct2"].c[:i + 1], level=LEVEL_TWO),
                c["a"][:i + 1], c["b"][:i + 1], random.Random(1000 + i))

    serial = []
    for i in range(2):
        ct1, ct2, a_l, b_l, rng = chunk(i)
        serial.append(zd.verify(pk, ct1, ct2, zd.prove(
            c["sk"], ct1, ct2, a_l, b_l, secpar, rng)))
    got = list(zd.pipeline_prove_verify(
        c["sk"], (chunk(i) for i in range(2)), secpar, verify_pk=pk))
    assert got == serial == [[True], [True] * 2]
    swapped = Ciphertext(c=c["ct1"].c.flip(0), level=LEVEL_TWO)
    with pytest.raises(ValueError, match="inputs are wrong"):
        list(zd.pipeline_prove_verify(
            c["sk"], [(swapped, c["ct2"], c["a"], c["b"], random.Random(1))],
            secpar))


@pytest.fixture(scope="module")
def vectors():
    path = os.path.join(os.path.dirname(__file__), "vectors.json")
    with open(path) as f:
        return json.load(f)["ddleq"]


def _vector_case(dv):
    sk = SecretKey(n=dv["n"], g=dv["g"], h=dv["h"], k=dv["k"],
                   bits=dv["bits"], lam=dv["lam"], p=dv["p"], q=dv["q"])
    L = sk.device(CPU).L
    ct1 = Ciphertext(c=encode_batch(dv["ct1"], 3 * L, device=CPU),
                     level=LEVEL_TWO)
    ct2 = Ciphertext(c=encode_batch(dv["ct2"], 3 * L, device=CPU),
                     level=LEVEL_TWO)
    return sk, L, ct1, ct2


def test_vectors_transcript_verifies(vectors):
    """The ddleq transcript of tests/vectors.json verifies; swapping the
    ciphertexts breaks every transcript (tests/test_vectors.py:108-121)."""
    sk, L, ct1, ct2 = _vector_case(vectors)
    pr = vectors["proof"]
    proof = zd.DDLEQProof.from_ints(pr["x"], pr["y"], pr["alpha"], pr["e"],
                                    pr["f"], L, device=CPU)
    pk = sk.public()
    assert zd.verify(pk, ct1, ct2, proof) == [True, True]
    assert zd.verify(pk, ct2, ct1, proof) == [False, False]


def test_vectors_prove(vectors):
    """A fresh proof of the vectors' relation (their a, b) verifies."""
    sk, _, ct1, ct2 = _vector_case(vectors)
    proof = zd.prove(sk, ct1, ct2, vectors["a"], vectors["b"],
                     vectors["secpar"], random.Random(4))
    assert zd.verify(sk.public(), ct1, ct2, proof) == [True, True]


# ---------------------------------------------------------------------------
# The port alone at 256 bits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case256():
    sk, pk = pt.keygen(256, random.Random(0x256D), device=CPU)
    rng = random.Random(0x256E)
    ct1 = _nested(pk, 3, rng)
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(pk, ct1, rng)
    proof = zd.prove(sk, ct1, ct2, a_l, b_l, SECPAR, random.Random(9))
    return dict(sk=sk, pk=pk, ct1=ct1, ct2=ct2, a=a_l, b=b_l, proof=proof)


def _same(p, q) -> bool:
    return all(torch.equal(getattr(p, f), getattr(q, f)) for f in FIELDS)


def test_crt_split_equals_full_width_256(case256):
    c = case256
    full = zd.prove(c["sk"], c["ct1"], c["ct2"], c["a"], c["b"], SECPAR,
                    random.Random(9), use_crt=False)
    assert _same(c["proof"], full)
    assert zd.verify(c["pk"], c["ct1"], c["ct2"], c["proof"]) == [True] * 3


def test_every_instance_passes_the_host_formula_256(case256):
    """Each instance against the reference's formulas with Python's pow
    (ddleq.go:129-153, random_oracle.go:10-32): alpha = base^(e^n mod
    n^2) * f^(n^2) mod n^3, base = ct2 if the oracle bit is set, else
    ct1."""
    c = case256
    pk = c["pk"]
    n, n2, n3 = pk.n, pk.n2, pk.n3
    ints = c["proof"].to_ints()
    c1, c2 = decode_batch(c["ct1"].c), decode_batch(c["ct2"].c)
    for i in range(3):
        for j in range(SECPAR):
            x, y, al, e, f = (ints[k][i][j] for k in FIELDS)
            assert x < n and y < n and e < n2 and f < n3
            base = c2[i] if oracle_bit(c1[i], c2[i], x, y, al) else c1[i]
            assert pow(base, pow(e, n, n2), n3) * pow(f, n2, n3) % n3 == al


def test_to_from_ints_roundtrip_256(case256):
    c = case256
    pk = c["pk"]
    ints = c["proof"].to_ints()
    back = zd.DDLEQProof.from_ints(L=pk.device(CPU).L, device=CPU, **ints)
    assert _same(back, c["proof"])
    assert [len(ints["x"]), len(ints["x"][0])] == [3, SECPAR]
    assert zd.verify(pk, c["ct1"], c["ct2"], back) == [True] * 3


def test_wrong_inputs_raise_256(case256):
    """A level-1 ciphertext, or a wrong a, raises ValueError."""
    c = case256
    sk = c["sk"]
    lvl1 = Ciphertext(c=c["ct1"].c[..., :2 * sk.device(CPU).L],
                      level=LEVEL_ONE)
    with pytest.raises(ValueError, match="level-2"):
        zd.prove(sk, lvl1, c["ct2"], c["a"], c["b"], SECPAR)
    with pytest.raises(ValueError, match="inputs are wrong"):
        zd.prove(sk, c["ct1"], c["ct2"], [a + 1 for a in c["a"]], c["b"],
                 SECPAR, random.Random(1))


def test_dropped_window_and_mesh_arguments_raise_256(case256):
    """The JAX package's ``window`` argument is not ported: a caller that
    passes it gets a TypeError.  ``mesh=None`` is accepted (the
    single-process path: the same proof and verdicts)."""
    c = case256
    args = (c["sk"], c["ct1"], c["ct2"], c["a"], c["b"], SECPAR,
            random.Random(1))
    with pytest.raises(TypeError):
        zd.prove(*args, 4)
    with pytest.raises(TypeError):
        zd.verify(c["pk"], c["ct1"], c["ct2"], c["proof"], 4)
    with pytest.raises(TypeError):
        list(zd.pipeline_prove_verify(c["sk"], [], SECPAR, 4))
    assert _same(zd.prove(*args[:-1], random.Random(9), mesh=None),
                 c["proof"])
    assert zd.verify(c["pk"], c["ct1"], c["ct2"], c["proof"],
                     mesh=None) == [True] * 3
    assert list(zd.pipeline_prove_verify(c["sk"], [], SECPAR,
                                         mesh=None)) == []


# ---------------------------------------------------------------------------
# The reference's own faults (ROADMAP C.4), not copied
# ---------------------------------------------------------------------------

def test_key_without_factors_proves_at_full_width_256(case256):
    """A SecretKey without p and q: the JAX prover crashes building its
    CRT plans (paillier_tpu/zk/ddleq.py:300); the port proves at full
    width, the same proof as with the split."""
    c = case256
    sk = c["sk"]
    bare = dataclasses.replace(sk, p=0, q=0)
    assert zd.crt_plans(bare, CPU) is None
    proof = zd.prove(bare, c["ct1"], c["ct2"], c["a"], c["b"], SECPAR,
                     random.Random(9))
    assert _same(proof, c["proof"])


def test_crt_halves_have_their_own_limb_counts():
    """p^3 and q^3 of different limb counts (a 130-bit p, a 120-bit q:
    25 and 23 limbs): the JAX prover gives both halves one count
    (paillier_tpu/zk/ddleq.py:162, 209); the port sizes each half, and
    the split proof equals the full-width one and verifies."""
    from paillier_tpu_torch.bigint import host as thost
    rng = random.Random(0xC4)
    p = thost.random_prime(130, rng=rng)
    q = thost.random_prime(120, rng=rng)
    n = p * q
    sk = SecretKey(n=n, g=n + 1, h=pow(rng.randrange(2, n), 2, n),
                   k=1 << 128, bits=256, lam=(p - 1) * (q - 1), p=p, q=q)
    plans = zd.crt_plans(sk, CPU)
    assert (plans.eng_p.converter.L, plans.eng_q.converter.L) == (25, 23)
    ct1 = _nested(sk, 2, rng)
    ct2, a_l, b_l = pt.homomorphic.nested_randomize(sk, ct1, rng)
    split = zd.prove(sk, ct1, ct2, a_l, b_l, 4, random.Random(2))
    full = zd.prove(sk, ct1, ct2, a_l, b_l, 4, random.Random(2),
                    use_crt=False)
    assert _same(split, full)
    assert zd.verify(sk.public(), ct1, ct2, split) == [True, True]


def test_prover_plans_stay_out_of_the_device_key_256(case256):
    """The JAX package caches the prover's CRT plans, derived from p and
    q, in the public-key DeviceKey (paillier_tpu/zk/ddleq.py:236-242);
    the port keeps them in the prover module's cache: the DeviceKey
    holds only its public engines (n^2, n^3) and public plans."""
    c = case256
    sk = c["sk"]
    dk = sk.device(CPU)
    plans = zd.crt_plans(sk, CPU)
    assert plans is zd.crt_plans(sk, CPU)                 # cached
    assert set(dk._engines) <= {LEVEL_ONE, LEVEL_TWO}
    secret = {sk.p, sk.q, sk.p ** 3, sk.q ** 3, sk.lam}
    for key in dk._plans:
        assert not secret & set(k for k in key if isinstance(k, int)), key
    for v in vars(dk).values():
        assert not isinstance(v, CrtSplit)
