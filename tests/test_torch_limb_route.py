"""The port's limb engine (``bigint.engine.LimbEngine``: the engine
``make_engine`` gives a modulus past the RNS engine's width, such as
n^3 of a 4096-bit key) against the JAX package's limb-Montgomery
kernels, both on the CPU, and the package root's names against the JAX
root's.

The JAX package takes its limb route on its CPU backend by default, so
``montgomery.modmul``, ``encrypt_with_r_kernel``,
``alt_encrypt_with_r_kernel``, ``decrypt_kernel`` and
``homomorphic.aggregate_kernel`` of the JAX package get the inputs of
the port's ``Encryptor``, ``Decryptor`` and ``aggregate`` at 256- and
512-bit keys, levels 1 and 2, with ``rns2.MAX_MODULUS_BITS`` lowered so
that the factory gives the port's key the limb engine at both levels
(the port's ladders run the plain version on CPU tensors).  Then the
route itself: with the RNS engine's width limit lowered, a 256-bit key's
level 2 takes the limb engine through the port's entry points and gives
the JAX package's ciphertexts and plaintexts, and DDLEQ proofs equal the
RNS engine's; a 4096-bit key's level 2 takes it for real
(a 32-digit ladder on one row; a whole round trip there is ~170 s of
plain ladder on the CPU, so it runs only on the card).  Tolerance: exact
(limbs compared as uint32, values as ints).
"""

import ast
import dataclasses
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.bigint import montgomery as jmont
from paillier_tpu.core import decrypt as jdec
from paillier_tpu.core import encrypt as jenc
from paillier_tpu.core import homomorphic as jhom
from paillier_tpu.core.keygen import keygen as jkeygen
from paillier_tpu_torch import homomorphic as hom
from paillier_tpu_torch.bigint import host, rns2
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.bigint.engine import LimbEngine
from paillier_tpu_torch.core.keys import decode_batch, encode_batch
from paillier_tpu_torch.zk import ddleq as zd

torch.set_num_threads(2)
CPU = "cpu"
ROWS = 5


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _jl(vals, width):
    return jnp.asarray(host.ints_to_limbs(list(vals), width))


def test_root_exports_every_jax_name():
    """Every name that ``paillier_tpu/__init__.py`` binds is a name of
    ``paillier_tpu_torch`` (read from the JAX root's source, so the test
    does not depend on which submodules another test imported)."""
    path = os.path.join(os.path.dirname(__file__), "..", "paillier_tpu",
                        "__init__.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    assert len(names) > 50
    missing = sorted(n for n in names if not hasattr(pt, n))
    assert missing == []
    for name in ("combine", "ThresholdKeyGenerator", "verify_proof",
                 "collective", "mesh"):
        assert name in pt.__all__
    from paillier_tpu_torch import (combine, ThresholdKeyGenerator,  # noqa
                                    verify_proof)
    assert pt.collective.sharded_aggregate is pt.sharded_aggregate


@pytest.fixture(scope="module", params=[256, 512])
def keys(request):
    """(port secret key, JAX secret key) of one seed; the JAX key on its
    default (limb) engine."""
    bits = request.param
    tsk, _ = pt.keygen(bits, random.Random(bits + 0x11))
    jsk, _ = jkeygen(bits, random.Random(bits + 0x11))
    assert tsk.n == jsk.n and tsk.lam == jsk.lam and tsk.h == jsk.h
    assert not jsk.device().use_rns()
    return tsk, jsk


@pytest.fixture
def limb_keys(keys, monkeypatch):
    """The port's key of ``keys`` afresh (its DeviceKey builds its
    engines anew) with the RNS engine's limit below n^2, so that the
    factory gives both levels the limb engine; and the JAX key."""
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", 64)
    tsk, jsk = keys
    tsk = dataclasses.replace(tsk)
    dk = tsk.device(CPU)
    assert all(isinstance(dk.engine(lv), LimbEngine) for lv in (1, 2))
    return tsk, jsk


def _inputs(sk, level, seed):
    """ROWS plaintexts (0 and n^s - 1 among them), units r, short r < K."""
    rng = random.Random(seed)
    mod = sk.plaintext_modulus(level)
    ms = [rng.randrange(mod) for _ in range(ROWS - 2)] + [0, mod - 1]
    rs = [rng.randrange(1, sk.n) for _ in ms]
    ks = [rng.randrange(sk.k) for _ in ms]
    return ms, rs, ks


@pytest.mark.parametrize("level", [1, 2])
def test_modmul_vs_jax(keys, level):
    tsk, jsk = keys
    mod = tsk.modulus_for_level(level)
    W = tsk.device(CPU).limbs_for_level(level)
    rng = random.Random(level)
    a = [rng.randrange(mod) for _ in range(ROWS)] + [0, mod - 1]
    b = [rng.randrange(mod) for _ in range(ROWS)] + [mod - 1, mod - 1]
    got = LimbEngine(mod, W, device=CPU).mul(encode_batch(a, W, device=CPU),
                                             encode_batch(b, W, device=CPU))
    want = jmont.modmul(jsk.device().ctx_for_level(level), _jl(a, W),
                        _jl(b, W))
    assert np.array_equal(_u32(got), np.asarray(want))
    assert decode_batch(got) == [x * y % mod for x, y in zip(a, b)]


@pytest.mark.parametrize("level", [1, 2])
def test_encrypt_kernels_vs_jax(limb_keys, level):
    """Encryptor(pk, level) on the limb engine, regular and alternative:
    the limbs of the JAX functions encrypt_with_r_kernel and
    alt_encrypt_with_r_kernel, and the reference formulas."""
    tsk, jsk = limb_keys
    pk, jdk = tsk.public(), jsk.device()
    ms, rs, ks = _inputs(tsk, level, 0xE0 + level)
    L, s = tsk.device(CPU).L, level
    ns = tsk.n ** s
    nd = tmont.n_digits_for_bits(ns.bit_length(), 4)
    got = pt.Encryptor(pk, level, device=CPU).encrypt(ms, rs).c
    want = jenc.encrypt_with_r_kernel(jdk, _jl(ms, s * L),
                                      _jl(rs, (s + 1) * L), level,
                                      jnp.asarray(tmont.exp_digits(ns, 4, nd)),
                                      4)
    assert np.array_equal(_u32(got), np.asarray(want))
    N = tsk.modulus_for_level(level)
    assert decode_batch(got) == [pow(1 + tsk.n, m, N) * pow(r, ns, N) % N
                                 for m, r in zip(ms, rs)]
    enc = pt.Encryptor(pk, level, "alternative", device=CPU)
    got = enc.encrypt(ms, ks).c
    kd = tmont.n_digits_for_bits(tsk.k.bit_length() - 1, 4)
    rd = np.stack([tmont.exp_digits(k, 4, kd) for k in ks])
    want = jenc.alt_encrypt_with_r_kernel(jdk, _jl(ms, s * L),
                                          jnp.asarray(rd), level)
    assert np.array_equal(_u32(got), np.asarray(want))
    hs = enc.dk.hs_int_for_level(level)
    assert decode_batch(got) == [pow(1 + tsk.n, m, N) * pow(hs, k, N) % N
                                 for m, k in zip(ms, ks)]
    assert decode_batch(enc.dk.fixed_base(level, 4)[None]) == [hs]


@pytest.mark.parametrize("level", [1, 2])
def test_decrypt_kernel_vs_jax(limb_keys, level):
    """Decryptor(sk, level) on the limb engine (c^lambda on the limb
    ladder, then the recovery): the JAX decrypt_kernel's plaintext
    limbs, and the plaintexts."""
    tsk, jsk = limb_keys
    jdk = jsk.device()
    ms, rs, _ = _inputs(tsk, level, 0xD0 + level)
    N, s, L = tsk.modulus_for_level(level), level, tsk.device(CPU).L
    ns = tsk.n ** s
    cs = [pow(1 + tsk.n, m, N) * pow(r, ns, N) % N for m, r in zip(ms, rs)]
    nd = tmont.n_digits_for_bits(tsk.lam.bit_length(), 4)
    got = pt.Decryptor(tsk, level, device=CPU).decrypt_array(pt.Ciphertext(
        c=encode_batch(cs, (s + 1) * L, device=CPU), level=level))
    want = jdec.decrypt_kernel(
        jdk, _jl(cs, (s + 1) * L), level,
        jnp.asarray(tmont.exp_digits(tsk.lam, 4, nd)),
        _jl([pow(tsk.lam, -1, ns)], s * L)[0],
        _jl([tsk.n * pow(2, -1, tsk.n2) % tsk.n2], 2 * L)[0], 4)
    assert np.array_equal(_u32(got), np.asarray(want))
    assert decode_batch(got) == ms


@pytest.mark.parametrize("level", [1, 2])
def test_aggregate_kernel_vs_jax(limb_keys, level):
    """aggregate on the limb engine over ROWS rows (odd, so the tree
    pads) with its R^(t+1) fix: the limbs of the JAX aggregate_kernel,
    and the product."""
    tsk, jsk = limb_keys
    jdk = jsk.device()
    N = tsk.modulus_for_level(level)
    W = tsk.device(CPU).limbs_for_level(level)
    rng = random.Random(0xA6 + level)
    cs = [rng.randrange(1, N) for _ in range(ROWS)]
    got = hom.aggregate(tsk, pt.Ciphertext(
        c=encode_batch(cs, W, device=CPU), level=level)).c
    fix = pow(1 << (16 * W), hom._tree_r_power(ROWS) + 1, N)
    want = jhom.aggregate_kernel(jdk.ctx_for_level(level), _jl(cs, W),
                                 _jl([fix], W)[0])
    assert np.array_equal(_u32(got), np.asarray(want))
    prod = 1
    for c in cs:
        prod = prod * c % N
    assert decode_batch(got[None]) == [prod]


# ---------------------------------------------------------------------------
# The route through the entry points
# ---------------------------------------------------------------------------

def _sk(bits, seed):
    """A fake secret key of a random odd ``bits``-bit n (no factors):
    enough for the public-key paths and the width rules."""
    rng = random.Random(seed)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    return pt.SecretKey(n=n, g=n + 1, h=2, k=1 << (bits // 2), bits=bits,
                        lam=n - 1, p=3, q=5)


def test_width_rule_and_errors():
    """The engine of a level is chosen by its modulus' width alone: a
    4096-bit key takes the RNS engine at level 1 (n^2: 8,192 bits) and
    the limb engine at level 2 (n^3: 12,288 bits, B4's 768 limbs), where
    the Encryptor and Decryptor build and the RNS engine itself refuses
    the modulus.  An 8192-bit key takes the limb engine at both levels
    (n^2: 1,024 limbs, n^3: 1,536, kernel B4w's widths): its Encryptor
    builds at levels 1 and 2 (regular; the alternative one's host pow of
    h_2 at 24,576 bits is left to the card) and its Decryptor at level
    1, and neither level builds an RNS engine."""
    sk = _sk(4096, 1)
    pk = sk.public()
    dk = pk.device(CPU)
    dk.check_level(1)
    dk.check_level(2)
    for method in ("regular", "alternative"):
        assert pt.Encryptor(pk, 2, method, device=CPU).dk is dk
    pt.Decryptor(sk, 2, device=CPU)
    assert isinstance(dk.engine(2), LimbEngine)
    assert isinstance(sk.device(CPU).engine(2), LimbEngine)
    assert 1 not in dk._engines
    with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
        rns2.Rns2Engine(pk.n3, device=CPU)
    big = _sk(8192, 2)
    bpk = big.public()
    bdk = bpk.device(CPU)
    for level in (1, 2):
        bdk.check_level(level)
        assert pt.Encryptor(bpk, level, device=CPU).dk is bdk
    assert pt.Decryptor(big, 1, device=CPU).dk is big.device(CPU)
    assert [bdk.engine(lv).L for lv in (1, 2)] == [1024, 1536]
    for d in (bdk, big.device(CPU)):
        assert all(isinstance(e, LimbEngine) for e in d._engines.values())


def test_4096_level2_pow_and_mul_take_the_limb_ladder(monkeypatch):
    """DeviceKey(pk4096).pow at level 2 runs the limb ladder at L = 768:
    a 32-digit exponent on one row equals pow (the RNS engine is never
    built; the plain ladder is called once); pow_int and mul too."""
    sk = _sk(4096, 3)
    pk = sk.public()
    dk = pk.device(CPU)
    calls = []
    plain = tmont.mont_pow_digits_plain

    def counted(ctx, *a, **kw):
        calls.append(ctx.n_limbs)
        return plain(ctx, *a, **kw)

    from paillier_tpu_torch.bigint import mont_kernel
    monkeypatch.setattr(mont_kernel, "mont_pow_digits_plain", counted)
    rng = random.Random(7)
    x, y = rng.randrange(pk.n3), rng.randrange(pk.n3)
    e = rng.getrandbits(128) | 1 << 127
    xl = encode_batch([x], 768, device=CPU)
    got = dk.pow(2, xl, tmont.exp_digits(e, 4, 32))
    assert decode_batch(got) == [pow(x, e, pk.n3)] and calls == [768]
    assert decode_batch(dk.pow_int(2, xl, 0xF00D)) == [pow(x, 0xF00D, pk.n3)]
    assert calls == [768, 768]
    yl = encode_batch([y], 768, device=CPU)
    assert decode_batch(dk.mul(2, xl, yl)) == [x * y % pk.n3]
    assert list(dk._engines) == [2]


@pytest.fixture(scope="module")
def routed_keys():
    tsk, _ = pt.keygen(256, random.Random(0x2F))
    jsk, _ = jkeygen(256, random.Random(0x2F))
    return tsk, jsk


@pytest.fixture
def routed(routed_keys, monkeypatch):
    """A 256-bit key of both packages whose level 2 (n^3: 768 bits) takes
    the port's limb engine while the RNS engine's limit is lowered to 700
    bits; level 1 (n^2: 512 bits) keeps the RNS engine.  The port's key
    is a fresh copy, whose DeviceKey builds its engines under the
    limit."""
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", 700)
    tsk, jsk = routed_keys
    tsk = dataclasses.replace(tsk)
    dk = tsk.device(CPU)
    assert isinstance(dk.engine(2), LimbEngine)
    assert isinstance(dk.engine(1), rns2.Rns2Engine)
    return tsk, jsk


def test_routed_level2_entry_points(routed):
    """Encryptor(pk, 2) regular and alternative give the JAX Encryptor's
    ciphertexts from the same seeded rng; Decryptor(sk, 2) and
    nested_encrypt -> nested_add / nested_sub -> nested_decrypt round
    trip; the RNS engine of level 2 is never built."""
    tsk, jsk = routed
    tpk, jpk = tsk.public(), jsk.public()
    rng = random.Random(0x5A)
    ms = [rng.randrange(tpk.n2) for _ in range(ROWS)]
    cts = {}
    for method in ("regular", "alternative"):
        ct = pt.Encryptor(tpk, 2, method, rng=random.Random(9),
                          device=CPU).encrypt(ms)
        jct = jenc.Encryptor(jpk, 2, method, rng=random.Random(9)).encrypt(ms)
        assert np.array_equal(_u32(ct.c), np.asarray(jct.c)), method
        assert pt.Decryptor(tsk, 2, device=CPU).decrypt(ct) == ms
        cts[method] = ct
    xs = [rng.randrange(tpk.n) for _ in range(ROWS)]
    ys = [rng.randrange(tpk.n) for _ in range(ROWS)]
    nx = pt.nested_encrypt(tpk, xs, random.Random(3), device=CPU)
    yct = pt.Encryptor(tpk, device=CPU).encrypt(ys)
    got = pt.nested_decrypt(tsk, hom.nested_add(tpk, nx, yct), device=CPU)
    assert got == [(a + b) % tpk.n for a, b in zip(xs, ys)]
    got = pt.nested_decrypt(tsk, hom.nested_sub(tpk, nx, yct), device=CPU)
    assert got == [(a - b) % tpk.n for a, b in zip(xs, ys)]
    assert isinstance(tpk.device(CPU).engine(2), LimbEngine)


def test_routed_level2_homomorphic(routed):
    """add, sub, const_mult (shared and per-element), randomize,
    aggregate (against the JAX aggregate's limbs), nested_randomize and
    extract_randomness at level 2 on the limb route."""
    tsk, jsk = routed
    tpk = tsk.public()
    N, mod = tpk.n3, tpk.n2
    rng = random.Random(0x77)
    xs = [rng.randrange(mod) for _ in range(ROWS)]
    ys = [rng.randrange(mod) for _ in range(ROWS)]
    rs = [rng.randrange(1, tpk.n) for _ in range(ROWS)]
    enc = pt.Encryptor(tpk, 2, rng=rng, device=CPU)
    dec = pt.Decryptor(tsk, 2, device=CPU)
    cx, cy = enc.encrypt(xs, rs), enc.encrypt(ys)
    assert dec.decrypt(hom.add(tpk, cx, cy)) == [
        (a + b) % mod for a, b in zip(xs, ys)]
    assert dec.decrypt(hom.sub(tpk, cx, cy)) == [
        (a - b) % mod for a, b in zip(xs, ys)]
    k = rng.randrange(mod)
    ks = [rng.randrange(mod) for _ in range(ROWS)]
    assert dec.decrypt(hom.const_mult(tpk, cx, k)) == [a * k % mod
                                                      for a in xs]
    assert dec.decrypt(hom.const_mult(tpk, cx, ks)) == [
        a * b % mod for a, b in zip(xs, ks)]
    rnd = hom.randomize(tpk, cx, random.Random(4))
    assert dec.decrypt(rnd) == xs and not torch.equal(rnd.c, cx.c)
    agg = hom.aggregate(tpk, cx)
    jagg = jhom.aggregate(jsk.public(), jenc.Ciphertext(
        c=jnp.asarray(_u32(cx.c)), level=2))
    assert np.array_equal(_u32(agg.c), np.asarray(jagg.c))
    assert dec.decrypt(pt.Ciphertext(c=agg.c[None], level=2)) == [
        sum(xs) % mod]
    assert hom.extract_randomness(tsk, cx) == rs
    zs = [y % tpk.n for y in ys[:2]]
    nx = pt.nested_encrypt(tpk, zs, random.Random(5), device=CPU)
    nr, a_l, b_l = hom.nested_randomize(tpk, nx, random.Random(6))
    assert decode_batch(nr.c) == [
        pow(c, pow(a, tpk.n, tpk.n2), N) * pow(b, tpk.n2, N) % N
        for c, a, b in zip(decode_batch(nx.c), a_l, b_l)]
    assert pt.nested_decrypt(tsk, nr, device=CPU) == zs


def test_routed_ddleq_equals_the_rns_proofs(routed_keys, monkeypatch):
    """DDLEQ's level-2 ladders and products go through DeviceKey, so on
    the limb engine (the full-width prover and the verifier) the proofs
    are bit-identical to the RNS engine's from the same seed and
    verify."""
    tsk = dataclasses.replace(routed_keys[0])            # a fresh DeviceKey
    pk = tsk.public()
    ct1 = pt.nested_encrypt(pk, [5, 6], random.Random(1), device=CPU)
    ct2, a, b = hom.nested_randomize(pk, ct1, random.Random(2))
    want = zd.prove(tsk, ct1, ct2, a, b, 4, random.Random(3), use_crt=False)
    assert isinstance(tsk.device(CPU).engine(2), rns2.Rns2Engine)
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", 700)
    sk2 = dataclasses.replace(tsk)                      # a fresh DeviceKey
    got = zd.prove(sk2, ct1, ct2, a, b, 4, random.Random(3), use_crt=False)
    for f in ("x", "y", "alpha", "e", "f"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert zd.verify(sk2.public(), ct1, ct2, got) == [True, True]
    assert isinstance(sk2.device(CPU).engine(2), LimbEngine)
