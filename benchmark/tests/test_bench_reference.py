"""The plain reference against Python's ``pow`` and the textbook
formulas on a 256-bit key, and its frozen copies (the prover's draws,
the oracle's transcript, the dealer's draws) against the program's."""

import math
import random

import numpy as np
import pytest

from benchmark import inputs
from benchmark.reference import ddleq as rdd
from benchmark.reference import paillier as ref
from benchmark.reference import threshold as rth


@pytest.fixture(scope="module")
def key():
    p, q = inputs.key_primes(256, 99)
    return ref.Key(p, q)


def test_key_primes(key):
    assert key.n.bit_length() == 256 and key.p != key.q
    assert key.p % 4 == 3 and key.q % 4 == 3
    assert inputs.key_primes(256, 99) == (key.p, key.q)
    assert inputs.key_primes(256, 100) != (key.p, key.q)


def test_crt_pow_is_pow(key):
    rng = random.Random(1)
    for k in (2, 3):
        mod = key.n ** k
        for _ in range(20):
            b = inputs.unit(key.n, rng)
            e = rng.getrandbits(600)
            assert ref.crt_pow(key, b, e, k) == pow(b, e, mod)


def test_encrypt_decrypt(key):
    rng = random.Random(2)
    n, n2 = key.n, key.n ** 2
    for _ in range(20):
        m, r = rng.randrange(n), inputs.unit(n, rng)
        c = ref.encrypt(key, m, r)
        assert c == pow(n + 1, m, n2) * pow(r, n, n2) % n2
        assert ref.decrypt(key, c) == m
        c2 = ref.encrypt(key, c, r, 2)
        assert c2 == pow(n + 1, c, n ** 3) * pow(r, n2, n ** 3) % n ** 3


def test_lazy_never_equals():
    for x, m, w in ((0, 7, 4), (9, 7, 4), (3, 13, 4)):
        assert ref.lazy(x, m, w) != x


def test_threshold_partials_recover_the_plaintext():
    p = 2 * 1019 + 1          # safe primes: 2039 = 2*1019+1, 2063 = 2*1031+1
    q = 2 * 1031 + 1
    key = ref.Key(p, q)
    n, n2 = key.n, key.n ** 2
    shares = rth.shares(p, q, 5, 3, random.Random(5))
    delta = math.factorial(5)
    m, r = 12345, 77
    c = ref.encrypt(key, m, r)
    part = {i: rth.partial(key, c, 5, shares[i - 1]) for i in (1, 2, 3)}
    for i in part:
        assert part[i] == pow(c, 2 * delta * shares[i - 1], n2)
    cp = 1
    for i in part:
        lam = delta
        for j in part:
            if j != i:
                lam = lam * -j // (i - j)
        cp = cp * pow(part[i], 2 * lam, n2) % n2
    assert (cp - 1) // n * pow(4 * delta * delta, -1, n) % n == m


def test_dealer_draws_match_the_program():
    from paillier_tpu_torch.threshold import ThresholdKeyGenerator
    import json
    from benchmark.harness import BENCH
    d = json.loads((BENCH / "data" / "safe_primes_small.json").read_text())
    p, q = int(d["64"]["p"], 16), int(d["64"]["q"], 16)
    keys = ThresholdKeyGenerator(128, 5, 3, random.Random(8),
                                 device_verification_keys=False,
                                 device="cpu").generate_from_primes(
        p, (p - 1) // 2, q, (q - 1) // 2)
    assert [k.share for k in keys] == rth.shares(p, q, 5, 3,
                                                 random.Random(8))


def test_prover_draws_match_the_program(key):
    from paillier_tpu_torch.ops.random import random_units_limbs
    for n in (key.n, key.n * 3 + 2):
        want = random_units_limbs(n, 300, random.Random(3))
        got = rdd.draw_units(n, 300, random.Random(3))
        assert np.array_equal(inputs.to_limbs(got, want.shape[1]), want)


def test_oracle_matches_the_program(key):
    import torch
    from paillier_tpu_torch.zk.ddleq import _challenge_bits
    rng = random.Random(4)
    L = key.n.bit_length() // 16
    rows = [(rng.randrange(key.n ** 3), rng.randrange(key.n),
             rng.randrange(key.n), rng.randrange(key.n ** 3))
            for _ in range(32)] + [(5, 0, 1, 0)]
    cols = list(zip(*rows))
    widths = (3 * L, L, L, 3 * L)
    got = _challenge_bits(*(torch.as_tensor(inputs.to_limbs(c, w))
                            for c, w in zip(cols, widths)))
    assert got.tolist() == [rdd.challenge(*r) for r in rows]


def test_ddleq_instance_verifies(key):
    rng = random.Random(6)
    n = key.n
    m, r1, r2, a, b = (inputs.unit(n, rng) for _ in range(5))
    ct1 = rdd.nested_encrypt(key, m, r1, r2)
    ct2 = rdd.randomize(key, ct1, a, b)
    inst = [rdd.instance(key, ct1, ct2, a, b, r2, inputs.unit(n, rng),
                         inputs.unit(n, rng)) for _ in range(8)]
    assert rdd.verify(key, ct1, ct2, inst)
    other = rdd.randomize(key, ct1, a, inputs.unit(n, rng))
    assert not rdd.verify(key, ct1, other, inst)
    n3 = n ** 3
    x, y, alpha, e, f = inst[0]
    assert alpha == pow(ct1, pow(x, n, n * n), n3) * pow(y, n * n, n3) % n3


def test_limbs_round_trip():
    vals = [0, 1, 2 ** 255 + 7, 65535]
    arr = inputs.to_limbs(vals, 16)
    assert arr.dtype == np.int64 and arr.shape == (4, 16)
    assert inputs.from_limbs(arr) == vals
    bad = arr.copy()
    bad[1, 0] = -1
    assert inputs.from_limbs(bad)[1] != 1
