"""The engine seam of the port (``paillier_tpu_torch.bigint.engine``):
``make_engine``'s choice of engine by width, ``product_tree`` on both
engines, and ``CrtSplit``'s Garner step on both of its reductions, all
against Python integers on the CPU (the ladders run their plain
versions).  Tolerance: exact.
"""

import random

import pytest
import torch

from paillier_tpu_torch.bigint import host, rns2
from paillier_tpu_torch.bigint.engine import (CrtSplit, LimbEngine,
                                              make_engine, product_tree)
from paillier_tpu_torch.core.homomorphic import _tree_r_power
from paillier_tpu_torch.core.keys import decode_batch, encode_batch

torch.set_num_threads(2)
CPU = "cpu"
P, Q = host.random_prime(64, rng=random.Random(1)), \
    host.random_prime(64, rng=random.Random(2))


def _engine(kind, modulus):
    cls = LimbEngine if kind == "limb" else rns2.Rns2Engine
    return cls(modulus, host.limbs_for_bits(modulus.bit_length()),
               device=CPU)


@pytest.mark.parametrize("past", [0, 1], ids=["at", "past"])
@pytest.mark.parametrize("name", ["n^2", "n^3", "p^2", "p^3"])
def test_factory_picks_the_engine_by_width(name, past, monkeypatch):
    """With the RNS engine's limit set to the modulus' width the factory
    gives the RNS engine, one bit below it the limb engine, each at the
    limbs asked for."""
    f = P * Q if name[0] == "n" else P
    modulus = f ** int(name[-1])
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS",
                        modulus.bit_length() - past)
    L = host.limbs_for_bits(modulus.bit_length()) + 1
    eng = make_engine(modulus, L, device=CPU)
    assert type(eng) is (LimbEngine if past else rns2.Rns2Engine)
    x = random.Random(L).randrange(modulus)
    got = eng.to_limbs_mod(eng.from_limbs(encode_batch([x], L, device=CPU)))
    assert got.shape == (1, L) and decode_batch(got) == [x]


@pytest.mark.parametrize("rows", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["rns", "limb"])
def test_product_tree_on_both_engines(kind, rows):
    """product_tree of ``mul`` over 1, 2, 3 and 5 rows (odd levels padded
    with the engine's 1) is the product mod N, and of ``mont_mul`` with
    the radix^(t+1) fix-up too."""
    N = (P * Q) ** 2
    eng = _engine(kind, N)
    rng = random.Random(rows)
    vals = [[rng.randrange(N) for _ in range(2)] for _ in range(rows)]
    x = eng.from_limbs(torch.stack([encode_batch(v, 16, device=CPU)
                                    for v in vals]))
    want = [1, 1]
    for v in vals:
        want = [w * a % N for w, a in zip(want, v)]
    got = eng.to_limbs_mod(product_tree(eng.mul, x, eng.one))
    assert decode_batch(got) == want
    fix = eng.encode([pow(eng.radix, _tree_r_power(rows) + 1, N)])[0]
    got = eng.mont_mul(product_tree(eng.mont_mul, x, eng.one),
                       fix.expand(x.shape[1:]))
    assert decode_batch(eng.to_limbs_mod(got)) == want


@pytest.mark.parametrize("s,join", [(2, 1), (3, 3)], ids=["p2-join1", "p3"])
@pytest.mark.parametrize("order", ["p<q", "p>2q"])
def test_crt_split_joins_by_either_reduction(s, join, order):
    """CrtSplit's pow_shared and pow against pow mod (p q)^s (a 64-bit and
    a 64- or 60-bit prime); its Garner step reduces m_p by one
    conditional subtract where p^j < 2 q^j, else by a fold, and combine
    gives CRT's m either way."""
    p, q = (P, Q) if P < Q else (Q, P)
    if order == "p>2q":
        p, q = q, host.random_prime(60, rng=random.Random(3))
    L = host.limbs_for_bits((p * q).bit_length())
    split = CrtSplit(p, q, s, L, device=CPU, join=join)
    a, b = p ** join, q ** join
    assert (split.fold_ab is None) == (a < 2 * b)
    rng = random.Random(s)
    ma, mb = [rng.randrange(a) for _ in range(4)], [rng.randrange(b)
                                                   for _ in range(4)]
    la, lb = (host.limbs_for_bits(v.bit_length()) for v in (a, b))
    got = split.combine(encode_batch(ma, la, device=CPU),
                        encode_batch(mb, lb, device=CPU))
    assert got.shape[-1] == join * L
    assert [v % a for v in decode_batch(got)] == ma
    assert [v % b for v in decode_batch(got)] == mb
    assert all(v < a * b for v in decode_batch(got))
    if join != s:
        return
    N = (p * q) ** s
    xs = [x for x in (rng.randrange(N) for _ in range(8))
          if x % p and x % q][:3]
    x = encode_batch(xs, s * L, device=CPU)
    e = rng.getrandbits(70)
    assert decode_batch(split.pow_shared(x, e)) == [pow(v, e, N) for v in xs]
    digits = torch.tensor([[1, 2, 3], [15, 0, 7], [0, 0, 1]])
    ev = [0x123, 0xF07, 0x001]
    assert decode_batch(split.pow(x, digits, 4)) == [
        pow(v, k, N) for v, k in zip(xs, ev)]


@pytest.mark.parametrize("kind", ["rns", "limb"])
def test_one_plus_mul_on_both_engines(kind):
    """one_plus_mul makes the integer 1 + x*c from limbs of half the
    engine's width (level-1 G^m = 1 + m n); the limb engine builds its
    constant-product plan once per c and width."""
    n = P * Q
    eng = _engine(kind, n * n)
    xs = [0, 1, n - 1, random.Random(4).randrange(n)]
    half = host.limbs_for_bits(n.bit_length())
    got = eng.one_plus_mul(encode_batch(xs, half, device=CPU), n)
    assert decode_batch(eng.to_limbs_mod(got)) == [1 + x * n for x in xs]
    if kind == "limb":
        plans = dict(eng._plans)
        eng.one_plus_mul(encode_batch(xs, half, device=CPU), n)
        assert eng._plans == plans and len(plans) == 1


@pytest.mark.parametrize("kind", ["rns", "limb"])
def test_engines_refuse_wider_limbs(kind):
    """from_limbs zero-extends a narrower input and refuses a wider one
    rather than drop its top limbs."""
    N = (P * Q) ** 2
    eng = _engine(kind, N)
    L = host.limbs_for_bits(N.bit_length())
    x = encode_batch([N >> 16], L - 1, device=CPU)
    assert decode_batch(eng.to_limbs_mod(eng.from_limbs(x))) == [N >> 16]
    with pytest.raises(ValueError, match="do not fit"):
        eng.from_limbs(encode_batch([N - 1, 1 << (16 * L)], L + 1,
                                    device=CPU))


@pytest.mark.parametrize("kind", ["rns", "limb"])
def test_pow_shared_keeps_the_last_exponents(kind, monkeypatch):
    """pow_shared keeps the ladder data of the rns2.EXPONENT_CACHE
    exponents seen last, no more, and is right for every exponent."""
    monkeypatch.setattr(rns2, "EXPONENT_CACHE", 3)
    N = (P * Q) ** 2
    eng = _engine(kind, N)
    cache = eng._digits if kind == "limb" else eng._schedule
    x = random.Random(5).randrange(N)
    xl = eng.from_limbs(encode_batch(
        [x], host.limbs_for_bits(N.bit_length()), device=CPU))
    for e in (3, 5, 7, 9, 11, 3):
        assert decode_batch(eng.to_limbs_mod(eng.pow_shared(xl, e))) == [
            pow(x, e, N)]
    assert cache.cache_info().currsize == 3
    assert cache.cache_info().misses == 6
