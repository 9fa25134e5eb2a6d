"""The port's host-side modules against the JAX package's: the vectorized
unit sampler (``ops.random``), fixed-point encoding (``ops.encoding``)
and the serialization format (``ops.serialize``).

All numpy / Python on the CPU, no JAX compile: the sampler must draw
from a seeded ``random.Random`` exactly as the JAX package's does (or no
DDLEQ proof could match), encoding must give equal values, and the
serialized bytes and key JSON must be identical, each loading in the
other package.  Tolerance: none.
"""

import math
import random
import secrets
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import keys as jkeys
from paillier_tpu.ops import encoding as jenc
from paillier_tpu.ops import random as jrand
from paillier_tpu.ops import serialize as jser
from paillier_tpu.threshold import keys as jtkeys
from paillier_tpu_torch.core import keys as tkeys
from paillier_tpu_torch.bigint import host as thost
from paillier_tpu_torch.ops import encoding as tenc
from paillier_tpu_torch.ops import profiling
from paillier_tpu_torch.ops import random as trand
from paillier_tpu_torch.ops import serialize as tser
from paillier_tpu_torch.threshold import keys as ttkeys

CPU = "cpu"


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


# ---------------------------------------------------------------------------
# ops.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [128, 191, 192, 256, 2048])
@pytest.mark.parametrize("n_limbs", [None, 160])
def test_random_units_limbs_matches_jax(bits, n_limbs):
    """Below 192 bits the per-element path, from 192 up one ``randbytes``
    a round with whole-array rejection: the same limbs as the JAX
    package's from the same seed (int64 here, uint32 there), and the
    generator left in the same state."""
    n = _odd(random.Random(bits), bits)
    tr, jr = random.Random(7), random.Random(7)
    got = trand.random_units_limbs(n, 300, tr, n_limbs)
    want = jrand.random_units_limbs(n, 300, jr, n_limbs)
    assert got.dtype == np.int64
    assert np.array_equal(got, want.astype(np.int64))
    assert tr.getstate() == jr.getstate()
    vals = pt.host.limbs_to_ints(got)
    assert all(0 < v < n for v in vals)


def test_random_units_limbs_rejects_draws_above_n():
    """An n just above 2^(bits-1): about half of the draws are >= n and
    are drawn again, as in the JAX package."""
    n = (1 << 255) + 0x1234567
    tr, jr = random.Random(3), random.Random(3)
    got = trand.random_units_limbs(n, 64, tr)
    assert np.array_equal(got, jrand.random_units_limbs(n, 64, jr))
    assert tr.getstate() == jr.getstate()
    assert all(0 < v < n for v in pt.host.limbs_to_ints(got))


class _OwnBits(random.Random):
    """Overrides ``getrandbits``: its draws cannot be batched exactly."""

    def getrandbits(self, k):
        return super().getrandbits(k)


def _unit_counters():
    c = profiling.take()["counters"]
    return {k: c.get(f"units.{k}", 0)
            for k in ("rows", "redrawn", "nonunit", "per_row")}


_M127 = (1 << 127) - 1                        # a prime q


@pytest.mark.parametrize("n,native,gen,engages", [
    (_odd(random.Random(2048), 2048), True, random.Random, "rows"),
    (_odd(random.Random(2047), 2047), True, random.Random, "rows"),
    (_odd(random.Random(2000), 2000), True, random.Random, "rows"),
    (_odd(random.Random(1025), 1025), True, random.Random, "rows"),
    ((1 << 2047) + 0x1234567, True, random.Random, "redrawn"),
    (3 * 5 * 7 * 11 * _M127, True, random.Random, "nonunit"),
    (3 * 5 * 7 * 11 * _M127, False, random.Random, "nonunit"),
    (_odd(random.Random(2048), 2048), True, _OwnBits, "per_row"),
], ids=["k2048", "k2047", "k2000", "k1025", "above_2^2047",
        "composite_native", "composite_gcd", "own_getrandbits"])
def test_random_units_rows_match_the_per_row_draws(n, native, gen, engages,
                                                   monkeypatch):
    """k mod 32 in {0, 31, 16, 1}, half the draws >= n, a composite n with
    small factors (native unit test and ``math.gcd``), and a generator
    that takes the per-row loop: ``random_units_rows`` and
    ``random_units`` give the per-row ``random_unit`` values and the JAX
    package's ``random_units``, and leave the generator in their state."""
    if not native:
        monkeypatch.setattr(thost, "_native", lambda: None)
    count, L = 200, thost.limbs_for_bits(n.bit_length()) + 3
    rows_rng, ints_rng, per_rng, jax_rng = (gen(11) for _ in range(4))
    before = _unit_counters()
    rows = trand.random_units_rows(n, count, rows_rng, L)
    ints = trand.random_units(n, count, ints_rng)
    after = _unit_counters()
    want = [trand.random_unit(n, per_rng) for _ in range(count)]
    assert rows.dtype == np.int64 and rows.shape == (count, L)
    assert thost.limbs_to_ints(rows) == ints == want
    assert ints == jrand.random_units(n, count, jax_rng)
    state = per_rng.getstate()
    assert rows_rng.getstate() == ints_rng.getstate() == state
    assert jax_rng.getstate() == state
    assert all(0 < r < n and math.gcd(r, n) == 1 for r in want)
    moved = {k: after[k] - before[k] for k in after}
    batched = engages != "per_row"
    assert moved["rows"] == (2 * count if batched else 0)
    assert moved["per_row"] == (0 if batched else 2 * count)
    if engages in ("redrawn", "nonunit"):
        assert moved[engages] > 0


def test_random_units_rows_system_random():
    """``secrets.SystemRandom`` takes the batched path: every row a unit
    below n."""
    n = 3 * 5 * 7 * 11 * _M127
    before = _unit_counters()
    vals = thost.limbs_to_ints(
        trand.random_units_rows(n, 300, secrets.SystemRandom()))
    assert _unit_counters()["rows"] - before["rows"] == 300
    assert len(vals) == 300
    assert all(0 < r < n and math.gcd(r, n) == 1 for r in vals)


def test_random_below_matches_jax():
    n = _odd(random.Random(1), 300)
    tr, jr = random.Random(5), random.Random(5)
    assert ([trand.random_below(n, tr) for _ in range(20)]
            == [jrand.random_below(n, jr) for _ in range(20)])
    assert 0 <= trand.random_below(7) < 7


# ---------------------------------------------------------------------------
# ops.encoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,prec", [(1.5, 8), (-1.5, 8), (0.1, 40),
                                    ("3.14159", 20), (Fraction(-7, 3), 16),
                                    (0, 5), (-0.0001, 10)])
def test_fixed_point_matches_jax(a, prec):
    v = tenc.encode_fixed_point(a, prec)
    assert v == jenc.encode_fixed_point(a, prec)
    assert tenc.decode_fixed_point(v, prec) == jenc.decode_fixed_point(v,
                                                                       prec)


def test_signed_and_batch_match_jax():
    n = _odd(random.Random(2), 64)
    for v in (0, 1, -1, 12345, -(n // 2 - 1), n // 2 - 1):
        e = tenc.encode_signed(v, n)
        assert e == jenc.encode_signed(v, n)
        assert tenc.decode_signed(e, n) == jenc.decode_signed(e, n) == v
    for bad in (n // 2 + 1, -(n // 2 + 1)):
        with pytest.raises(ValueError):
            tenc.encode_signed(bad, n)
        with pytest.raises(ValueError):
            jenc.encode_signed(bad, n)
    vals = [0.5, "2.25", -3]
    assert (tenc.encode_fixed_point_batch(vals, 12)
            == jenc.encode_fixed_point_batch(vals, 12))
    assert pt.encode_fixed_point is tenc.encode_fixed_point


# ---------------------------------------------------------------------------
# ops.serialize
# ---------------------------------------------------------------------------

def _key_fields(seed):
    rng = random.Random(seed)
    p, q = _odd(rng, 64), _odd(rng, 64)
    n = p * q
    return dict(n=n, g=n + 1, h=rng.randrange(n), k=1 << 64, bits=128), \
        dict(lam=(p - 1) * (q - 1), p=p, q=q)


@pytest.mark.parametrize("level,method,shape", [
    (1, "regular", (5,)), (2, "alternative", (3,)), (1, "mixed", ()),
    (2, "regular", (1,))])
def test_ciphertext_bytes_identical_and_cross_load(level, method, shape):
    """Same limbs, level and method: byte-identical serializations; bytes
    written by either package load in the other with equal limbs, level
    and method (the port's onto the device asked for)."""
    rng = random.Random(level * 10 + len(shape))
    width = 8 * (level + 1)
    vals = [rng.getrandbits(16 * width) for _ in range(max(1, *shape, 1))]
    limbs = pt.host.ints_to_limbs(vals, width)
    if not shape:
        limbs = limbs[0]
    tct = tkeys.Ciphertext(c=torch.as_tensor(limbs.astype(np.int64)),
                           level=level, method=method)
    jct = jkeys.Ciphertext(c=jnp.asarray(limbs), level=level, method=method)
    data = tser.ciphertext_to_bytes(tct)
    assert data == jser.ciphertext_to_bytes(jct)
    back = tser.ciphertext_from_bytes(jser.ciphertext_to_bytes(jct),
                                      device=CPU)
    assert back.c.dtype == torch.int64 and back.c.device.type == CPU
    assert np.array_equal(back.c.numpy(), np.atleast_2d(limbs))
    assert (back.level, back.method) == (level, method)
    jback = jser.ciphertext_from_bytes(data)
    assert np.array_equal(np.asarray(jback.c), np.atleast_2d(limbs))
    assert (jback.level, jback.method) == (level, method)


def test_encrypted_ciphertext_round_trips_through_jax_bytes():
    """A ciphertext the port encrypts, written by the port, read by the
    JAX package, written again and read back by the port, decrypts to
    its plaintexts."""
    sk, pk = pt.keygen(128, random.Random(4), device=CPU)
    ms = [0, 1, 99, pk.n - 1]
    ct = pt.Encryptor(pk, device=CPU, rng=random.Random(5)).encrypt(ms)
    j = jser.ciphertext_from_bytes(tser.ciphertext_to_bytes(ct))
    back = pt.ciphertext_from_bytes(jser.ciphertext_to_bytes(j), device=CPU)
    assert torch.equal(back.c, ct.c)
    assert pt.Decryptor(sk, device=CPU).decrypt(back) == ms


def test_ciphertext_from_bytes_defaults_to_the_card():
    import inspect
    assert inspect.signature(tser.ciphertext_from_bytes).parameters[
        "device"].default == "cuda"


@pytest.mark.parametrize("data,match", [
    (b"", "no data"), (b"JUNKJUNKJUNKJUNKJUNK", "not a paillier_tpu"),
    (b"PTPU", "not a paillier_tpu"),
    (b"PTPU\x02\x01\x00\x02\x01\x00\x00\x00\x01\x00\x00\x00\x00\x00\x00\x00",
     "unsupported version 2")])
def test_ciphertext_error_paths_match_jax(data, match):
    with pytest.raises(ValueError, match=match):
        tser.ciphertext_from_bytes(data, device=CPU)
    with pytest.raises(ValueError, match=match):
        jser.ciphertext_from_bytes(data)


def test_unknown_method_code_raises_keyerror_in_both():
    data = bytearray(jser.ciphertext_to_bytes(jkeys.Ciphertext(
        c=jnp.zeros((1, 4), jnp.uint32))))
    data[6] = 9                                   # the method byte
    with pytest.raises(KeyError):
        tser.ciphertext_from_bytes(bytes(data), device=CPU)
    with pytest.raises(KeyError):
        jser.ciphertext_from_bytes(bytes(data))


def _key_pairs():
    base, sec = _key_fields(11)
    thr = dict(l=5, t=3, v=base["h"] ** 2 % base["n"] ** 2,
               vi=(3, 5, 7, 11, 13))
    return {
        "public": (tkeys.PublicKey(**base), jkeys.PublicKey(**base)),
        "secret": (tkeys.SecretKey(**base, **sec),
                   jkeys.SecretKey(**base, **sec)),
        "threshold_public": (ttkeys.ThresholdPublicKey(**base, **thr),
                             jtkeys.ThresholdPublicKey(**base, **thr)),
        "threshold_secret": (
            ttkeys.ThresholdSecretKey(**base, **thr, id=2, share=1234567),
            jtkeys.ThresholdSecretKey(**base, **thr, id=2, share=1234567)),
    }


@pytest.mark.parametrize("kind", ["public", "secret", "threshold_public",
                                  "threshold_secret"])
def test_key_json_identical_and_cross_load(kind):
    """The port's JSON of each kind of key equals the JAX package's; each
    package loads the other's into its own class of that kind with the
    same fields."""
    tk, jk = _key_pairs()[kind]
    s = tser.public_key_to_json(tk)
    assert s == jser.public_key_to_json(jk)
    assert f'"kind": "{kind}"' in s
    fields = [f for f in ("n", "g", "h", "k", "bits", "lam", "p", "q", "l",
                          "t", "v", "vi", "id", "share") if hasattr(jk, f)]
    tback = tser.key_from_json(jser.public_key_to_json(jk))
    assert type(tback) is type(tk)
    assert all(getattr(tback, f) == getattr(tk, f) for f in fields)
    jback = jser.key_from_json(s)
    assert type(jback) is type(jk)
    assert all(getattr(jback, f) == getattr(jk, f) for f in fields)


def test_unknown_key_kind_raises_in_both():
    s = '{"kind": "other", "n": "0x3", "g": "0x4", "h": "0x1", "k": "0x2", ' \
        '"bits": 2}'
    with pytest.raises(ValueError, match="unknown key kind 'other'"):
        tser.key_from_json(s)
    with pytest.raises(ValueError, match="unknown key kind 'other'"):
        jser.key_from_json(s)
