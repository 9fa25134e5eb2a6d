"""Plain share-decryption proofs of (t, l)-threshold Paillier: the prover
(thresholdkey.go:225-255), the verifier (:278-311) and the combiner that
drops a server whose proofs fail (:164-172), in Python integers and
``hashlib``.

One proof of server i on a ciphertext c, with prover randomness r < n^2:

    c_i = c^(2 l! s_i) mod n^2
    a   = (c^4)^r,  b = V^r  mod n^2
    e   = SHA-256(a || b || c^4 || c_i^2)   (c^4, c_i^2 unreduced)
    z   = r + e l! s_i

and the verifier checks e == SHA-256(a' || b' || c^4 || c_i^2) with
a' = (c^4)^z (c_i^2)^-e and b' = V^z v_i^-e mod n^2.

Frozen copies of the two encodings the program shares with the reference
(they are not arithmetic, so they cannot be worked out again): the
prover's draws of r (``rng.randrange(n^2)`` a row, in row order, from the
generator of each (request, server)), and the hash's transcript, each
integer as its minimal big-endian bytes, none for zero
(thresholdkey.go:319-326).
"""

from __future__ import annotations

import hashlib
import math
import random
from fractions import Fraction

from .paillier import Key, crt_pow, encrypt
from .threshold import partial, random_unit


def verification_keys(key: Key, l: int, shares: list[int],
                      rng) -> tuple[int, list[int]]:
    """The verification base v = u^2 mod n^2, u the dealer's first draw
    (a unit of Z_{n^2} by rejection, thresholdkey_generator.go:147-151,
    the one :func:`threshold.shares` passes over), and each server's
    verification key v_i = v^(l! s_i) mod n^2 (:246-254)."""
    n2 = key.n ** 2
    u = random_unit(n2, rng)
    v = u * u % n2
    return v, [crt_pow(key, v, math.factorial(l) * s, 2) for s in shares]


def draws(n2: int, seed: str, count: int) -> list[int]:
    """The first ``count`` values of r a prover draws from the generator
    ``random.Random(seed)``."""
    rng = random.Random(seed)
    return [rng.randrange(n2) for _ in range(count)]


def challenge(a: int, b: int, c4: int, ci2: int) -> int:
    """SHA-256(a || b || c^4 || c_i^2) as an integer."""
    h = hashlib.sha256()
    for v in (a, b, c4, ci2):
        h.update(v.to_bytes((v.bit_length() + 7) // 8, "big"))
    return int.from_bytes(h.digest(), "big")


def prove(key: Key, v: int, l: int, share: int, c: int, r: int) -> tuple:
    """(c_i, e, z) of server ``share``'s proof on ``c`` with randomness r."""
    n2 = key.n ** 2
    ci = partial(key, c, l, share)
    c4 = c ** 4
    a = crt_pow(key, c4 % n2, r, 2)
    b = crt_pow(key, v, r, 2)
    e = challenge(a, b, c4, ci * ci)
    return ci, e, r + e * math.factorial(l) * share


def prove_rows(key: Key, v: int, l: int, share: int, seed: str,
               rows: list[int], cs: list[int]) -> list[tuple]:
    """:func:`prove` on ``rows`` of a batch (``cs``: their ciphertexts),
    the randomness replayed from the prover's generator ``seed``."""
    rs = draws(key.n ** 2, seed, max(rows) + 1)
    return [prove(key, v, l, share, c, rs[j]) for j, c in zip(rows, cs)]


def verify(key: Key, v: int, vi: int, c: int, ci: int, e: int,
           z: int) -> bool:
    """The verdict on one proof (c_i, e, z) of the server whose
    verification key is ``vi``."""
    n2 = key.n ** 2
    if math.gcd(ci, key.n) != 1:
        return False                   # c_i^2 has no inverse mod n^2
    c4 = c ** 4
    a = crt_pow(key, c4 % n2, z, 2) * pow(
        crt_pow(key, ci * ci % n2, e, 2), -1, n2) % n2
    b = crt_pow(key, v, z, 2) * pow(crt_pow(key, vi, e, 2), -1, n2) % n2
    return challenge(a, b, c4, ci * ci) == e


def combine(key: Key, l: int, shares: dict) -> int:
    """The plaintext from the partial decryptions {server id: c_i} of one
    ciphertext: L(prod c_i^(2 lambda_i) mod n^2) (4 l!^2)^-1 mod n, with
    the exact Lagrange weights lambda_i = l! prod_j j / (j - i)."""
    n = key.n
    n2 = n * n
    delta = math.factorial(l)
    cprime = 1
    for i, ci in shares.items():
        lam = Fraction(delta)
        for j in shares:
            if j != i:
                lam *= Fraction(-j, i - j)
        w = 2 * int(lam)
        t = pow(ci, abs(w), n2)
        cprime = cprime * (t if w >= 0 else pow(t, -1, n2)) % n2
    return (cprime - 1) // n * pow(4 * delta * delta, -1, n) % n


def combine_with_proofs(key: Key, v: int, vis: dict, l: int, t: int,
                        c: int, proofs: dict) -> tuple:
    """CombinePartialDecryptionsZKP on one ciphertext: the verdicts
    {server id: bool} on ``proofs`` {server id: (c_i, e, z)}, the ids
    dropped (those whose proof fails) and the plaintext of the rest, or
    None where fewer than t remain."""
    verdicts = {i: verify(key, v, vis[i], c, *p) for i, p in proofs.items()}
    kept = {i: p[0] for i, p in proofs.items() if verdicts[i]}
    dropped = sorted(i for i, ok in verdicts.items() if not ok)
    m = combine(key, l, kept) if len(kept) >= t else None
    return verdicts, dropped, m


def check_server(key: Key, v: int, vi: int, l: int, share: int, seed: str,
                 rows: list[int], ms: list[int], rs: list[int],
                 got: list) -> tuple:
    """For one server and ``rows`` of a batch (plaintexts ``ms``,
    encryption randomness ``rs``): the reference's proofs [(c_i, e, z)]
    from the replayed r, and its verdicts on the program's proofs ``got``
    [(c_i, e, z) or None] of the same rows."""
    cs = [encrypt(key, m, r) for m, r in zip(ms, rs)]
    want = prove_rows(key, v, l, share, seed, rows, cs)
    verdicts = [g is not None and verify(key, v, vi, c, *g)
                for c, g in zip(cs, got)]
    return want, verdicts
