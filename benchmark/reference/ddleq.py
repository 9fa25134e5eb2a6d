"""Plain DDLEQ proofs of nested re-encryption (ddleq.go:55-153).

The relation: ct2 = ct1^(a^n mod n^2) * b^(n^2) mod n^3.  One instance of
a proof, with prover randomness (x, y):

    alpha = ct1^(x^n mod n^2) * y^(n^2) mod n^3
    chal  = SHA-256(ct2 || x || y || alpha) mod 2
    e     = chal ? x * a^-1 mod n^2 : x
    f     = chal ? y * s^(x^n) * (s^(a^n) * b)^-(e^n mod n^2) mod n^3 : y

with s the randomness of ct1 (ct1 = G^m' s^(n^2) mod n^3).  The verifier
checks alpha == (chal ? ct2 : ct1)^(e^n mod n^2) * f^(n^2) mod n^3.

Frozen copies of the two encodings the program shares with the reference
(they are not arithmetic, so they cannot be worked out again): the
prover's draws of x and y from its generator, and the oracle's
transcript, each integer hashed as its minimal big-endian bytes (none for
zero) with ct1 left out (random_oracle.go:10-32).
"""

from __future__ import annotations

import hashlib

from .paillier import Key, crt_pow, encrypt


def draw_units(n: int, count: int, rng) -> list[int]:
    """``count`` units below ``n`` drawn as the prover draws its x and y
    for moduli of 192 bits and more: each round takes ``rng.randbytes``
    for every value still missing, masks the top byte to n's width and
    keeps the big-endian draws in (0, n) (the gcd test is waived: it
    fails with probability below 2^-94 for an RSA modulus)."""
    nbits = n.bit_length()
    nbytes = (nbits + 7) // 8
    topmask = (1 << (((nbits - 1) % 8) + 1)) - 1
    out: list = [None] * count
    todo = list(range(count))
    while todo:
        raw = rng.randbytes(len(todo) * nbytes)
        left = []
        for j, i in enumerate(todo):
            b = bytearray(raw[j * nbytes:(j + 1) * nbytes])
            b[0] &= topmask
            v = int.from_bytes(b, "big")
            if 0 < v < n:
                out[i] = v
            else:
                left.append(i)
        todo = left
    return out


def challenge(c2: int, x: int, y: int, alpha: int) -> int:
    """The Fiat-Shamir bit of one instance."""
    data = b"".join(v.to_bytes((v.bit_length() + 7) // 8, "big")
                    for v in (c2, x, y, alpha))
    return hashlib.sha256(data).digest()[-1] & 1


def nested_encrypt(key: Key, m: int, r1: int, r2: int) -> int:
    """Enc_2(Enc_1(m; r1); r2): the level-1 ciphertext is the level-2
    plaintext."""
    return encrypt(key, encrypt(key, m, r1, 1), r2, 2)


def randomize(key: Key, ct1: int, a: int, b: int) -> int:
    """ct1^(a^n mod n^2) * b^(n^2) mod n^3."""
    n = key.n
    an = crt_pow(key, a, n, 2)
    return crt_pow(key, ct1, an, 3) * crt_pow(key, b, n * n, 3) % n ** 3


def instance(key: Key, ct1: int, ct2: int, a: int, b: int, s: int,
             x: int, y: int) -> tuple:
    """(x, y, alpha, e, f) of one instance, canonical."""
    n = key.n
    n2, n3 = n * n, n ** 3
    xn = crt_pow(key, x, n, 2)
    alpha = crt_pow(key, ct1, xn, 3) * crt_pow(key, y, n2, 3) % n3
    if not challenge(ct2, x, y, alpha):
        return x, y, alpha, x, y
    e = x * pow(a, -1, n2) % n2
    en = crt_pow(key, e, n, 2)
    t = crt_pow(key, s, crt_pow(key, a, n, 2), 3) * b % n3
    f = (y * crt_pow(key, s, xn, 3) * crt_pow(key, pow(t, -1, n3), en, 3)
         % n3)
    return x, y, alpha, e, f


def verify(key: Key, ct1: int, ct2: int, inst: list) -> bool:
    """The verdict on a proof's instances [(x, y, alpha, e, f), ...]:
    False at the first instance that does not check."""
    n = key.n
    n3 = n ** 3
    for x, y, alpha, e, f in inst:
        base = ct2 if challenge(ct2, x, y, alpha) else ct1
        en = crt_pow(key, e, n, 2)
        if crt_pow(key, base, en, 3) * crt_pow(key, f, n * n, 3) % n3 \
                != alpha:
            return False
    return True
