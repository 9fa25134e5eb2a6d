"""Plain Paillier and Damgard-Jurik (s = 2) arithmetic in Python integers.

Every power of a unit runs as two half-width powers by the Chinese
remainder theorem (mod p^k and q^k, with the exponent reduced by the
group order p^(k-1)(p-1)), which is exact and about twice as fast as one
full-width ``pow``.  Values are canonical: each result lies in
[0, modulus).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Key:
    """A Paillier key from its two primes, with what the CRT needs."""

    p: int
    q: int

    @property
    def n(self) -> int:
        return self.p * self.q

    @property
    def lam(self) -> int:
        return (self.p - 1) * (self.q - 1)


def crt_pow(key: Key, base: int, exp: int, k: int) -> int:
    """base^exp mod n^k for a unit ``base``, by halves mod p^k and q^k."""
    p, q = key.p, key.q
    pk, qk = p ** k, q ** k
    xp = pow(base % pk, exp % (p ** (k - 1) * (p - 1)), pk)
    xq = pow(base % qk, exp % (q ** (k - 1) * (q - 1)), qk)
    return xp + pk * ((xq - xp) * pow(pk, -1, qk) % qk)


def gm(n: int, m: int, s: int) -> int:
    """(1 + n)^m mod n^(s+1) by the binomial identity (s = 1 or 2)."""
    mod = n ** (s + 1)
    if s == 1:
        return (1 + m * n) % mod
    return (1 + m * n + (m * (m - 1) // 2) * n * n) % mod


def encrypt(key: Key, m: int, r: int, s: int = 1) -> int:
    """Regular encryption G^m * r^(n^s) mod n^(s+1) (G = n + 1)."""
    n = key.n
    mod = n ** (s + 1)
    return gm(n, m, s) * crt_pow(key, r, n ** s, s + 1) % mod


def decrypt(key: Key, c: int) -> int:
    """Level-1 decryption: L(c^lambda mod n^2) * lambda^-1 mod n."""
    n = key.n
    u = crt_pow(key, c, key.lam, 2)
    return (u - 1) // n * pow(key.lam, -1, n) % n


def lazy(x: int, modulus: int, width_bits: int) -> int:
    """The control's output: ``x`` left one modulus above its canonical
    value (the final conditional subtraction skipped), wrapped at the
    output's width.  Never equal to ``x`` for 0 < modulus < 2^width."""
    return (x + modulus) % (1 << width_bits)


def is_unit(x: int, n: int) -> bool:
    return x != 0 and math.gcd(x, n) == 1
