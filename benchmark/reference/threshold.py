"""Plain (t, l)-threshold Paillier: the shares and the partial decryptions.

The dealer's draws follow the reference's key generator
(thresholdkey_generator.go:147-231) from the generator the benchmark
hands both sides: the verification base v = r^2 mod n^2 with r a unit
drawn by rejection (utils.go:36-59), then the t - 1 random coefficients
of the polynomial whose constant term is d (d = 1 mod n, 0 mod p'q').
"""

from __future__ import annotations

import math

from .paillier import Key, crt_pow


def random_unit(n: int, rng) -> int:
    """Uniform in Z_n^* by rejection (utils.go:36-49)."""
    while True:
        r = rng.randrange(n)
        if r != 0 and math.gcd(r, n) == 1:
            return r


def shares(p: int, q: int, l: int, t: int, rng) -> list[int]:
    """The l Shamir shares f(1) .. f(l) mod n p'q' of the dealer whose
    draws come from ``rng``."""
    p1, q1 = (p - 1) // 2, (q - 1) // 2
    n = p * q
    m = p1 * q1
    nm = n * m
    d = pow(m, -1, n) * m % nm
    random_unit(n * n, rng)                       # the verification base
    coeffs = [d] + [rng.randrange(nm) for _ in range(t - 1)]
    return [sum(a * (i + 1) ** j for j, a in enumerate(coeffs)) % nm
            for i in range(l)]


def partial(key: Key, c: int, l: int, share: int) -> int:
    """A server's partial decryption c^(2 l! share) mod n^2
    (thresholdkey.go:192-201)."""
    return crt_pow(key, c, 2 * math.factorial(l) * share, 2)
