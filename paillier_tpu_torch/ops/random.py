"""Randomness and group sampling (host control plane).

Mirrors the reference's crypto substrate (reference: utils.go:26-59):
uniform sampling below n, rejection sampling of Z_n^*, and random
quadratic-residue generators.  Every sampler takes the generator it
draws from: a ``random.Random`` made from a seed for reproducible runs,
or a ``secrets.SystemRandom`` (the default of :func:`make_rng`).  The
same generator state gives the same draws as the JAX package's
``paillier_tpu.ops.random``.
"""

from __future__ import annotations

import math
import random as _random
import secrets
from typing import Optional


def make_rng(seed: Optional[int] = None):
    """CSPRNG by default; deterministic ``random.Random`` when seeded."""
    return _random.Random(seed) if seed is not None else secrets.SystemRandom()


def random_unit(n: int, rng=None) -> int:
    """Uniform in Z_n^* by rejection (reference: utils.go:36-49)."""
    rng = rng or secrets.SystemRandom()
    while True:
        r = rng.randrange(n)
        if r != 0 and math.gcd(r, n) == 1:
            return r


def random_units(n: int, count: int, rng=None) -> list[int]:
    rng = rng or secrets.SystemRandom()
    return [random_unit(n, rng) for _ in range(count)]


def random_qr_generator(n: int, rng=None) -> int:
    """Random generator of the quadratic residues mod n, w.h.p. valid when n
    is a product of safe primes (reference: utils.go:53-59): r^2 mod n."""
    r = random_unit(n, rng)
    return (r * r) % n
