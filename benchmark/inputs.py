"""Inputs made by the benchmark from ``--seed``, handed alike to the
program and to the reference: keys' primes, plaintexts, randomness.

Each use draws from a stream of its own (``stream(seed, tag)``), so one
input does not shift when another's count changes.  Limbs are the
program's layout: little-endian 16-bit digits in int64.
"""

from __future__ import annotations

import math
import random

import numpy as np

_SMALL = [p for p in range(3, 2000) if all(p % d for d in range(2, p))]
_SMALL_PRODUCT = math.prod(_SMALL)


def stream(seed: int, tag: str) -> random.Random:
    """A generator of its own for each (seed, tag)."""
    return random.Random(f"{seed}/{tag}")


def _probable_prime(c: int, rng: random.Random, rounds: int = 24) -> bool:
    d, s = c - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for i in range(rounds):
        a = 2 if i == 0 else rng.randrange(3, c - 2)
        x = pow(a, d, c)
        if x in (1, c - 1):
            continue
        for _ in range(s - 1):
            x = x * x % c
            if x == c - 1:
                break
        else:
            return False
    return True


def prime(bits: int, rng: random.Random) -> int:
    """A ``bits``-bit prime = 3 mod 4 with its two top bits set (so a
    product of two has exactly 2 * bits bits): sieved candidates, then
    Miller-Rabin."""
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 3
        if math.gcd(c, _SMALL_PRODUCT) == 1 and _probable_prime(c, rng):
            return c


def key_primes(bits: int, seed: int) -> tuple[int, int]:
    """The two primes of a ``bits``-bit Paillier key from the seed."""
    rng = stream(seed, "key")
    p = prime(bits // 2, rng)
    while True:
        q = prime(bits // 2, rng)
        if q != p:
            return p, q


def secret_key(bits: int, seed: int):
    """The program's ``SecretKey`` on the seed's primes, with h = a seeded
    unit squared; the reference takes the same primes."""
    from paillier_tpu_torch.core.keys import SecretKey
    p, q = key_primes(bits, seed)
    n = p * q
    h = unit(n, stream(seed, "h")) ** 2 % n
    return SecretKey(n=n, g=n + 1, h=h, k=1 << (bits // 2),
                     bits=n.bit_length(), lam=(p - 1) * (q - 1), p=p, q=q)


def unit(n: int, rng: random.Random) -> int:
    while True:
        r = rng.randrange(1, n)
        if math.gcd(r, n) == 1:
            return r


def to_limbs(values, n_limbs: int) -> np.ndarray:
    """Python ints -> int64 [len, n_limbs] little-endian 16-bit limbs."""
    buf = b"".join(v.to_bytes(2 * n_limbs, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, n_limbs).astype(
        np.int64)


def from_limbs(arr) -> list[int]:
    """int64 limbs [rows, L] (numpy, or a tensor on any device) -> ints.
    A limb outside 0..65535 is kept as it reads, so a malformed output
    never compares equal by accident."""
    a = np.asarray(arr.cpu() if hasattr(arr, "cpu") else arr,
                   dtype=np.int64)
    a = a.reshape(-1, a.shape[-1])
    out = []
    for row in a:
        if row.min() < 0 or row.max() > 0xFFFF:
            out.append(sum(int(v) << (16 * i) for i, v in enumerate(row)))
        else:
            out.append(int.from_bytes(row.astype("<u2").tobytes(), "little"))
    return out
