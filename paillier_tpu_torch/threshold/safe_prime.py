"""Safe (Sophie Germain) prime generation (reference: safe_prime.go:61-266).

The port's copy of ``paillier_tpu.threshold.safe_prime``, host-only.  The
reference races goroutines and cancels on the first winner; here a batch
of candidates q is drawn from the caller's rng and the first that passes
(q prime, p = 2q + 1 prime) wins:

* at >= 128 bits, the native GMP runtime (:mod:`paillier_tpu_torch.native`)
  races threads over a batch of 2048 candidates and returns the lowest
  passing index, so the result depends only on the rng stream (the same
  seed gives the JAX package's (p, q));
* below, or without the native runtime, a sieved Python loop: q == 1
  (mod 3) is rejected (it forces 3 | 2q + 1), then Miller-Rabin on q and a
  Pocklington / Fermat base-2 test on p.
"""

from __future__ import annotations

import time
from typing import Tuple

from ..bigint import host
from ..ops import random as prand

_SIEVE = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53]


class SafePrimeTimeout(Exception):
    pass


def _candidate(bits: int, rng) -> int:
    """Random odd ``bits``-bit value with the top two bits set
    (safe_prime.go:183-200)."""
    return rng.getrandbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1


def generate_safe_prime(bits: int, timeout: float = 120.0, rng=None,
                        batch: int = 64) -> Tuple[int, int]:
    """Return (p, q) with p = 2q + 1 both prime, p of ``bits`` bits.

    Raises ValueError for bits < 6 and SafePrimeTimeout on expiry,
    mirroring the reference's error contract (safe_prime.go:67-69,
    95-104).
    """
    if bits < 6:
        raise ValueError("safe prime size must be at least 6 bits")
    rng = rng or prand.make_rng()
    qbits = bits - 1
    deadline = time.monotonic() + timeout

    if bits >= 128:
        nat = host._native()
        if nat is not None:
            while time.monotonic() < deadline:
                cands = [_candidate(qbits, rng) for _ in range(2048)]
                idx = nat.first_prime(cands, safe=True, reps=20)
                if idx is not None:
                    q = cands[idx]
                    return 2 * q + 1, q
            raise SafePrimeTimeout(f"generator timed out after {timeout}s")

    while time.monotonic() < deadline:
        cands = []
        while len(cands) < batch and time.monotonic() < deadline:
            q = _candidate(qbits, rng)
            if qbits > 6 and any(q % s == 0 for s in _SIEVE):
                continue
            # q == 1 (mod 3) forces p = 2q+1 == 0 (mod 3)
            # (safe_prime.go:225-241)
            if q % 3 == 1:
                continue
            p = 2 * q + 1
            if any(p % s == 0 and p != s for s in _SIEVE):
                continue
            cands.append((p, q))
        for p, q in cands:
            if q.bit_length() != qbits:
                continue
            if host.is_probable_prime(q, 20) and _pocklington(p):
                return p, q
    raise SafePrimeTimeout(f"generator timed out after {timeout}s")


def _pocklington(p: int) -> bool:
    """Fermat base-2: 2^(p-1) == 1 (mod p); with q prime this proves p
    prime by Pocklington's criterion (safe_prime.go:272-278)."""
    return pow(2, p - 1, p) == 1


def is_safe_prime(p: int) -> bool:
    """p and (p-1)/2 both prime (cf. utils_test.go:66-82)."""
    return (p % 2 == 1 and host.is_probable_prime(p)
            and host.is_probable_prime((p - 1) // 2))
