"""Key generation (reference: paillier.go:106-179).

Draws two secparam/2-bit primes congruent to 3 mod 4 (rejecting p == q),
sets N = p*q, G = N+1, K = 2^(secparam/2), lambda = phi(N) = (p-1)(q-1),
and H = a random quadratic-residue generator mod N.

The prime search runs on the host in pure Python.  The JAX package's
device-batched Fermat search (``device_batched_prime``) is not ported
yet (ROADMAP A.12).
"""

from __future__ import annotations

from typing import Tuple

from ..bigint import host
from ..ops import random as prand
from .keys import PublicKey, SecretKey


def keygen(secparam: int, rng=None) -> Tuple[SecretKey, PublicKey]:
    """Generate a keypair; panics-as-exceptions match reference semantics
    (paillier.go:108-114).  The same ``random.Random`` state gives the
    same keys as ``paillier_tpu.core.keygen.keygen``."""
    if secparam % 2 != 0:
        raise ValueError("keygen: secparam must be divisible by 2")
    if secparam < 64:
        raise ValueError("keygen: secparam must be at least 64 bits")

    rng = rng or prand.make_rng()
    half = secparam // 2
    while True:
        p = host.random_prime(half, congruent_3_mod_4=True, rng=rng)
        q = host.random_prime(half, congruent_3_mod_4=True, rng=rng)
        if p != q:
            break

    n = p * q
    lam = (p - 1) * (q - 1)
    g = n + 1
    k = 1 << half
    h = prand.random_qr_generator(n, rng)

    sk = SecretKey(n=n, g=g, h=h, k=k, bits=n.bit_length(),
                   lam=lam, p=p, q=q)
    return sk, sk.public()
