"""Key generation (reference: paillier.go:106-179).

Draws two secparam/2-bit primes congruent to 3 mod 4 (rejecting p == q),
sets N = p*q, G = N+1, K = 2^(secparam/2), lambda = phi(N) = (p-1)(q-1),
and H = a random quadratic-residue generator mod N.

The prime search runs on the host, or with :func:`device_batched_prime`,
which sieves candidates on the host and runs one batched Fermat test per
round on the device, each candidate its own modulus (kernel B4 on a CUDA
device): the batch analogue of the reference's goroutine race
(safe_prime.go:61-105).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bigint import host
from ..bigint import montgomery as mont
from ..ops import random as prand
from .keys import PublicKey, SecretKey


def keygen(secparam: int, rng=None, device_primes: Optional[bool] = None,
           *, device="cuda") -> Tuple[SecretKey, PublicKey]:
    """Generate a keypair; panics-as-exceptions match reference semantics
    (paillier.go:108-114).  The same ``random.Random`` state and the same
    ``device_primes`` give the same keys as
    ``paillier_tpu.core.keygen.keygen``.

    ``device_primes``: search the primes with :func:`device_batched_prime`
    on ``device``.  Default (None): as the JAX package decides, for keys
    of 2048 bits and more when no native GMP runtime is loaded, which the
    port never has (``host._native()``).  ``device`` is read only by the
    device search.
    """
    if secparam % 2 != 0:
        raise ValueError("keygen: secparam must be divisible by 2")
    if secparam < 64:
        raise ValueError("keygen: secparam must be at least 64 bits")

    rng = rng or prand.make_rng()
    half = secparam // 2
    if device_primes is None:
        device_primes = secparam >= 2048 and host._native() is None
    while True:
        if device_primes:
            p = device_batched_prime(half, rng, congruent_3_mod_4=True,
                                     device=device)
            q = device_batched_prime(half, rng, congruent_3_mod_4=True,
                                     device=device)
        else:
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


# ---------------------------------------------------------------------------
# Device-batched primality: host sieve + one batched modexp round per draw
# ---------------------------------------------------------------------------

_SIEVE_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def sieve_candidates(bits: int, count: int, rng=None, *,
                     congruent_3_mod_4: bool = False) -> list[int]:
    """Random odd ``bits``-bit candidates surviving the small-prime sieve
    (the batch analogue of safe_prime.go:208-218's product-mod trick)."""
    rng = rng or prand.make_rng()
    out = []
    while len(out) < count:
        c = rng.getrandbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if congruent_3_mod_4:
            c |= 2
        if any(c % sp == 0 for sp in _SIEVE_PRIMES):
            continue
        out.append(c)
    return out


def device_batched_prime(bits: int, rng=None, *, batch: int = 64,
                         congruent_3_mod_4: bool = False,
                         mr_rounds: int = 20, device="cuda") -> int:
    """Find a prime by testing a sieved batch of candidates per round with
    batched Fermat base-2 tests on ``device``, then confirming the
    survivor with host Miller-Rabin.

    Each candidate is its own modulus: the batch is one ladder over
    per-row Montgomery contexts and per-row exponents c - 1 (the JAX
    package ``vmap``s over stacked contexts).  Every Fermat batch adds one
    to ``device_batched_prime.batches``.
    """
    L = host.limbs_for_bits(bits)
    rng = rng or prand.make_rng()
    dev = torch.device(device)
    base = torch.zeros((batch, L), dtype=torch.int64, device=dev)
    base[:, 0] = 2

    while True:
        cands = sieve_candidates(bits, batch, rng,
                                 congruent_3_mod_4=congruent_3_mod_4)
        ctx = mont.stack_mont_ctx(cands, L, device=dev)
        exps = torch.as_tensor(host.ints_to_limbs([c - 1 for c in cands], L)
                               .astype("int64"), device=dev)
        res = mont.mont_pow_digits(ctx, base, mont.limbs_to_digits(exps, 4),
                                   4)
        device_batched_prime.batches += 1
        one = torch.zeros_like(res[0])
        one[0] = 1
        ok = (res == one).all(dim=-1).cpu().tolist()
        for c, passed in zip(cands, ok):
            if passed and host.is_probable_prime(c, mr_rounds):
                return c


device_batched_prime.batches = 0
