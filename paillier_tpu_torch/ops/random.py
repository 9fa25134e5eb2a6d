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

import numpy as np


def make_rng(seed: Optional[int] = None):
    """CSPRNG by default; deterministic ``random.Random`` when seeded."""
    return _random.Random(seed) if seed is not None else secrets.SystemRandom()


def random_below(n: int, rng=None) -> int:
    """Uniform in [0, n) (reference: utils.go:26-33)."""
    rng = rng or secrets.SystemRandom()
    return rng.randrange(n)


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


def random_units_limbs(n: int, count: int, rng=None,
                       n_limbs: Optional[int] = None) -> np.ndarray:
    """Uniform Z_n^* as int64 [count, n_limbs] little-endian 16-bit limbs.

    Below 192 bits of n: :func:`random_units`, element by element.  From
    192 bits up, vectorized for proof batches: entropy arrives as one
    ``randbytes`` call a round and rejection resampling runs on whole
    arrays.  There the gcd(r, n) == 1 check is waived: for RSA-type
    moduli it fails with probability (p + q) / n < 2^-94, far below the
    2^-80 soundness floor wherever this sampler is used (the reference
    rejection-samples at utils.go:36-49).  Both paths draw from ``rng``
    exactly as ``paillier_tpu.ops.random.random_units_limbs`` does, so a
    seeded generator gives the JAX package's values.
    """
    from ..bigint import host
    rng = rng or secrets.SystemRandom()
    nbits = n.bit_length()
    L = n_limbs or host.limbs_for_bits(nbits)
    if nbits < 192:
        return host.ints_to_limbs(random_units(n, count, rng),
                                  L).astype(np.int64)

    nbytes = (nbits + 7) // 8
    topmask = (1 << (((nbits - 1) % 8) + 1)) - 1
    n_le = np.frombuffer(n.to_bytes(2 * ((nbytes + 1) // 2), "little"),
                         dtype=np.uint8).astype(np.int64)
    n_limbs_arr = n_le[0::2] | (n_le[1::2] << 8)

    out = np.zeros((count, L), dtype=np.int64)
    todo = np.arange(count)
    while todo.size:
        raw = np.frombuffer(rng.randbytes(todo.size * nbytes),
                            dtype=np.uint8).reshape(todo.size, nbytes).copy()
        raw[:, 0] &= topmask                       # big-endian draw < 2^nbits
        le = raw[:, ::-1]                          # little-endian bytes
        if nbytes % 2:
            le = np.concatenate(
                [le, np.zeros((todo.size, 1), np.uint8)], axis=1)
        limbs = le[:, 0::2].astype(np.int64) | (le[:, 1::2].astype(np.int64)
                                                << 8)
        # r < n: the most significant limb that differs from n decides
        diff = limbs - n_limbs_arr[None, :]
        nz = diff != 0
        msd = limbs.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
        below = nz.any(axis=1) & (diff[np.arange(todo.size), msd] < 0)
        ok = below & limbs.any(axis=1)
        out[todo[ok], :limbs.shape[1]] = limbs[ok]
        todo = todo[~ok]
    return out


def random_qr_generator(n: int, rng=None) -> int:
    """Random generator of the quadratic residues mod n, w.h.p. valid when n
    is a product of safe primes (reference: utils.go:53-59): r^2 mod n."""
    r = random_unit(n, rng)
    return (r * r) % n
