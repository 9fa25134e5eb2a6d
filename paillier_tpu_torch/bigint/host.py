"""Host-side big-integer helpers (Python ints).

This module is the *control-plane* arithmetic: modular inverses, gcds,
primality testing, limb conversion.  It mirrors the role that ``math/big``
plays in the reference implementation (reference: utils.go:11-69,
safe_prime.go:61-105), while all *data-plane* (batched, hot) arithmetic
lives on-device in :mod:`paillier_tpu_torch.bigint.vpu` /
:mod:`paillier_tpu_torch.bigint.rns2`.

It also serves as the correctness oracle for the device kernels: every
device op has a property test against these functions.
"""

from __future__ import annotations

import math
import secrets
from typing import Iterable, Sequence

import numpy as np

from ..ops.profiling import spanned


def _native():
    """The native GMP host-math runtime (:mod:`paillier_tpu_torch.native`),
    or None (pure-Python fallback)."""
    from .. import native
    return native if native.available() else None


# Limb parameters for the device representation: little-endian base-2^16
# digits.  The host helpers below produce uint32 numpy arrays (the JAX
# package's format); the port's tensors hold the same digits in int64,
# because torch's uint32 has no add or shift on the CPU.
LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1


def limbs_for_bits(bits: int) -> int:
    """Number of limbs needed to hold a ``bits``-bit integer."""
    return max(1, (bits + LIMB_BITS - 1) // LIMB_BITS)


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian base-2^16 limb decomposition of ``x`` as uint32[n_limbs]."""
    if x < 0:
        raise ValueError("negative integers have no limb representation")
    if x >> (LIMB_BITS * n_limbs):
        raise ValueError(f"{x.bit_length()}-bit value does not fit in {n_limbs} limbs")
    return np.frombuffer(x.to_bytes(2 * n_limbs, "little"),
                         dtype="<u2").astype(np.uint32)


def limbs_to_int(limbs: Sequence[int] | np.ndarray) -> int:
    """Inverse of :func:`int_to_limbs` (accepts unnormalized uint32 limbs)."""
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[0] - 1, -1, -1):
        x = (x << LIMB_BITS) + int(arr[i])
    return x


def ints_to_limbs(xs: Iterable[int], n_limbs: int) -> np.ndarray:
    """Batch of ints -> uint32[batch, n_limbs] (vectorized via a byte
    buffer: one int.to_bytes per row, the limb packing in numpy)."""
    xs = list(xs)
    nb = 2 * n_limbs
    buf = bytearray(len(xs) * nb)
    for b, x in enumerate(xs):
        if x < 0:
            raise ValueError("negative integers have no limb representation")
        buf[b * nb:(b + 1) * nb] = x.to_bytes(nb, "little")
    raw = np.frombuffer(bytes(buf), dtype=np.uint8).reshape(len(xs), nb)
    return (raw[:, 0::2].astype(np.uint32)
            | (raw[:, 1::2].astype(np.uint32) << 8))


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    """uint32[batch, n_limbs] -> list of ints (vectorized: numpy packs
    the bytes, one int.from_bytes per row)."""
    arr = np.asarray(arr, dtype=np.uint64)
    if arr.ndim == 1:
        return [limbs_to_int(arr)]
    # normalize unreduced limbs (values may exceed 16 bits): propagate
    # carries so the byte packing below is exact
    if (arr >> LIMB_BITS).any():
        carry = np.zeros(arr.shape[0], dtype=np.uint64)
        out = np.empty_like(arr)
        for i in range(arr.shape[1]):
            cur = arr[:, i] + carry
            out[:, i] = cur & LIMB_MASK
            carry = cur >> LIMB_BITS
        if carry.any():
            # overflowing top carry: fall back to the exact per-row path
            return [limbs_to_int(row) for row in np.asarray(arr)]
        arr = out
    lo = (arr & 0xFF).astype(np.uint8)
    hi = ((arr >> np.uint64(8)) & np.uint64(0xFF)).astype(np.uint8)
    b = np.empty((arr.shape[0], arr.shape[1] * 2), np.uint8)
    b[:, 0::2] = lo
    b[:, 1::2] = hi
    return [int.from_bytes(row.tobytes(), "little") for row in b]


# ---------------------------------------------------------------------------
# Modular arithmetic helpers (control plane)
# ---------------------------------------------------------------------------

def modinv(a: int, n: int) -> int:
    """Multiplicative inverse of a mod n.  Raises ValueError if not invertible."""
    nat = _native()
    if nat is not None and n.bit_length() > 512:
        return nat.modinv(a % n, n)
    return pow(a, -1, n)


@spanned("host_int", op="modinv")
def modinv_batch(values, n: int) -> list[int]:
    """Batched modular inverse: native threaded GMP when available,
    else the Montgomery batch-inversion trick (one inverse plus
    3(B-1) multiplies instead of B inverses)."""
    values = list(values)
    if not values:
        return []
    nat = _native()
    if nat is not None and n.bit_length() > 256 and len(values) > 4:
        return nat.modinv_batch(values, n)
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = (prefix[i] * v) % n
    inv = modinv(prefix[-1], n)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = (prefix[i] * inv) % n
        inv = (inv * values[i]) % n
    return out


def gcd(a: int, b: int) -> int:
    return math.gcd(a, b)


def mont_n0_inv(n: int) -> int:
    """-n^{-1} mod 2^LIMB_BITS (the Montgomery n0' constant)."""
    return (-pow(n, -1, LIMB_BASE)) % LIMB_BASE


def mont_nprime(n: int, n_limbs: int) -> int:
    """-n^{-1} mod R with R = 2^(LIMB_BITS * n_limbs) (for SOS reduction)."""
    r = 1 << (LIMB_BITS * n_limbs)
    return (-pow(n, -1, r)) % r


def hensel_inverse(n: int, n_limbs: int) -> int:
    """n^{-1} mod 2^(LIMB_BITS*n_limbs), for exact division by odd n on device."""
    return pow(n, -1, 1 << (LIMB_BITS * n_limbs))


# ---------------------------------------------------------------------------
# Primality (host control plane; native GMP when it loads)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113]


def is_probable_prime(n: int, rounds: int = 30) -> bool:
    """Miller-Rabin with random witnesses (reference: safe_prime.go:256 uses
    Go's ProbablyPrime(20) = Miller-Rabin + Baillie-PSW).

    Large inputs route to the native GMP runtime (BPSW + Miller-Rabin)
    when it is available — the same engine the reference leans on.
    """
    if n < 2:
        return False
    if n.bit_length() > 64:
        nat = _native()
        if nat is not None:
            return nat.is_probable_prime(n, rounds)
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = 2 + secrets.randbelow(n - 3)
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(s - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def random_prime(bits: int, *, congruent_3_mod_4: bool = False,
                 rng=None) -> int:
    """Random prime of exactly ``bits`` bits (top bit set).

    With ``congruent_3_mod_4`` the prime is ≡ 3 (mod 4), as required by the
    reference key generator (reference: paillier.go:131-137).  The top two
    bits are set so products of two such primes have full bit length (the
    same convention as Go's rand.Prime used by the reference).
    """
    randbits = rng.getrandbits if rng is not None else secrets.randbits
    while True:
        cand = randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if congruent_3_mod_4:
            cand |= 2  # ensure cand % 4 == 3
        if cand.bit_length() != bits:
            continue
        if congruent_3_mod_4 and cand % 4 != 3:
            continue
        if is_probable_prime(cand):
            return cand


def factorial(n: int) -> int:
    """n! (reference: utils.go:17-23)."""
    return math.factorial(n)
