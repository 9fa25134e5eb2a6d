"""Randomness and group sampling (host control plane).

Mirrors the reference's crypto substrate (reference: utils.go:26-59):
uniform sampling below n, rejection sampling of Z_n^*, and random
quadratic-residue generators.  Every sampler takes the generator it
draws from: a ``random.Random`` made from a seed for reproducible runs,
or a ``secrets.SystemRandom`` (the default of :func:`make_rng`).  The
same generator state gives the same draws as the JAX package's
``paillier_tpu.ops.random``.

Units in bulk (:func:`random_units_rows`, and :func:`random_units` and
``Encryptor.encrypt`` on it) are drawn in batches, exactly: the same
values as :func:`random_unit` a row, in row order, and the generator left
in the same state.  A ``random.Random`` or ``secrets.SystemRandom``, or a
subclass that overrides none of ``getrandbits``, ``random``,
``randrange`` and ``_randbelow``, gives a round's candidates from one
``getrandbits`` call; any other generator takes the per-row loop.
"""

from __future__ import annotations

import math
import random as _random
import secrets
from typing import Optional

import numpy as np

from . import profiling
from .profiling import spanned

# What a per-row ``randrange(n)`` reads of its generator.
_DRAW_METHODS = ("getrandbits", "random", "randrange", "_randbelow")


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
    """``[random_unit(n, rng) for _ in range(count)]``, drawn in batches by
    :func:`random_units_rows` (same values, same generator state)."""
    from ..bigint import host
    return host.limbs_to_ints(random_units_rows(n, count, rng))


def _batchable(rng) -> bool:
    """Whether ``rng``'s per-row draws are provably the words of one
    ``getrandbits`` call: a ``random.Random`` or ``secrets.SystemRandom``
    whose class and instance override none of :data:`_DRAW_METHODS`."""
    for base in (secrets.SystemRandom, _random.Random):
        if isinstance(rng, base):
            return not any(getattr(type(rng), a) is not getattr(base, a)
                           or a in vars(rng) for a in _DRAW_METHODS)
    return False


def _below(limbs: np.ndarray, n_row: np.ndarray, top: int) -> np.ndarray:
    """Rows of ``limbs`` (uint16, none above limb ``top``) below ``n_row``
    (int64, n's top limb at ``top``): that limb decides, and on a tie the
    most significant limb that differs from n."""
    below = limbs[:, top] < n_row[top]
    tie = np.flatnonzero(limbs[:, top] == n_row[top])
    if tie.size:
        diff = limbs[tie].astype(np.int64) - n_row[None, :]
        nz = diff != 0
        msd = limbs.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
        below[tie] = nz.any(axis=1) & (diff[np.arange(tie.size), msd] < 0)
    return below


def _units(limbs: np.ndarray, n: int) -> np.ndarray:
    """Rows of ``limbs`` (uint16, each in [1, n)) with gcd(r, n) == 1:
    one threaded native call over a big-endian buffer, else ``math.gcd``
    a row."""
    from ..bigint import host
    nat = host._native()
    if nat is None:
        return np.array([math.gcd(r, n) == 1
                         for r in host.limbs_to_ints(limbs)], dtype=bool)
    return nat.invertible_mask(limbs.view(np.uint8)[:, ::-1], n)


@spanned("host_int", op="units")
def random_units_rows(n: int, count: int, rng=None,
                      n_limbs: Optional[int] = None) -> np.ndarray:
    """Uniform Z_n^* as int64 [count, n_limbs] little-endian 16-bit limbs:
    the values of ``[random_unit(n, rng) for _ in range(count)]``, and
    ``rng`` left in the same state.

    A per-row ``randrange(n)`` takes k-bit candidates (k = n.bit_length())
    from ``getrandbits(k)``, W = ceil(k / 32) 32-bit words each, until one
    is below n, and :func:`random_unit` rejects 0 and non-units besides:
    the rows are the first ``count`` accepted candidates of that stream.
    So a round draws the candidates of the rows still missing with one
    ``getrandbits(32 * W * need)`` (row i: words iW..iW+W-1, the top one
    shifted down to k bits) and rejects those >= n or 0 on their limbs,
    until the candidates left fill the missing rows; one native call then
    rejects the non-units among them, which are drawn again after them,
    and the rest are kept in stream order.
    A generator that :func:`_batchable` refuses takes the per-row loop.
    Counters: ``units.rows``, ``units.redrawn`` (>= n or 0),
    ``units.nonunit`` (the batched path), ``units.per_row`` (the loop).
    """
    from ..bigint import host
    rng = rng or secrets.SystemRandom()
    k = n.bit_length()
    L = n_limbs or host.limbs_for_bits(k)
    if L < host.limbs_for_bits(k):
        raise ValueError(f"{L} limbs cannot hold a {k}-bit unit")
    if not _batchable(rng):
        profiling.count("units.per_row", count)
        return host.ints_to_limbs([random_unit(n, rng) for _ in range(count)],
                                  L).astype(np.int64)

    W = (k + 31) // 32
    width = min(L, 2 * W)                  # limbs past k bits are zero
    n_row = host.int_to_limbs(n, 2 * W).astype(np.int64)
    top = host.limbs_for_bits(k) - 1
    out = np.zeros((count, L), dtype=np.int64)
    done = redrawn = nonunit = 0
    while done < count:
        cand, have = [], 0           # candidates in [1, n), in stream order
        while have < count - done:
            need = count - done - have
            words = np.frombuffer(
                rng.getrandbits(32 * W * need).to_bytes(4 * W * need,
                                                        "little"),
                dtype="<u4").reshape(need, W).copy()
            words[:, -1] >>= 32 * W - k
            limbs = words.view("<u2")                   # [need, 2W]
            cand.append(limbs[_below(limbs, n_row, top) & limbs.any(axis=1)])
            have += len(cand[-1])
            redrawn += need - len(cand[-1])
        cand = np.concatenate(cand)
        got = cand[_units(cand, n)]
        out[done:done + len(got), :width] = got[:, :width]
        done += len(got)
        nonunit += len(cand) - len(got)
    profiling.count("units.rows", count)
    profiling.count("units.redrawn", redrawn)
    profiling.count("units.nonunit", nonunit)
    return out


@spanned("host_int", op="units")
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
