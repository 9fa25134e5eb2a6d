"""Threshold key generation (reference: thresholdkey_generator.go:19-278).

Two safe-prime pairs p = 2p1+1, q = 2q1+1; n = pq, m = p1q1;
d == 1 (mod n), d == 0 (mod m) via CRT; a random degree-(t-1) Shamir
polynomial over Z_nm with a0 = d; share_i = f(i+1) mod nm; verification
keys v_i = v^(delta * s_i) mod n^2.

Primes, polynomial and shares are host work.  The l verification keys
are one batched ladder with per-row exponent digits on the limb
Montgomery layer at any key width: kernel B4 on a CUDA device up to 768
limbs (n^2 of a 6144-bit key), B4w past it, the plain version on the
CPU.  ``device_verification_keys=False`` takes host ``pow`` for them, as
in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..bigint import host
from ..bigint import montgomery as mont
from ..ops import random as prand
from .keys import ThresholdSecretKey
from .safe_prime import generate_safe_prime, is_safe_prime

# Digit width of the verification keys' ladder (the JAX package's).
VK_WINDOW = 4
# Safe-prime search timeout in seconds (the reference's,
# thresholdkey_generator.go:90).
KEYGEN_TIMEOUT = 120.0


@dataclass
class ThresholdKeyGenerator:
    """(l, t)-threshold key generator for ``bits``-bit keys.  ``device``
    is where the verification keys' ladder runs (kernel B4 or B4w on
    "cuda")."""

    bits: int
    l: int                      # total number of decryption servers
    t: int                      # threshold
    rng: object = None
    timeout: float = KEYGEN_TIMEOUT
    device_verification_keys: bool = True
    device: object = "cuda"

    def __post_init__(self):
        # validation mirrors NewThresholdKeyGenerator
        # (thresholdkey_generator.go:62-86)
        if self.bits % 2 == 1:
            raise ValueError("Public key bit length must be an even number")
        if self.bits < 18:
            raise ValueError("Public key bit length must be at least 18 bits")
        self.rng = self.rng or prand.make_rng()

    def _init_ps_and_qs(self):
        while True:
            p, p1 = generate_safe_prime(self.bits // 2, self.timeout, self.rng)
            q, q1 = generate_safe_prime(self.bits // 2, self.timeout, self.rng)
            # distinctness retry (thresholdkey_generator.go:120-144)
            if p != q and p != q1 and p1 != q:
                return p, p1, q, q1

    def generate(self) -> List[ThresholdSecretKey]:
        return self.generate_from_primes(*self._init_ps_and_qs())

    def generate_from_primes(self, p: int, p1: int, q: int, q1: int
                             ) -> List[ThresholdSecretKey]:
        """Key generation from caller-supplied safe-prime pairs
        p = 2*p1 + 1, q = 2*q1 + 1 (e.g. fixed fixtures, so a benchmark
        measures decryption rather than the prime search), fully
        validated (structure and primality).  The polynomial, share and
        verification-key steps are :meth:`generate`'s
        (thresholdkey_generator.go:177-278)."""
        if p != 2 * p1 + 1 or q != 2 * q1 + 1:
            raise ValueError("primes must satisfy p = 2*p1+1, q = 2*q1+1")
        if not (is_safe_prime(p) and is_safe_prime(q)):
            raise ValueError("p and q must be safe primes")
        n = p * q
        m = p1 * q1
        nm = n * m
        n2 = n * n
        # d = 1 mod n, 0 mod m (thresholdkey_generator.go:177-180)
        d = (pow(m, -1, n) * m) % nm
        # v: QR generator of Z_{n^2} (thresholdkey_generator.go:147-151)
        v = prand.random_qr_generator(n2, self.rng)
        # hiding polynomial, a0 = d (thresholdkey_generator.go:197-209)
        coeffs = [d] + [self.rng.randrange(nm) for _ in range(self.t - 1)]
        # share_i = f(i+1) mod nm (thresholdkey_generator.go:213-231)
        shares = [compute_share(coeffs, i, nm) for i in range(self.l)]
        vi = self._verification_keys(v, shares, host.factorial(self.l), n2)
        return [ThresholdSecretKey(n=n, g=n + 1, h=0, k=0, bits=self.bits,
                                   l=self.l, t=self.t, v=v, vi=tuple(vi),
                                   id=i + 1, share=shares[i])
                for i in range(self.l)]

    def _verification_keys(self, v: int, shares: List[int], delta: int,
                           n2: int) -> List[int]:
        """v_i = v^(delta * s_i) mod n^2 for every server in one ladder
        with per-row digits (thresholdkey_generator.go:246-254): kernel B4
        or B4w by the width of n^2."""
        exps = [delta * s for s in shares]
        if not self.device_verification_keys:
            return [pow(v, e, n2) for e in exps]
        ctx = mont.make_mont_ctx(n2, device=self.device)
        nd = mont.n_digits_for_bits(max(e.bit_length() for e in exps) or 1,
                                    VK_WINDOW)
        digits = torch.as_tensor(np.stack(
            [mont.exp_digits(e, VK_WINDOW, nd) for e in exps]),
            device=ctx.device)
        base = torch.as_tensor(host.int_to_limbs(v, ctx.n_limbs)
                               .astype(np.int64), device=ctx.device)
        out = mont.mont_pow_fixed_base(ctx, base, digits, VK_WINDOW)
        return host.limbs_to_ints(out.cpu().numpy())


def compute_share(coeffs: List[int], index: int, nm: int) -> int:
    """Share of authority ``index`` (0-based): f(index+1) mod nm over the
    hiding polynomial (reference: computeShare,
    thresholdkey_generator.go:213-223; authorities are indexed from 1)."""
    x = index + 1
    return sum(a * pow(x, j) for j, a in enumerate(coeffs)) % nm


def generate_threshold_keys(bits: int, l: int, t: int, rng=None,
                            timeout: float = KEYGEN_TIMEOUT, *,
                            device="cuda") -> List[ThresholdSecretKey]:
    """Convenience wrapper (reference: GenerateKeys,
    thresholdkey_generator.go:47-55)."""
    return ThresholdKeyGenerator(bits, l, t, rng, timeout,
                                 device=device).generate()
