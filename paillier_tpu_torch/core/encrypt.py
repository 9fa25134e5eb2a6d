"""Batched encryption (reference: paillier.go:185-289).

Regular encryption:      c = G^m * r^(n^s) mod n^(s+1)  (G = n+1, s = 1, 2)
Alternative encryption:  c = G^m * h_s^r  mod n^(s+1),  r < K
Nested encryption:       Enc_2(Enc_1(m).c)

G^m uses the binomial identity (1+n)^m = 1 + m*n (+ C(m,2)*n^2) mod
n^(s+1): constant-operand limb products (int8 Toeplitz matmuls,
:mod:`limbmm`) instead of a modexp.  The reference does the full modexp
(paillier.go:213); the outputs are bit-identical.  r^(n^s) is the
shared-exponent sliding-window ladder (kernel B1 on a CUDA tensor), and
G^m rides its exit multiply: at level 1 G^m = 1 + m*n is made in residue
space, at level 2 in limbs and converted once.

h_s^r is the comb over a batch-shared table of the fixed base h_s with
per-element short exponents r < K = 2^(secparam/2) (reference:
paillier.go:221-238): kernel B3 on a CUDA tensor, D multiplies and no
squarings; G^m rides its exit multiply as in regular encryption.

Both run on the engine of n^(s+1) (``DeviceKey.engine``, chosen by
width in ``bigint.engine.make_engine``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bigint import host
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint import vpu
from ..ops import random as prand
from ..ops.profiling import span, spanned
from .keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO,
                   REGULAR, Ciphertext, DeviceKey, PublicKey, encode_batch)

# Digit width of the comb (kernel B3's table has 2^COMB_WINDOW entries per
# digit; the JAX default window).
COMB_WINDOW = 4


def gm_binomial(dk: DeviceKey, m: torch.Tensor, level: int) -> torch.Tensor:
    """(1+n)^m mod n^(s+1) for plaintext limbs m < n^s.

    Level 1: 1 + m*n (exact, < n^2; m [..., L] -> [..., 2L]).
    Level 2: 1 + m*n + C(m,2)*n^2 mod n^3, with C(m,2) taken mod n
    (m [..., 2L] -> [..., 3L]).
    """
    L = dk.L
    n = dk.pk.n
    if level == LEVEL_ONE:
        t = lm.const_mul(m, dk.const_mul_plan(n, L, 2 * L))
        c, _ = vpu.add(t, vpu.one_like(t))
        return c
    t1 = lm.const_mul(m, dk.const_mul_plan(n, 2 * L, 3 * L))   # m*n < n^3
    br_n = dk.barrett_plan(n)
    mr = lm.fold_mod(m, dk.fold_plan(n, 2 * L), br_n)          # m mod n
    one = vpu.one_like(mr)
    mr_minus, borrow = vpu.sub(mr, one)                        # (m-1) mod n
    n_l = br_n.n_limbs_arr[:mr.shape[-1]].expand(mr.shape)
    mr_minus = torch.where((borrow != 0).unsqueeze(-1),
                           vpu.sub(n_l, one)[0], mr_minus)
    prod = vpu.mul(mr, mr_minus, 2 * L)                        # < n^2
    b2 = lm.modmul_const(prod, dk.inv2_n_plan(), br_n)         # C(m,2) mod n
    t2 = lm.const_mul(b2, dk.const_mul_plan(dk.pk.n2, L, 3 * L))
    s12, c12 = vpu.add(t1, t2)
    s12 = torch.cat([s12, c12.unsqueeze(-1)], dim=-1)          # width 3L+1
    c, _ = vpu.add(s12, vpu.one_like(s12))
    n3 = encode_batch([dk.pk.n3], 3 * L + 1, device=c.device)[0]
    return vpu.cond_sub(c, n3.expand(c.shape))[..., :3 * L]


def _gm(dk: DeviceKey, eng, m: torch.Tensor, level: int) -> torch.Tensor:
    """G^m in the engine's form: 1 + m*n by ``one_plus_mul`` at level 1
    (in residue space on the RNS engine), the binomial limbs at level 2."""
    if level == LEVEL_ONE:
        return eng.one_plus_mul(m, dk.pk.n)
    return eng.from_limbs(gm_binomial(dk, m, level))


def encrypt_with_r_kernel(dk: DeviceKey, eng, m: torch.Tensor,
                          r: torch.Tensor, level: int) -> torch.Tensor:
    """c = G^m * r^(n^s) mod n^(s+1) on ``eng`` (the engine of n^(s+1)):
    r^(n^s) on its shared-exponent ladder with G^m as the exit
    multiplicand.  m: limbs [..., sL]; r: limbs [..., (s+1)L].  The JAX
    functions multiply G^m in afterwards; the integer, and so every
    output limb, is the same (paillier.go:206-218)."""
    gm = _gm(dk, eng, m, level)
    return eng.to_limbs_mod(eng.pow_shared(eng.from_limbs(r),
                                           dk.pk.n ** level, fin=gm))


def alt_encrypt_with_r_kernel(dk: DeviceKey, eng, base, m: torch.Tensor,
                              r_digits: torch.Tensor, level: int
                              ) -> torch.Tensor:
    """c = G^m * h_s^r mod n^(s+1) on ``eng`` with per-element short
    exponents r < K (r_digits: int [..., D], MSB-first
    base-2^COMB_WINDOW): the fixed base ``base``
    (``DeviceKey.fixed_base(level, COMB_WINDOW)``: the comb, kernel B3,
    on the RNS engine) with G^m as the exit multiplicand."""
    gm = _gm(dk, eng, m, level)
    return eng.to_limbs_mod(eng.pow_fixed_base(base, r_digits, COMB_WINDOW,
                                               fin=gm))


class Encryptor:
    """Batched encryption for one public key on one torch device.

    ``method`` is REGULAR (r^(n^s), paillier.go:206-218) or ALTERNATIVE
    (h_s^r with short randomness r < K, paillier.go:221-238), at levels 1
    and 2.  ``window`` keeps the JAX signature's place and is ignored: the
    regular ladder is the sliding one, whose window is
    Config.sliding_window, the comb's digits are COMB_WINDOW bits (the
    JAX default), and the limb engine's ladders take LIMB_WINDOW.
    """

    def __init__(self, pk: PublicKey, level: int = DEFAULT_LEVEL,
                 method: str = REGULAR, window: int | None = None, rng=None,
                 *, device="cuda"):
        if method not in (REGULAR, ALTERNATIVE):
            raise ValueError(f"unknown encryption method {method!r}")
        if level not in (LEVEL_ONE, LEVEL_TWO):
            raise ValueError(f"level must be 1 or 2, got {level}")
        self.pk = pk
        self.dk = pk.device(device)
        self.dk.check_level(level)
        self.level = level
        self.method = method
        self.rng = rng or prand.make_rng()
        self.m_limbs = level * self.dk.L
        self.c_limbs = (level + 1) * self.dk.L
        self._r_bits = pk.k.bit_length() - 1      # r < K = 2^(secparam/2)
        eng = self.dk.engine(level)
        if method == ALTERNATIVE:
            base = self.dk.fixed_base(level, COMB_WINDOW)
            self._fn = lambda m, rd: alt_encrypt_with_r_kernel(
                self.dk, eng, base, m, rd, level)
        else:
            self._fn = lambda m, r: encrypt_with_r_kernel(
                self.dk, eng, m, r, level)

    # -- randomness -------------------------------------------------------
    def sample_r(self, count: int) -> list[int]:
        """``count`` units of Z_n^* from ``self.rng``: the values of
        ``random_unit`` a row, drawn in batches with the generator left in
        the same state (``ops.random.random_units_rows``; a generator that
        overrides its draw methods takes the per-row loop)."""
        return prand.random_units(self.pk.n, count, self.rng)

    # -- encryption -------------------------------------------------------
    @spanned("encrypt")
    def encrypt(self, ms: Sequence[int] | torch.Tensor,
                rs: Optional[Sequence[int]] = None) -> Ciphertext:
        """Encrypt a batch of plaintexts (ints < n^s, or a limb tensor)."""
        dev = self.dk.device
        if isinstance(ms, (list, tuple)):
            m = encode_batch(ms, self.m_limbs, device=dev)
        else:
            m = ms.to(dev)
        count = m[..., 0].numel()
        if self.method == REGULAR:
            if rs is None:        # sample_r's draws, as limbs
                rows = prand.random_units_rows(self.pk.n, count, self.rng,
                                               self.c_limbs)
                with span("encode", rows=count):
                    r = torch.as_tensor(rows, device=dev)
            else:
                r = encode_batch(rs, self.c_limbs, device=dev)
            r = r.reshape(m.shape[:-1] + (self.c_limbs,))
            return Ciphertext(c=self._fn(m, r), level=self.level,
                              method=REGULAR)
        if rs is None:
            rs = self.sample_r(count)
        # digits of r mod K, made on the device from the limbs of r mod K
        k = self.pk.k
        nd = mont.n_digits_for_bits(self._r_bits, COMB_WINDOW)
        rl = encode_batch([ri % k for ri in rs],
                          host.limbs_for_bits(self._r_bits), device=dev)
        rd = mont.limbs_to_digits(rl, COMB_WINDOW, nd)
        return Ciphertext(c=self._fn(m, rd.reshape(m.shape[:-1] + (nd,))),
                          level=self.level, method=ALTERNATIVE)

    def encrypt_zeros(self, count: int) -> Ciphertext:
        return self.encrypt([0] * count)

    def encrypt_ones(self, count: int) -> Ciphertext:
        return self.encrypt([1] * count)


def nested_encrypt(pk: PublicKey, ms: Sequence[int], rng=None, *,
                   device="cuda") -> Ciphertext:
    """Enc_2(Enc_1(m).c) (reference: paillier.go:200-203).

    The inner level-1 ciphertext limbs ([..., 2L], values < n^2) are
    exactly the level-2 plaintext width, so they feed the level-2
    encryption directly, without a host round trip."""
    e1 = Encryptor(pk, LEVEL_ONE, rng=rng, device=device)
    e2 = Encryptor(pk, LEVEL_TWO, rng=rng, device=device)
    inner = e1.encrypt(list(ms))
    return e2.encrypt(inner.c)
