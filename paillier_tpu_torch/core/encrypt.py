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

Where the RNS engine cannot take n^(s+1) (``DeviceKey.limb_route``: level
2 of a 4096-bit key) the :class:`Encryptor` takes the JAX package's limb
Montgomery kernels instead, :func:`encrypt_with_r_kernel` and
:func:`alt_encrypt_with_r_kernel`: r^(n^s) and h_s^r on the fixed-window
limb ladder (kernel B4 on a CUDA tensor), then one limb ``modmul`` by G^m.
The JAX package picks its engine by backend; the port by width alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bigint import host
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint import vpu
from ..ops import random as prand
from ..ops.profiling import spanned
from .keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO,
                   LIMB_WINDOW, REGULAR, Ciphertext, DeviceKey, PublicKey,
                   encode_batch)

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


def encrypt_with_r_kernel(dk: DeviceKey, m: torch.Tensor, r: torch.Tensor,
                          level: int, ns_digits, window: int = 4
                          ) -> torch.Tensor:
    """c = G^m * r^(n^s) mod n^(s+1) on the limb route: r^(n^s) on the
    fixed-window limb Montgomery ladder (kernel B4 on a CUDA tensor), then
    one ``modmul`` by G^m.  m: limbs [..., sL]; r: limbs [..., (s+1)L]
    (< n^(s+1)); ns_digits: MSB-first base-2^window digits of n^s."""
    ctx = dk.ctx_for_level(level)
    gm = gm_binomial(dk, m, level)
    rn = mont.mont_pow_digits(ctx, r, ns_digits, window)
    return mont.modmul(ctx, gm, rn)


def alt_encrypt_with_r_kernel(dk: DeviceKey, m: torch.Tensor,
                              r_digits: torch.Tensor, level: int,
                              window: int = 4) -> torch.Tensor:
    """c = G^m * h_s^r mod n^(s+1) on the limb route, with per-element
    short exponents r < K (r_digits: int [..., D], MSB-first
    base-2^window): h_s broadcast over the batch on the limb ladder
    (kernel B4 on a CUDA tensor), then one ``modmul`` by G^m."""
    ctx = dk.ctx_for_level(level)
    gm = gm_binomial(dk, m, level)
    hr = mont.mont_pow_fixed_base(ctx, dk.hs_for_level(level), r_digits,
                                  window)
    return mont.modmul(ctx, gm, hr)


def encrypt_with_r_rns_kernel(dk: DeviceKey, eng, m: torch.Tensor,
                              r: torch.Tensor, level: int, ns_exp: int
                              ) -> torch.Tensor:
    """c = G^m * r^(n^s) mod n^(s+1): G^m by the binomial shortcut in
    limbs, r^(n^s) on the sliding-window ladder with G^m as its exit
    multiplicand.  m: limbs [..., sL]; r: limbs [..., (s+1)L].  The JAX
    function multiplies G^m in afterwards (``eng.mul``); the integer, and
    so every output limb, is the same."""
    gm = gm_binomial(dk, m, level)
    c_rns = eng.pow_shared(eng.from_limbs(r), ns_exp, fin=eng.from_limbs(gm))
    return dk._widen(eng.to_limbs_mod(c_rns), level)


def encrypt_with_r_rns_fused_kernel(dk: DeviceKey, eng, nrow: torch.Tensor,
                                    m: torch.Tensor, r: torch.Tensor,
                                    ns_exp: int) -> torch.Tensor:
    """Level-1 regular encryption with G^m fused into the ladder.

    m: limbs [..., L] (< n); r: limbs [..., 2L]; nrow: int32 [C] true-form
    residues of n.  Returns ciphertext limbs [..., 2L], bit-identical to
    the reference formula (paillier.go:206-218)."""
    from ..bigint.rns2 import rns2_one_plus_mul
    m_wide = torch.nn.functional.pad(m, (0, dk.L))            # width 2L
    gm = rns2_one_plus_mul(eng.ctx, eng.from_limbs(m_wide), nrow)
    c_rns = eng.pow_shared(eng.from_limbs(r), ns_exp, fin=gm)
    return dk._widen(eng.to_limbs_mod(c_rns), LEVEL_ONE)


def alt_encrypt_comb_kernel(dk: DeviceKey, eng, table: torch.Tensor,
                            m: torch.Tensor, r_digits: torch.Tensor,
                            level: int, nrow: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """c = G^m * h_s^r mod n^(s+1) by the comb (no squarings).

    m: limbs [..., sL]; r_digits: int32 [..., D], MSB-first
    base-2^COMB_WINDOW digits of r < K; table:
    ``DeviceKey.comb_table(level, COMB_WINDOW)``.  G^m
    is made in residue space at level 1 (``nrow``: true-form residues of
    n) and from the binomial limbs at level 2, and rides the comb's exit
    multiply; the JAX function multiplies it in afterwards
    (``eng.mul``).  The integer, and so every output limb, is the same."""
    from ..bigint.rns2 import rns2_one_plus_mul, rns2_pow_fixed_base
    if level == LEVEL_ONE:
        m_wide = torch.nn.functional.pad(m, (0, dk.L))        # width 2L
        gm = rns2_one_plus_mul(eng.ctx, eng.from_limbs(m_wide), nrow)
    else:
        gm = eng.from_limbs(gm_binomial(dk, m, level))
    lead = r_digits.shape[:-1]
    C = gm.shape[-1]
    hr = rns2_pow_fixed_base(eng.ctx, table,
                             r_digits.reshape(-1, r_digits.shape[-1]),
                             COMB_WINDOW, fin=gm.reshape(-1, C))
    return dk._widen(eng.to_limbs_mod(hr.reshape(lead + (C,))), level)


class Encryptor:
    """Batched encryption for one public key on one torch device.

    ``method`` is REGULAR (r^(n^s), paillier.go:206-218) or ALTERNATIVE
    (h_s^r with short randomness r < K, paillier.go:221-238), at levels 1
    and 2.  ``window`` keeps the JAX signature's place and is ignored: the
    regular ladder is the sliding one, whose window is
    Config.sliding_window, the comb's digits are COMB_WINDOW bits (the
    JAX default), and the limb route's ladders take LIMB_WINDOW.  The
    engine (RNS, or the limb route past the RNS engine's width) is chosen
    here, once.
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
        if self.dk.limb_route(level):
            if method == ALTERNATIVE:
                self.dk.hs_for_level(level)
                self._fn = lambda m, rd: alt_encrypt_with_r_kernel(
                    self.dk, m, rd, level, LIMB_WINDOW)
            else:
                ns = pk.n ** level
                nd = mont.n_digits_for_bits(ns.bit_length(), LIMB_WINDOW)
                ns_digits = torch.as_tensor(
                    mont.exp_digits(ns, LIMB_WINDOW, nd),
                    device=self.dk.device)
                self._fn = lambda m, r: encrypt_with_r_kernel(
                    self.dk, m, r, level, ns_digits, LIMB_WINDOW)
            return
        eng = self.dk.rns(level)
        nrow = None
        if level == LEVEL_ONE:
            spec = eng.spec
            nrow = torch.tensor([pk.n % mi for mi in spec.b1 + spec.b2],
                                dtype=torch.int32, device=self.dk.device)
        if method == ALTERNATIVE:
            table = self.dk.comb_table(level, COMB_WINDOW)
            self._fn = lambda m, rd: alt_encrypt_comb_kernel(
                self.dk, eng, table, m, rd, level, nrow)
        elif level == LEVEL_ONE:
            self._fn = lambda m, r: encrypt_with_r_rns_fused_kernel(
                self.dk, eng, nrow, m, r, pk.n)
        else:
            self._fn = lambda m, r: encrypt_with_r_rns_kernel(
                self.dk, eng, m, r, level, pk.n2)

    # -- randomness -------------------------------------------------------
    def sample_r(self, count: int) -> list[int]:
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
        if rs is None:
            rs = self.sample_r(count)
        if self.method == REGULAR:
            r = encode_batch(rs, self.c_limbs, device=dev).reshape(
                m.shape[:-1] + (self.c_limbs,))
            return Ciphertext(c=self._fn(m, r), level=self.level,
                              method=REGULAR)
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
