"""Batched decryption (reference: paillier.go:292-372).

Generic path (levels 1 and 2): m = recovery(c^lambda mod n^(s+1), s) *
lambda^-1 mod n^s with the Damgard-Jurik recovery algorithm
(paillier.go:308-340).  c^lambda is the shared-exponent sliding-window
ladder (kernel B1 on a CUDA tensor); the exact divisions L(u) = (u-1)/n
are Hensel products and every other multiply by a constant is one int8
Toeplitz product (:mod:`limbmm`).

CRT path (level 1; not in the reference, bit-identical to its output):
m = CRT(m_p, m_q) with m_p = L_p(c^(p-1) mod p^2) * h_p mod p, two
half-width ladders on the RNS engine (:func:`crt_decrypt_kernel_mm`), or,
where p^2 or q^2 is past its width (keys over 8,660 bits), on the limb
Montgomery ladder (:func:`crt_decrypt_kernel`, kernel B4 or B4w on a CUDA
tensor).  At level 2 ``crt=True`` is dropped, as in the JAX package, and
the generic path runs.

Where the RNS engine cannot take n^(s+1) (``DeviceKey.limb_route``: level
2 of a 4096-bit key, both levels of an 8192-bit key) the generic path is
:func:`decrypt_kernel`, the JAX package's limb Montgomery kernel:
c^lambda on the fixed-window limb ladder (kernel B4 on a CUDA tensor up
to 768 limbs, B4w past them), then the same recovery.
"""

from __future__ import annotations

import torch

from ..bigint import host, vpu
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint import rns2
from ..ops.profiling import spanned
from .keys import (DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO, LIMB_WINDOW, MIXED,
                   Ciphertext, DeviceKey, SecretKey, decode_batch)


# ---------------------------------------------------------------------------
# Generic recovery-algorithm decryption
# ---------------------------------------------------------------------------

def _sub_one(x: torch.Tensor) -> torch.Tensor:
    return vpu.sub(x, vpu.one_like(x))[0]


def decrypt_kernel(dk: DeviceKey, c: torch.Tensor, level: int, lam_digits,
                   mu: lm.ModMulConstPlan, window: int = 4) -> torch.Tensor:
    """Generic decryption on the limb route: c^lambda on the fixed-window
    limb Montgomery ladder (kernel B4 on a CUDA tensor; lam_digits: the
    MSB-first base-2^window digits of lambda), then the recovery.  c:
    limbs [..., (s+1)L]; returns m limbs [..., sL].  The JAX function
    takes lambda^-1 mod n^s as limbs and n*(2!)^-1 mod n^2 as an argument;
    here ``mu`` is the plan of x * lambda^-1 mod n^s (as in
    :func:`decrypt_kernel_rns`) and the second constant is the key's
    (``DeviceKey.inv2fac_n2_plan``)."""
    tmp = mont.mont_pow_digits(dk.ctx_for_level(level), c.to(torch.int64),
                               lam_digits, window)
    return _recover(dk, tmp, level, mu)


def decrypt_kernel_rns(dk: DeviceKey, eng, c: torch.Tensor, level: int,
                       lam_exp: int, mu: lm.ModMulConstPlan
                       ) -> torch.Tensor:
    """Generic decryption with c^lambda on the RNS engine's sliding-window
    ladder; c: limbs [..., (s+1)L]; returns m limbs [..., sL].  ``mu`` is
    the plan of x * lambda^-1 mod n^s (secret, so the Decryptor holds
    it)."""
    t_rns = eng.pow_shared(eng.from_limbs(c), lam_exp)
    tmp = dk._widen(eng.to_limbs_mod(t_rns), level)
    return _recover(dk, tmp, level, mu)


def _recover(dk: DeviceKey, tmp: torch.Tensor, level: int,
             mu: lm.ModMulConstPlan) -> torch.Tensor:
    """Damgard-Jurik recovery from tmp = c^lambda mod n^(s+1) (limbs)."""
    L = dk.L
    n, n2 = dk.pk.n, dk.pk.n2
    um1 = _sub_one(tmp)

    if level == LEVEL_ONE:
        ml = lm.const_mul(um1[..., :L], dk.div_n_plan(L))     # (u-1)/n < n
        return _pad_to(lm.modmul_const(ml, mu, dk.barrett_plan(n)), L)

    # level 2 recovery (paillier.go:308-340), specialised to s = 2:
    #   i1 = L(a mod n^2, n)
    #   t1 = L(a mod n^3, n);  t2 = i1*(i1-1)*n*(2!)^-1 mod n^2
    #   ml = (t1 - t2) mod n^2
    # a mod n^2 is a unit (a = c^lambda with c invertible), so
    # subtracting 1 cannot underflow.
    br_n2 = dk.barrett_plan(n2)
    a_mod_n2 = _pad_to(lm.fold_mod(tmp, dk.fold_plan(n2, 3 * L), br_n2),
                       2 * L)
    div = dk.div_n_plan(2 * L)
    i1 = lm.const_mul(_sub_one(a_mod_n2), div)[..., :L]       # < n
    t1 = lm.const_mul(um1[..., :2 * L], div)                  # < n^2
    # t2 = i1 * (i1 - 1): both < n, so the product < n^2; i1 == 0 gives 0
    prod = vpu.mul(i1, _sub_one(i1), 2 * L)
    prod = torch.where(vpu.is_zero(i1).unsqueeze(-1),
                       torch.zeros_like(prod), prod)
    t2 = _pad_to(lm.modmul_const(prod, dk.inv2fac_n2_plan(), br_n2), 2 * L)
    # ml = (t1 - t2) mod n^2
    diff, borrow = vpu.sub(t1, t2)
    n2b = _pad_to(br_n2.n_limbs_arr[:br_n2.ln], 2 * L).expand(diff.shape)
    fixed, _ = vpu.add(diff, n2b)
    ml = torch.where((borrow != 0).unsqueeze(-1), fixed, diff)
    return _pad_to(lm.modmul_const(ml, mu, br_n2), 2 * L)


def _pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-extend the limb axis to ``width`` (results of a Barrett
    reduction have the modulus' limb count)."""
    pad = width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad > 0 else x


# ---------------------------------------------------------------------------
# CRT decryption (level 1)
# ---------------------------------------------------------------------------

class _CrtConsts:
    def __init__(self, sk: SecretKey):
        p, q = sk.p, sk.q
        self.p2, self.q2 = p * p, q * q
        # h_p = L_p(g^{p-1} mod p^2)^{-1} mod p  (g = n+1)
        hp = pow(sk.g, p - 1, self.p2)
        hq = pow(sk.g, q - 1, self.q2)
        self.hp_int = pow((hp - 1) // p, -1, p)
        self.hq_int = pow((hq - 1) // q, -1, q)
        self.pinv_q = pow(p, -1, q)


class _CrtMmPlans:
    """limbmm plans for CRT decryption (one set per secret key/device).

    Every limb-domain multiply in CRT decryption has a constant operand,
    so each becomes one int8 Toeplitz product (+ small Barrett where a
    modular result is needed).
    """

    def __init__(self, sk: SecretKey, cc: _CrtConsts, c_limbs: int, *,
                 device):
        p, q = sk.p, sk.q
        Lh = host.limbs_for_bits(max(cc.p2.bit_length(), cc.q2.bit_length()))
        Lp = host.limbs_for_bits(max(p.bit_length(), q.bit_length()))
        self.Lh, self.Lp = Lh, Lp
        dev = dict(device=device)
        # c mod p^2 / q^2: fold the 2L-wide ciphertext
        self.fold_p2 = lm.FoldPlan.build(cc.p2, c_limbs, **dev)
        self.fold_q2 = lm.FoldPlan.build(cc.q2, c_limbs, **dev)
        self.br_p2 = lm.BarrettPlan.build(cc.p2, **dev)
        self.br_q2 = lm.BarrettPlan.build(cc.q2, **dev)
        # exact division by p / q (Hensel inverse, low-truncated product)
        self.div_p = lm.ConstMulPlan.build(
            host.hensel_inverse(p, Lh), Lh, Lh, **dev)
        self.div_q = lm.ConstMulPlan.build(
            host.hensel_inverse(q, Lh), Lh, Lh, **dev)
        # * h_p mod p, * h_q mod q (inputs are the Lp-limb L-function values)
        self.hp = lm.ModMulConstPlan.build(cc.hp_int, p, Lp, **dev)
        self.hq = lm.ModMulConstPlan.build(cc.hq_int, q, Lp, **dev)
        self.br_p = lm.BarrettPlan.build(p, **dev)
        self.br_q = lm.BarrettPlan.build(q, **dev)
        # CRT combine: * p^-1 mod q, then * p (exact widen)
        self.pinv_q = lm.ModMulConstPlan.build(cc.pinv_q, q, Lp, **dev)
        self.mul_p = lm.ConstMulPlan.build(p, Lp, c_limbs // 2, **dev)
        self.q_limbs = torch.as_tensor(
            host.int_to_limbs(q, Lp).astype("int64"), device=device)


def _crt_combine(dk: DeviceKey, c: torch.Tensor, pl: _CrtMmPlans,
                 ladder_p, ladder_q) -> torch.Tensor:
    """CRT decryption around two half-width ladders: ``ladder_p`` maps
    c mod p^2 (limbs [..., Lh]) to c^(p-1) mod p^2, ``ladder_q`` the same
    mod q^2.  Every other limb multiply is a Toeplitz product: the fold
    of c, the Hensel division L_p(u) = (u-1)/p, the products by h_p / h_q
    and the Garner step m = mp + p ((mq - mp) p^-1 mod q).  c: limbs
    [..., 2L]; returns m limbs [..., L]."""
    L = dk.L
    Lh, Lp = pl.Lh, pl.Lp

    def half(fold, br2, ladder, div, hplan, br1):
        cm = lm.fold_mod(c, fold, br2)                       # c mod p^2
        um1 = _sub_one(ladder(cm)[..., :Lh])                 # c^(p-1) - 1
        lval = lm.const_mul(um1, div)[..., :Lp]              # L_p(u) < p
        return lm.modmul_const(lval, hplan, br1)             # * h_p mod p

    mp = half(pl.fold_p2, pl.br_p2, ladder_p, pl.div_p, pl.hp, pl.br_p)
    mq = half(pl.fold_q2, pl.br_q2, ladder_q, pl.div_q, pl.hq, pl.br_q)

    # m = mp + p * ((mq - mp) * p^-1 mod q)
    qb = pl.q_limbs.expand(mp.shape)
    mp_q = vpu.cond_sub(mp, qb)
    diff, borrow = vpu.sub(mq, mp_q)
    fixed, _ = vpu.add(diff, qb)
    diff = torch.where((borrow != 0).unsqueeze(-1), fixed, diff)
    t = lm.modmul_const(diff, pl.pinv_q, pl.br_q)
    pt = lm.const_mul(t, pl.mul_p)                            # t * p, exact
    m, _ = vpu.add(pt, torch.nn.functional.pad(mp, (0, L - mp.shape[-1])))
    return m


def crt_decrypt_kernel_mm(dk: DeviceKey, c: torch.Tensor, pl: _CrtMmPlans,
                          eng_p, eng_q, ep_exp: int, eq_exp: int
                          ) -> torch.Tensor:
    """CRT decryption: every limb multiply is a Toeplitz product and both
    half-width modexps run on the sliding-window ladder (shared
    exponents p-1 / q-1).  c: limbs [..., 2L]; returns m limbs [..., L]."""
    def rns_ladder(eng, e_exp):
        return lambda cm: eng.to_limbs_mod(
            eng.pow_shared(eng.from_limbs(cm), e_exp))

    return _crt_combine(dk, c, pl, rns_ladder(eng_p, ep_exp),
                        rns_ladder(eng_q, eq_exp))


def crt_decrypt_kernel(dk: DeviceKey, c: torch.Tensor, pl: _CrtMmPlans,
                       ctx_p2, ctx_q2, ep_digits, eq_digits,
                       window: int = LIMB_WINDOW) -> torch.Tensor:
    """CRT decryption on the limb route: c^(p-1) mod p^2 and c^(q-1) mod
    q^2 on the fixed-window limb Montgomery ladder
    (``montgomery.mont_pow_digits``: kernel B4 or B4w on a CUDA tensor;
    ep_digits / eq_digits: the MSB-first base-2^window digits of p-1 /
    q-1; ctx_p2 / ctx_q2: the contexts of p^2 / q^2 at ``pl.Lh`` limbs),
    then :func:`crt_decrypt_kernel_mm`'s Toeplitz steps.  The JAX
    function takes the Hensel inverses, h_p / h_q, p^-1 mod q and p as
    limbs; here they are the plans ``pl``.  c: limbs [..., 2L]; returns
    m limbs [..., L]."""
    def limb_ladder(ctx, digits):
        return lambda cm: mont.mont_pow_digits(
            ctx, _pad_to(cm, ctx.n_limbs), digits, window)

    return _crt_combine(dk, c, pl, limb_ladder(ctx_p2, ep_digits),
                        limb_ladder(ctx_q2, eq_digits))


class Decryptor:
    """Batched decryption for one secret key on one torch device: the
    generic recovery path at levels 1 and 2, or CRT (``crt=True``) at
    level 1; ``crt`` is ignored at level 2, as in the JAX package.  Each
    ladder runs on the RNS engine, or on the limb route past its width:
    the generic path's by n^(s+1) (:func:`decrypt_kernel`), CRT's by p^2
    and q^2 (:func:`crt_decrypt_kernel`)."""

    def __init__(self, sk: SecretKey, level: int = DEFAULT_LEVEL,
                 crt: bool = False, *, device="cuda"):
        from ..bigint.engine import make_engine
        if level not in (LEVEL_ONE, LEVEL_TWO):
            raise ValueError(f"level must be 1 or 2, got {level}")
        self.sk = sk
        self.dk = sk.device(device)
        self.dk.check_level(level)
        self.level = level
        self.crt = crt and level == LEVEL_ONE
        self.s = level
        dev = self.dk.device
        if self.crt:
            cc = _CrtConsts(sk)
            p, q = sk.p, sk.q
            plans = _CrtMmPlans(sk, cc, 2 * self.dk.L, device=dev)
            if max(cc.p2, cc.q2).bit_length() > rns2.MAX_MODULUS_BITS:
                ctx_p2, ctx_q2 = (mont.make_mont_ctx(m2, plans.Lh, device=dev)
                                  for m2 in (cc.p2, cc.q2))
                nd = mont.n_digits_for_bits(max(p, q).bit_length(),
                                            LIMB_WINDOW)
                ep, eq = (torch.as_tensor(mont.exp_digits(
                    e, LIMB_WINDOW, nd), device=dev) for e in (p - 1, q - 1))
                self._fn = lambda c: crt_decrypt_kernel(
                    self.dk, c, plans, ctx_p2, ctx_q2, ep, eq)
            else:
                eng_p = make_engine(cc.p2, plans.Lh, device=dev)
                eng_q = make_engine(cc.q2, plans.Lh, device=dev)
                self._fn = lambda c: crt_decrypt_kernel_mm(
                    self.dk, c, plans, eng_p, eng_q, p - 1, q - 1)
        else:
            ns = sk.n ** level
            mu = lm.ModMulConstPlan.build(pow(sk.lam, -1, ns), ns,
                                          level * self.dk.L, device=dev)
            lam = sk.lam
            if self.dk.limb_route(level):
                nd = mont.n_digits_for_bits(lam.bit_length(), LIMB_WINDOW)
                lam_digits = torch.as_tensor(
                    mont.exp_digits(lam, LIMB_WINDOW, nd), device=dev)
                self._fn = lambda c: decrypt_kernel(
                    self.dk, c, level, lam_digits, mu, LIMB_WINDOW)
            else:
                eng = self.dk.rns(level)
                self._fn = lambda c: decrypt_kernel_rns(
                    self.dk, eng, c, level, lam, mu)

    @spanned("decrypt")
    def decrypt(self, ct: Ciphertext) -> list[int]:
        return decode_batch(self._decrypt(ct))

    @spanned("decrypt")
    def decrypt_array(self, ct: Ciphertext) -> torch.Tensor:
        return self._decrypt(ct)

    def _decrypt(self, ct: Ciphertext) -> torch.Tensor:
        if ct.level != self.level:
            raise ValueError(
                f"decryptor built for level {self.level}, got {ct.level}")
        return self._fn(ct.c.to(self.dk.device))


def nested_decrypt(sk: SecretKey, ct: Ciphertext, *, device="cuda"
                   ) -> list[int]:
    """Peel two layers (reference: paillier.go:344-355), honouring the
    inner-zero edge case."""
    inner = decrypt_nested_layer(sk, ct, device=device)
    inner_vals = decode_batch(inner.c)
    d1 = Decryptor(sk, LEVEL_ONE, device=device)
    outer = d1.decrypt(Ciphertext(c=inner.c, level=LEVEL_ONE))
    return [0 if iv == 0 else ov for iv, ov in zip(inner_vals, outer)]


def decrypt_nested_layer(sk: SecretKey, ct: Ciphertext, *, device="cuda"
                         ) -> Ciphertext:
    """[[c]] -> [c] (reference: paillier.go:359-372)."""
    if ct.level == LEVEL_ONE:
        raise ValueError("no nested ciphertexts to recover")
    d2 = Decryptor(sk, LEVEL_TWO, device=device)
    vals = d2.decrypt_array(ct)
    return Ciphertext(c=vals, level=LEVEL_ONE, method=MIXED)
