"""Batched CRT decryption at level 1 (reference: paillier.go:292-372).

m = CRT(m_p, m_q) with m_p = L_p(c^(p-1) mod p^2) * h_p mod p: two
half-width sliding-window ladders (kernel B1 on a CUDA tensor), with
every limb-domain multiply by a constant as one int8 Toeplitz product
(:mod:`limbmm`).  Not in the reference, bit-identical to its output.

Not ported yet: plain (recovery-algorithm) decryption, level 2 and the
nested-layer functions, which need ``bigint/montgomery.py`` and kernel
B2 (ROADMAP A.7).
"""

from __future__ import annotations

import torch

from ..bigint import host, vpu
from ..bigint import limbmm as lm
from .keys import (DEFAULT_LEVEL, LEVEL_ONE, Ciphertext, DeviceKey,
                   SecretKey, decode_batch)


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


def crt_decrypt_kernel_mm(dk: DeviceKey, c: torch.Tensor, pl: _CrtMmPlans,
                          eng_p, eng_q, ep_exp: int, eq_exp: int,
                          window: int = 4) -> torch.Tensor:
    """CRT decryption: every limb multiply is a Toeplitz product and both
    half-width modexps run on the sliding-window ladder (shared
    exponents p-1 / q-1).  c: limbs [..., 2L]; returns m limbs [..., L]."""
    L = dk.L
    Lh, Lp = pl.Lh, pl.Lp

    def half(fold, br2, eng, e_exp, div, hplan, br1):
        cm = lm.fold_mod(c, fold, br2)                       # c mod p^2
        u = eng.pow_shared(eng.from_limbs(cm), e_exp)        # c^(p-1)
        ul = eng.to_limbs_mod(u)[..., :Lh]
        one = torch.zeros_like(ul)
        one[..., 0] = 1
        um1, _ = vpu.sub(ul, one)
        lval = lm.const_mul(um1, div)[..., :Lp]              # L_p(u) < p
        return lm.modmul_const(lval, hplan, br1)             # * h_p mod p

    mp = half(pl.fold_p2, pl.br_p2, eng_p, ep_exp, pl.div_p, pl.hp,
              pl.br_p)
    mq = half(pl.fold_q2, pl.br_q2, eng_q, eq_exp, pl.div_q, pl.hq,
              pl.br_q)

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


class Decryptor:
    """Batched CRT decryption for one secret key on one torch device.

    Only ``crt=True`` at ``LEVEL_ONE`` is ported; plain decryption and
    level 2 raise ``NotImplementedError`` (ROADMAP A.7).
    """

    def __init__(self, sk: SecretKey, level: int = DEFAULT_LEVEL,
                 crt: bool = False, window: int | None = None, *, device):
        from ..bigint.engine import make_engine
        from ..config import get_config
        if level != LEVEL_ONE:
            raise NotImplementedError(
                f"level-{level} decryption is not ported yet (ROADMAP A.7)")
        if not crt:
            raise NotImplementedError(
                "plain (recovery-algorithm) decryption is not ported yet "
                "(ROADMAP A.7); use crt=True")
        self.sk = sk
        self.dk = sk.device(device)
        self.level = level
        self.window = window if window is not None else get_config().window
        self.crt = True
        cc = _CrtConsts(sk)
        p, q = sk.p, sk.q
        dev = self.dk.device
        plans = _CrtMmPlans(sk, cc, 2 * self.dk.L, device=dev)
        eng_p = make_engine(cc.p2, plans.Lh, device=dev)
        eng_q = make_engine(cc.q2, plans.Lh, device=dev)
        self._fn = lambda c: crt_decrypt_kernel_mm(
            self.dk, c, plans, eng_p, eng_q, p - 1, q - 1, self.window)

    def decrypt(self, ct: Ciphertext) -> list[int]:
        return decode_batch(self.decrypt_array(ct))

    def decrypt_array(self, ct: Ciphertext) -> torch.Tensor:
        if ct.level != self.level:
            raise ValueError(
                f"decryptor built for level {self.level}, got {ct.level}")
        return self._fn(ct.c.to(self.dk.device))
