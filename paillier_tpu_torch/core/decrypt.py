"""Batched decryption (reference: paillier.go:292-372).

Generic path (levels 1 and 2): m = recovery(c^lambda mod n^(s+1), s) *
lambda^-1 mod n^s with the Damgard-Jurik recovery algorithm
(paillier.go:308-340).  c^lambda is the shared-exponent sliding-window
ladder (kernel B1 on a CUDA tensor); the exact divisions L(u) = (u-1)/n
are Hensel products and every other multiply by a constant is one int8
Toeplitz product (:mod:`limbmm`).

CRT path (level 1; not in the reference, bit-identical to its output):
m = CRT(m_p, m_q) with m_p = L_p(c^(p-1) mod p^2) * h_p mod p, two
half-width ladders and Garner's step (``bigint.engine.CrtSplit``).  At
level 2 ``crt=True`` is dropped, as in the JAX package, and the generic
path runs.

Every ladder runs on the engine of its modulus (``make_engine``: n^(s+1)
for the generic path, p^2 and q^2 for CRT).
"""

from __future__ import annotations

import torch

from ..bigint import host, vpu
from ..bigint import limbmm as lm
from ..bigint.engine import CrtSplit
from ..ops.profiling import spanned
from .keys import (DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO, MIXED, Ciphertext,
                   DeviceKey, SecretKey, decode_batch)


# ---------------------------------------------------------------------------
# Generic recovery-algorithm decryption
# ---------------------------------------------------------------------------

def _sub_one(x: torch.Tensor) -> torch.Tensor:
    return vpu.sub(x, vpu.one_like(x))[0]


def decrypt_kernel(dk: DeviceKey, eng, c: torch.Tensor, level: int,
                   lam: int, mu: lm.ModMulConstPlan) -> torch.Tensor:
    """Generic decryption: c^lambda on ``eng`` (the engine of n^(s+1))'s
    shared-exponent ladder, then the recovery.  c: limbs [..., (s+1)L];
    returns m limbs [..., sL].  ``mu`` is the plan of x * lambda^-1 mod
    n^s (secret, so the Decryptor holds it; the JAX function takes it as
    limbs)."""
    tmp = eng.to_limbs_mod(eng.pow_shared(eng.from_limbs(c), lam))
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

class _CrtHalf:
    """The steps of one CRT half after its ladder, for a prime f: the
    Hensel division L_f(u) = (u - 1)/f and the product by
    h_f = L_f(g^(f-1) mod f^2)^-1 mod f (g = n+1), each one int8 Toeplitz
    product (+ small Barrett)."""

    def __init__(self, f: int, g: int, *, device):
        f2 = f * f
        lh = host.limbs_for_bits(f2.bit_length())
        self.e = f - 1
        self.br = lm.BarrettPlan.build(f, device=device)
        self.div = lm.ConstMulPlan.build(host.hensel_inverse(f, lh), lh, lh,
                                         device=device)
        h = pow((pow(g, f - 1, f2) - 1) // f, -1, f)
        self.h = lm.ModMulConstPlan.build(h, f, self.br.ln, device=device)

    def __call__(self, eng, x: torch.Tensor) -> torch.Tensor:
        """m_f from c mod f^2 in ``eng``'s form."""
        um1 = _sub_one(eng.to_limbs_mod(eng.pow_shared(x, self.e)))
        lval = lm.const_mul(um1, self.div)[..., :self.br.ln]  # L_f(u) < f
        return lm.modmul_const(lval, self.h, self.br)


def crt_decrypt_kernel(c: torch.Tensor, split: CrtSplit, halves
                       ) -> torch.Tensor:
    """CRT decryption: c folded mod p^2 and q^2, a half-width ladder
    (shared exponent p-1 / q-1) and :class:`_CrtHalf`'s steps a half,
    then Garner's step mod p and q.  c: limbs [..., 2L]; returns m limbs
    [..., L]."""
    return split.combine(*split.map(c, lambda i, eng, x: halves[i](eng, x)))


class Decryptor:
    """Batched decryption for one secret key on one torch device: the
    generic recovery path at levels 1 and 2, or CRT (``crt=True``) at
    level 1; ``crt`` is ignored at level 2, as in the JAX package."""

    def __init__(self, sk: SecretKey, level: int = DEFAULT_LEVEL,
                 crt: bool = False, *, device="cuda"):
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
            split = CrtSplit(sk.p, sk.q, 2, self.dk.L, device=dev, join=1)
            halves = [_CrtHalf(f, sk.g, device=dev) for f in (sk.p, sk.q)]
            self._fn = lambda c: crt_decrypt_kernel(c, split, halves)
        else:
            ns = sk.n ** level
            mu = lm.ModMulConstPlan.build(pow(sk.lam, -1, ns), ns,
                                          level * self.dk.L, device=dev)
            eng = self.dk.engine(level)
            self._fn = lambda c: decrypt_kernel(self.dk, eng, c, level,
                                                sk.lam, mu)

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
