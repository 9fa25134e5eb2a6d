"""Threshold (share) decryption and combining (reference:
thresholdkey.go:63-221).

Partial decryption c_i = c^(2*delta*s_i) mod n^2 is the shared-exponent
sliding-window ladder (kernel B1 on a CUDA tensor).  Combining is the
reference's Lagrange-weighted product c' = prod_i c_i^(2*lambda_i)
mod n^2: the t weighted powers run as one per-row fixed-window ladder
over the stacked shares (kernel B2), the positive and negative weights
multiply into two products in residue space, and one batched host
inverse merges them.  m = (4 delta^2)^{-1} * L(c') mod n, with the exact
division by n a Hensel product and the constant multiply an int8
Toeplitz product (:mod:`limbmm`), as in decryption.

Both run on the engine of n^2 (``DeviceKey.engine(1)``, chosen by width
in ``bigint.engine.make_engine``).

Integer division in the Lagrange weights follows Go's Euclidean
big.Int.Div exactly (go_div), so the weights agree bit for bit with the
reference (thresholdkey.go:91-107).  Every operation runs on the device
of its ciphertexts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..bigint import host, vpu
from ..bigint import limbmm as lm
from ..bigint import montgomery as mont
from ..bigint.engine import product_tree
from ..core.homomorphic import B2_WINDOW
from ..core.keys import Ciphertext, decode_batch, encode_batch
from ..ops.profiling import span, spanned
from .keys import PartialDecryption, ThresholdPublicKey, ThresholdSecretKey


def go_div(a: int, b: int) -> int:
    """Go big.Int.Div: Euclidean division (remainder in [0, |b|))."""
    q, r = divmod(a, b)
    if r < 0:
        q += 1
    return q


def L_int(u: int, n: int) -> int:
    """Host L function L(u, n) = (u - 1) / n with Go Div semantics
    (paillier.go:437-440; KAT L(21, 3) = 6, paillier_test.go:20-27)."""
    return go_div(u - 1, n)


@dataclass
class PartialDecryptionBatch:
    """A batch of partial decryptions from one server."""

    id: int
    c: torch.Tensor      # int64 limbs [..., 2L]


@dataclass
class PartialDecryptionZKPBatch:
    """One server's partial decryptions of a batch with their share
    proofs (reference: thresholdkey.go:50-58, a row per ciphertext), as
    limb tensors on the ciphertexts' device."""

    id: int
    key: ThresholdPublicKey
    c: torch.Tensor      # int64 limbs [B, 2L]: the ciphertexts
    ci: torch.Tensor     # int64 limbs [B, 2L]: the partial decryptions
    e: torch.Tensor      # int64 limbs [B, 16]: the 256-bit challenges
    z: torch.Tensor      # int64 limbs [B, zL]: the responses

    def partials(self) -> PartialDecryptionBatch:
        return PartialDecryptionBatch(id=self.id, c=self.ci)


# ---------------------------------------------------------------------------
# Partial decryption
# ---------------------------------------------------------------------------

def partial_decrypt(tsk: ThresholdSecretKey, ct: Ciphertext
                    ) -> PartialDecryptionBatch:
    """c_i = c^(2*delta*share) mod n^2 (thresholdkey.go:192-201), batched
    over the ciphertexts: one B1 ladder."""
    dk = tsk.device(ct.c.device)
    out = dk.pow_int(1, ct.c, 2 * tsk.delta * tsk.share)
    return PartialDecryptionBatch(id=tsk.id, c=out)


@spanned("partial")
def partial_decrypt_all(tsks: Sequence[ThresholdSecretKey], ct: Ciphertext
                        ) -> List[PartialDecryptionBatch]:
    """The partial decryptions of several servers of one key: the
    ciphertexts' limbs enter the engine of n^2 once, then one
    shared-exponent ladder (B1) a server (the JAX package runs the same
    ladders in one jit).  Bit-identical to a partial_decrypt call per
    server."""
    eng = tsks[0].device(ct.c.device).engine(1)
    x = eng.from_limbs(ct.c)
    return [PartialDecryptionBatch(id=tsk.id, c=eng.to_limbs_mod(
        eng.pow_shared(x, 2 * tsk.delta * tsk.share))) for tsk in tsks]


def partial_decrypt_int(tsk: ThresholdSecretKey, c: int) -> PartialDecryption:
    """Single-value host variant (parity with thresholdkey_test.go:58-74)."""
    exp = 2 * tsk.delta * tsk.share
    return PartialDecryption(id=tsk.id, decryption=pow(c, exp, tsk.n2))


# ---------------------------------------------------------------------------
# Combining
# ---------------------------------------------------------------------------

def verify_partial_decryptions(tpk: ThresholdPublicKey,
                               shares: Sequence) -> None:
    """Threshold/duplicate validation (thresholdkey.go:77-89)."""
    if len(shares) < tpk.t:
        raise ValueError("Threshold not meet")
    ids = {s.id for s in shares}
    if len(ids) != len(shares):
        raise ValueError("two shares has been created by the same server")


def compute_lambda(tpk: ThresholdPublicKey, share_id: int,
                   ids: Sequence[int]) -> int:
    """Lagrange weight, replicating the reference's incremental
    integer-division order exactly (thresholdkey.go:91-107)."""
    lam = tpk.delta
    for other in ids:
        if other != share_id:
            lam = go_div(lam * (-other), share_id - other)
    return lam


def lagrange_powers(tpk: ThresholdPublicKey, stacked_c: torch.Tensor,
                    exps: Sequence[int]) -> torch.Tensor:
    """c_s^(exps[s]) mod n^2 for every server row of [S, B, 2L] in one
    per-row fixed-window ladder (kernel B2) over the S*B stacked rows,
    each row with its server's digits (the reference runs one modexp per
    share, thresholdkey.go:119-124)."""
    dk = tpk.device(stacked_c.device)
    L = dk.L
    S, B = stacked_c.shape[:2]
    ebits = max(max(e.bit_length() for e in exps), 1)
    e_limbs = encode_batch(list(exps), -(-ebits // host.LIMB_BITS),
                           device=stacked_c.device)
    e_digits = mont.limbs_to_digits(e_limbs, B2_WINDOW)        # [S, D]
    dig = e_digits[:, None, :].expand(S, B, e_digits.shape[-1])
    powed = dk.pow(1, stacked_c.reshape(S * B, 2 * L),
                   dig.reshape(S * B, -1), B2_WINDOW)
    return powed.reshape(S, B, 2 * L)


def _combine_products(dk, powed: torch.Tensor, sel: torch.Tensor) -> tuple:
    """Masked positive / negative share products over axis 0 of
    [S, B, 2L] -> two [B, 2L] limb tensors, as two trees
    (:func:`..bigint.engine.product_tree`) of the engine's ``mul`` mod
    n^2 (rows of the other sign, and an odd level's padding, are the
    engine's 1)."""
    eng = dk.engine(1)
    x = eng.from_limbs(powed)                                  # [S, B, C]
    one = eng.one.expand(x.shape)
    return tuple(eng.to_limbs_mod(product_tree(eng.mul, v, eng.one))
                 for v in (torch.where(sel, x, one), torch.where(sel, one, x)))


@spanned("combine")
def combine(tpk: ThresholdPublicKey,
            shares: Sequence[PartialDecryptionBatch]) -> List[int]:
    """Merge partial decryptions into plaintexts (thresholdkey.go:149-161),
    batched over ciphertexts and shares: the Lagrange-weighted powers as
    one stacked B2 ladder, the positive / negative products in residue
    space, one batched host inverse, then c' = pos * neg^-1,
    L(c') = (c' - 1) / n and the constant (4 delta^2)^-1 mod n."""
    verify_partial_decryptions(tpk, shares)
    dev = shares[0].c.device
    dk = tpk.device(dev)
    L = dk.L
    ids = [s.id for s in shares]

    with span("host_int", op="lagrange"):
        lam2s = [2 * compute_lambda(tpk, s.id, ids) for s in shares]
    use = [(s, l2) for s, l2 in zip(shares, lam2s) if l2 != 0]
    if use:
        stacked = torch.stack([s.c.reshape(-1, 2 * L) for s, _ in use])
        powed = lagrange_powers(tpk, stacked, [abs(l2) for _, l2 in use])
        sel = torch.tensor([l2 > 0 for _, l2 in use],
                           device=dev)[:, None, None]
        pos, neg = _combine_products(dk, powed, sel)
    else:
        pos = neg = vpu.one_like(shares[0].c.reshape(-1, 2 * L))

    # c' = pos * neg^{-1} mod n^2 with one batched host inverse (a public
    # value: no secret exponent exists to invert with on the device)
    neg_inv = encode_batch(host.modinv_batch(decode_batch(neg), tpk.n2),
                           2 * L, device=dev)
    return decode_batch(_combine_tail(dk, tpk, pos, neg_inv))


def _combine_tail(dk, tpk: ThresholdPublicKey, pos: torch.Tensor,
                  neg_inv: torch.Tensor) -> torch.Tensor:
    """m = (4 delta^2)^-1 * L(pos * neg_inv mod n^2) mod n: limbs [B, L]
    from the positive product and the inverse of the negative one."""
    L, n = dk.L, tpk.n
    cprime = dk.mul(1, pos, neg_inv)
    um1 = vpu.sub(cprime, vpu.one_like(cprime))[0]
    lval = lm.const_mul(um1[..., :L], dk.div_n_plan(L))        # (c'-1)/n
    return lm.modmul_const(lval, dk.mod_mul_plan(tpk.combine_shares_constant,
                                                 n, L), dk.barrett_plan(n))


def combine_ints(tpk: ThresholdPublicKey,
                 shares: Sequence[PartialDecryption]) -> int:
    """Host-int combining for single values (parity with
    thresholdkey_test.go:267-281)."""
    verify_partial_decryptions(tpk, shares)
    ids = [s.id for s in shares]
    cprime = 1
    for s in shares:
        lam2 = 2 * compute_lambda(tpk, s.id, ids)
        if lam2 >= 0:
            cprime = (cprime * pow(s.decryption, lam2, tpk.n2)) % tpk.n2
        else:
            cprime = (cprime * host.modinv(
                pow(s.decryption, -lam2, tpk.n2), tpk.n2)) % tpk.n2
    return (tpk.combine_shares_constant * L_int(cprime, tpk.n)) % tpk.n
