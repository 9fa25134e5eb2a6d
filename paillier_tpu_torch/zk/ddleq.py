"""DDLEQ zero-knowledge proofs of nested re-encryption (reference:
ddleq.go:9-153).

Proves ct2 = ct1^(a^n mod n^2) * b^(n^2) mod n^3 (the NestedRandomize
relation) without revealing (a, b).  A proof is ``secpar`` independent
Fiat-Shamir instances, each with soundness 1/2.

The port of ``paillier_tpu.zk.ddleq``, on the device of the
ciphertexts.  All (proof, instance) pairs form one flat batch axis:

* every modexp is one batched ladder: a shared host exponent on the
  sliding-window ladder (kernel B1 on a CUDA tensor), per-element
  exponents taken from device limbs on the fixed-window ladder (kernel
  B2); the randomness of ct1 comes from ``extract_randomness`` (a B1
  decryption and a B4 ladder);
* products of two values run in residue space (``DeviceKey.mul``);
* Fiat-Shamir challenges run through the batched SHA-256 of
  :mod:`..ops.sha256`, with the reference oracle's skip-first-input
  quirk (random_oracle.go:24-26): ct1.C is not bound by the digest;
* the host does one *per-proof* (not per-instance) batch of modular
  inverses each for a^-1 and t^-1 (t^{-e^n} = (t^{-1})^{e^n});
* randomness arrives as limb arrays (``ops.random.random_units_limbs``).

The prover knows p and q, so each per-element ladder mod n^3 runs as two
half-width ladders mod p^3 and mod q^3 and a Garner recombine
(:class:`CrtN3Plans`).  Those plans derive from the factors: they live in
this module's cache, never in the public-key ``DeviceKey``.  A secret key
without factors proves at full width.

Departures from the JAX package: no ``mesh=`` (the multi-device path
comes with ``parallel``), no ``window=`` (B1's window is
``Config.sliding_window``, B2's is 4).

Proof fields are int64 limb tensors [B, S, limbs]; ``to_ints`` /
``from_ints`` convert to the reference's per-instance integer view.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..bigint import host
from ..bigint import limbmm as lm
from ..bigint import vpu
from ..bigint.engine import make_engine
from ..bigint.montgomery import limbs_to_digits
from ..core.homomorphic import B2_WINDOW, extract_randomness
from ..core.keys import (LEVEL_ONE, LEVEL_TWO, Ciphertext, PublicKey,
                         SecretKey, decode_batch, encode_batch)
from ..ops import random as prand
from ..ops.sha256 import concat_be, limbs_to_be_bytes, sha256_bytes


@dataclass
class DDLEQProof:
    """Batched proof: B proofs x S instances, int64 limb tensors (the
    reference DDLEQProof holds S integer instances for one pair;
    ddleq.go:15-19)."""

    x: torch.Tensor        # [B, S, L]   (x < n)
    y: torch.Tensor        # [B, S, L]   (y < n)
    alpha: torch.Tensor    # [B, S, 3L]  (mod n^3)
    e: torch.Tensor        # [B, S, 2L]  (mod n^2)
    f: torch.Tensor        # [B, S, 3L]  (mod n^3)

    @property
    def secpar(self) -> int:
        return self.x.shape[1]

    def to_ints(self) -> dict:
        """Per-instance integer view {field: [B][S] ints}."""
        out = {}
        for name in ("x", "y", "alpha", "e", "f"):
            arr = getattr(self, name).cpu().numpy()
            B, S, L = arr.shape
            flat = host.limbs_to_ints(arr.reshape(B * S, L))
            out[name] = [flat[i * S:(i + 1) * S] for i in range(B)]
        return out

    @classmethod
    def from_ints(cls, x, y, alpha, e, f, L: int, device="cuda"
                  ) -> "DDLEQProof":
        def enc(rows, width):
            B, S = len(rows), len(rows[0])
            flat = [v for row in rows for v in row]
            return encode_batch(flat, width, device=device).reshape(
                B, S, width)
        return cls(x=enc(x, L), y=enc(y, L), alpha=enc(alpha, 3 * L),
                   e=enc(e, 2 * L), f=enc(f, 3 * L))


def _challenge_bits(c2_rep: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """Fiat-Shamir bit per instance = SHA256(c2 || x || y || alpha) mod 2
    (ddleq.go:91 via random_oracle.go:10-32; ct1.C is skipped by the
    oracle quirk).  All inputs are minimal big-endian encodings.  The
    digest's words are big-endian, so bit 0 of word 7 is the digest's
    parity."""
    parts = [limbs_to_be_bytes(v) for v in (c2_rep, x, y, alpha)]
    out_len = sum(p[0].shape[-1] for p in parts)
    buf, ln = concat_be(parts, out_len)
    return sha256_bytes(buf, ln)[:, 7] & 1


class CrtN3Plans:
    """Prover-side CRT split of the per-element n^3 ladders.

    n^3 = p^3 * q^3, so every modexp mod n^3 can run as two half-width
    ladders (mod p^3 and mod q^3; k = 256 channels a base at 2048 bits
    where n^3 takes 512) plus a Garner recombine.  The verifier has no
    factors and keeps the full-width path; proofs are bit-identical
    either way.  Each half has its own limb count (p^3 and q^3 may differ
    in length).  Reference: ddleq.go:55-127 computes these powers at full
    width; the split has no counterpart there.
    """

    def __init__(self, p: int, q: int, L: int, device):
        p3, q3 = p ** 3, q ** 3
        self.Lp = host.limbs_for_bits(p3.bit_length())
        self.Lq = host.limbs_for_bits(q3.bit_length())
        self.L3 = 3 * L
        # base mod p^3 / q^3: fold the 3L-wide operand
        self.fold_p3 = lm.FoldPlan.build(p3, 3 * L, device=device)
        self.fold_q3 = lm.FoldPlan.build(q3, 3 * L, device=device)
        self.br_p3 = lm.BarrettPlan.build(p3, device=device)
        self.br_q3 = lm.BarrettPlan.build(q3, device=device)
        self.eng_p = make_engine(p3, self.Lp, device=device)
        self.eng_q = make_engine(q3, self.Lq, device=device)
        # Garner: m = mp + p^3 * ((mq - mp) * (p^3)^{-1} mod q^3).  mp
        # < p^3 may exceed q^3 severalfold, so it is folded mod q^3 first.
        self.fold_pq = lm.FoldPlan.build(q3, self.Lp, device=device)
        self.pinv = lm.ModMulConstPlan.build(pow(p3, -1, q3), q3, self.Lq,
                                             device=device)
        self.mul_p3 = lm.ConstMulPlan.build(p3, self.Lq, 3 * L,
                                            device=device)
        self.q3_limbs = encode_batch([q3], self.Lq, device=device)[0]
        # group orders mod p^3 / q^3: shared host exponents reduce mod
        # these (every DDLEQ operand is a unit)
        self.ord_p = p * p * (p - 1)
        self.ord_q = q * q * (q - 1)

    def combine(self, mp: torch.Tensor, mq: torch.Tensor) -> torch.Tensor:
        """Garner: [..., Lp] mod p^3 and [..., Lq] mod q^3 -> [..., 3L]."""
        mp_q = lm.fold_mod(mp, self.fold_pq, self.br_q3)
        diff, borrow = vpu.sub(mq, mp_q)
        fixed, _ = vpu.add(diff, self.q3_limbs.expand(diff.shape))
        diff = torch.where(borrow[..., None] != 0, fixed, diff)
        t = lm.modmul_const(diff, self.pinv, self.br_q3)
        pt = lm.const_mul(t, self.mul_p3)            # t * p^3 < n^3, exact
        m, _ = vpu.add(pt, torch.nn.functional.pad(mp, (0, self.L3 - self.Lp)))
        return m

    def _halves(self, base: torch.Tensor, ladder) -> torch.Tensor:
        out = []
        for fold, br, eng, ordm in ((self.fold_p3, self.br_p3, self.eng_p,
                                     self.ord_p),
                                    (self.fold_q3, self.br_q3, self.eng_q,
                                     self.ord_q)):
            x = eng.from_limbs(lm.fold_mod(base, fold, br))
            out.append(eng.to_limbs_mod(ladder(eng, x, ordm)))
        return self.combine(*out)

    def pow(self, base: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """base^e mod n^3 for per-element MSB-first base-16 ``digits``:
        a B2 ladder a half.  Returns [..., 3L] limbs."""
        return self._halves(base, lambda eng, x, _: eng.pow(x, digits,
                                                             B2_WINDOW))

    def pow_shared(self, base: torch.Tensor, e: int) -> torch.Tensor:
        """base^e mod n^3 for a shared host exponent, reduced mod each
        half's group order p^2(p-1) / q^2(q-1): a B1 ladder a half."""
        return self._halves(base, lambda eng, x, ordm: eng.pow_shared(
            x, e % ordm))


def crt_plans(sk: SecretKey, device) -> Optional[CrtN3Plans]:
    """The prover's CRT plans of ``sk`` on ``device``, from this module's
    cache (the few most recent keys); None when the key carries no
    factors (p * q != n), which proves at full width."""
    if not (sk.p > 1 and sk.q > 1 and sk.p * sk.q == sk.n):
        return None
    return _plans(sk.p, sk.q, host.limbs_for_bits(sk.bits),
                  torch.device(device))


@functools.lru_cache(maxsize=4)
def _plans(p: int, q: int, L: int, device: torch.device) -> CrtN3Plans:
    return CrtN3Plans(p, q, L, device)


def _flat(ct: Ciphertext, L: int, device) -> torch.Tensor:
    return ct.c.reshape(-1, 3 * L).to(device)


def prove(sk: SecretKey, ct1: Ciphertext, ct2: Ciphertext,
          a_list: Sequence[int], b_list: Sequence[int], secpar: int,
          rng=None, *, use_crt: bool = True) -> DDLEQProof:
    """ProveDDLEQ (ddleq.go:27-40, 55-127), batched over proofs and
    instances on the device of ``ct1``.  Requires the secret key
    (randomness extraction).

    ``use_crt`` runs the three per-(proof, instance) ladders mod n^3 and
    y^(n^2) through the p^3/q^3 split (bit-identical proofs).  Launches
    on a CUDA device: B1 7, B2 8, B4 1 with the split; B1 6, B2 5, B4 1
    without.  The same ``rng`` state gives the JAX package's proof."""
    rng = rng or prand.make_rng()
    if ct1.level != LEVEL_TWO or ct2.level != LEVEL_TWO:
        raise ValueError("DDLEQ operates on level-2 (nested) ciphertexts")
    dev = ct1.c.device
    dk = sk.device(dev)
    L = dk.L
    n, n2, n3 = sk.n, sk.n2, sk.n3
    c1, c2 = _flat(ct1, L, dev), _flat(ct2, L, dev)
    B = c1.shape[0]
    S = secpar
    BS = B * S

    # a^n mod n^2 (shared exponent n), for the sanity check and for
    # t = s^(a^n) * b
    A = encode_batch(a_list, 2 * L, device=dev)
    an = dk.pow_int(LEVEL_ONE, A, n)                          # [B, 2L]
    an_digits = limbs_to_digits(an, B2_WINDOW)

    # the relation on the device (ddleq.go:62-69)
    Bv = encode_batch(b_list, 3 * L, device=dev)
    bn2 = dk.pow_int(LEVEL_TWO, Bv, n2)
    c1an = dk.pow(LEVEL_TWO, c1, an_digits, B2_WINDOW)
    if not torch.equal(dk.mul(LEVEL_TWO, c1an, bn2), c2):
        raise ValueError("cannot prove re-encryption because inputs are wrong")

    # s = extracted randomness of ct1, one per proof (ddleq.go:103)
    s_vals = extract_randomness(sk, Ciphertext(c=c1, level=LEVEL_TWO))
    S3 = encode_batch(s_vals, 3 * L, device=dev)              # [B, 3L]

    # per-(proof, instance) randomness (ddleq.go:71-79)
    X = torch.as_tensor(prand.random_units_limbs(n, BS, rng, L), device=dev)
    Y = torch.as_tensor(prand.random_units_limbs(n, BS, rng, L), device=dev)
    X2 = torch.nn.functional.pad(X, (0, L))                   # [BS, 2L]
    Y3 = torch.nn.functional.pad(Y, (0, 2 * L))               # [BS, 3L]
    c1_rep = c1.repeat_interleave(S, dim=0)
    c2_rep = c2.repeat_interleave(S, dim=0)

    crt = crt_plans(sk, dev) if use_crt else None

    def pow_n3(base, digits):
        if crt is not None:
            return crt.pow(base, digits)
        return dk.pow(LEVEL_TWO, base, digits, B2_WINDOW)

    # commitments: x^n, y^(n^2), alpha = ct1^(x^n) * y^(n^2), the
    # challenge bits (ddleq.go:81-91)
    xn = dk.pow_int(LEVEL_ONE, X2, n)                          # [BS, 2L]
    yn2 = (crt.pow_shared(Y3, n2) if crt is not None
           else dk.pow_int(LEVEL_TWO, Y3, n2))                 # [BS, 3L]
    xd = limbs_to_digits(xn, B2_WINDOW)
    alpha = dk.mul(LEVEL_TWO, pow_n3(c1_rep, xd), yn2)
    sel = (_challenge_bits(c2_rep, X, Y, alpha) != 0)[:, None]

    # e = chal ? x * a^{-1} mod n^2 : x (ddleq.go:94-99); a^{-1} is one
    # per-proof host batch inversion
    ainv = host.modinv_batch([a % n2 for a in a_list], n2)
    AI = encode_batch(ainv, 2 * L, device=dev).repeat_interleave(S, dim=0)

    # f = chal ? y * s^(x^n) * (s^(a^n) * b)^{-(e^n)} mod n^3 : y
    # (ddleq.go:101-115) with t^{-e^n} = (t^{-1})^{e^n}: B inverses
    s_an = dk.pow(LEVEL_TWO, S3, an_digits, B2_WINDOW)         # [B, 3L]
    t = dk.mul(LEVEL_TWO, s_an, Bv)
    tinv = host.modinv_batch(decode_batch(t), n3)
    TI = encode_batch(tinv, 3 * L, device=dev).repeat_interleave(S, dim=0)
    S3_rep = S3.repeat_interleave(S, dim=0)

    # responses (ddleq.go:94-115)
    e = torch.where(sel, dk.mul(LEVEL_ONE, X2, AI), X2)        # [BS, 2L]
    ed = limbs_to_digits(dk.pow_int(LEVEL_ONE, e, n), B2_WINDOW)
    t_inv_pow = pow_n3(TI, ed)                                 # t^{-e^n}
    s_xn = pow_n3(S3_rep, xd)
    f_true = dk.mul(LEVEL_TWO, dk.mul(LEVEL_TWO, Y3, s_xn), t_inv_pow)
    f = torch.where(sel, f_true, Y3)

    def shape(v):
        return v.reshape(B, S, v.shape[-1])
    return DDLEQProof(x=shape(X), y=shape(Y), alpha=shape(alpha),
                      e=shape(e), f=shape(f))


def verify(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext,
           proof: DDLEQProof) -> List[bool]:
    """VerifyDDLEQProof (ddleq.go:44-53, 129-153), batched on the device
    of ``ct1``: one bool per proof (all S instances must check).
    Launches on a CUDA device: B1 2, B2 1."""
    dev = ct1.c.device
    dk = pk.device(dev)
    L = dk.L
    n, n2 = pk.n, pk.n2
    c1, c2 = _flat(ct1, L, dev), _flat(ct2, L, dev)
    B, S = proof.x.shape[:2]
    BS = B * S

    X = proof.x.reshape(BS, L).to(dev)
    Y = proof.y.reshape(BS, L).to(dev)
    alpha = proof.alpha.reshape(BS, 3 * L).to(dev)
    E = proof.e.reshape(BS, 2 * L).to(dev)
    F = proof.f.reshape(BS, 3 * L).to(dev)
    c1_rep = c1.repeat_interleave(S, dim=0)
    c2_rep = c2.repeat_interleave(S, dim=0)

    sel = (_challenge_bits(c2_rep, X, Y, alpha) != 0)[:, None]
    en = dk.pow_int(LEVEL_ONE, E, n)                           # e^n mod n^2
    fn2 = dk.pow_int(LEVEL_TWO, F, n2)                         # f^(n^2)
    base = torch.where(sel, c2_rep, c1_rep)
    powed = dk.pow(LEVEL_TWO, base, limbs_to_digits(en, B2_WINDOW),
                   B2_WINDOW)
    check = dk.mul(LEVEL_TWO, powed, fn2)
    ok = (check == alpha).all(dim=-1).reshape(B, S).all(dim=1)
    return [bool(v) for v in ok.tolist()]


def pipeline_prove_verify(sk: SecretKey, jobs, secpar: int, *,
                          workers: int = 2,
                          verify_pk: PublicKey | None = None):
    """Prove and verify a stream of chunks, chunk i's host work (native
    inverses, digit strings, decode / encode, the hash's launches)
    overlapping chunk i +- 1's device ladders.

    ``jobs`` is an iterable of (ct1, ct2, a_list, b_list, rng) chunk
    tuples.  Two worker threads: while one blocks on a readback or runs
    the GMP inverses (which release the GIL), the other's launches keep
    the card busy.  Both workers launch on the caller's current stream
    of each chunk's device, so every tensor is made and read in one
    stream order.  Run one chunk serially first: the engines and plans
    are built on first use.  Yields one List[bool] of per-proof verdicts
    per chunk, in order."""
    pk = verify_pk or sk.public()

    def tagged():
        # Executor.map draws the jobs in the calling thread
        for job in jobs:
            dev = job[0].c.device
            yield job, (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)

    def one(item):
        (ct1, ct2, a_l, b_l, rng), stream = item
        with (torch.cuda.stream(stream) if stream is not None
              else nullcontext()):
            proof = prove(sk, ct1, ct2, a_l, b_l, secpar, rng)
            return verify(pk, ct1, ct2, proof)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        yield from ex.map(one, tagged())
