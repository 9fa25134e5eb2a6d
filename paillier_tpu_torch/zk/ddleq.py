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
(``bigint.engine.CrtSplit``, from :func:`crt_plans`).  Those plans derive
from the factors: they live in this module's cache, never in the
public-key ``DeviceKey``.  A secret key without factors proves at full
width.  The halves stop at keys of 5,774 bits (p^3 past
``rns2.MAX_MODULUS_BITS``): :func:`crt_plans` refuses wider keys, as the
JAX package's ``_CrtN3Plans`` does; ``use_crt=False``, like the verifier,
runs every ladder and product through ``DeviceKey``, which takes every
width.

With ``mesh=`` (:func:`..parallel.make_mesh`) the flat-axis stages run
sharded over the mesh's batch axis and are gathered, so every rank holds
the proof of one process (:func:`_shard_flat`).

Departure from the JAX package: no ``window=`` (B1's window is
``Config.sliding_window``, B2's is 4).

Proof fields are int64 limb tensors [B, S, limbs]; ``to_ints`` /
``from_ints`` convert to the reference's per-instance integer view.
"""

from __future__ import annotations

import functools
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..bigint import host, rns2
from ..bigint.engine import CrtSplit
from ..bigint.montgomery import limbs_to_digits
from ..core.homomorphic import B2_WINDOW, extract_randomness
from ..core.keys import (LEVEL_ONE, LEVEL_TWO, Ciphertext, PublicKey,
                         SecretKey, decode_batch, encode_batch)
from ..ops import random as prand
from ..ops.profiling import spanned
from ..ops.sha256 import concat_be, limbs_to_be_bytes, sha256_bytes
from ..parallel.collective import _all_gather
from ..parallel.mesh import BATCH_AXIS, axis


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


def crt_plans(sk: SecretKey, device) -> Optional[CrtSplit]:
    """The prover's split of n^3 into p^3 and q^3 (k = 256 channels a
    half at 2048 bits, where n^3 takes 512) for ``sk`` on ``device``,
    from this module's cache (the few most recent keys); None when the
    key carries no factors (p * q != n), which proves at full width.
    Raises ValueError past 5,774-bit keys.  Reference: ddleq.go:55-127
    computes these powers at full width; the split has no counterpart
    there."""
    if not (sk.p > 1 and sk.q > 1 and sk.p * sk.q == sk.n):
        return None
    bits = (max(sk.p, sk.q) ** 3).bit_length()
    if bits > rns2.MAX_MODULUS_BITS:
        raise ValueError(
            f"not enough sub-14-bit primes for the RNS engine of a CRT half "
            f"({bits} bits, past {rns2.MAX_MODULUS_BITS}): DDLEQ's split "
            f"takes keys of up to 5,774 bits; prove with use_crt=False")
    return _plans(sk.p, sk.q, host.limbs_for_bits(sk.bits),
                  torch.device(device))


@functools.lru_cache(maxsize=4)
def _plans(p: int, q: int, L: int, device: torch.device) -> CrtSplit:
    return CrtSplit(p, q, 3, L, device=device)


def _flat(ct: Ciphertext, L: int, device) -> torch.Tensor:
    return ct.c.reshape(-1, 3 * L).to(device)


def _shard_flat(mesh, fn, *arrays, group=None):
    """Run ``fn(*arrays)`` on this rank's contiguous block of the arrays'
    leading (flattened proof x instance) axis, sharded over the mesh's
    batch axis, and gather every output over that axis, so each rank
    holds the whole result.  Every DDLEQ stage is elementwise over that
    axis: the gathers are the only collectives.  ``group`` is the batch
    group to gather over (default the mesh's; the pipeline gives each
    worker its own).  Raises ValueError when the flat batch does not
    divide the mesh."""
    n_dev = mesh.size()
    B0 = arrays[0].shape[0]
    if B0 % n_dev:
        raise ValueError(f"flat batch {B0} must divide the {n_dev}-device "
                         "mesh (pad the proof batch)")
    size, i = axis(mesh, BATCH_AXIS)
    blk = B0 // size
    outs = fn(*(a[i * blk:(i + 1) * blk] for a in arrays))
    if group is None:
        group = mesh.get_group(BATCH_AXIS)
    if isinstance(outs, torch.Tensor):
        return _all_gather(outs, group).flatten(0, 1)
    return tuple(_all_gather(o, group).flatten(0, 1) for o in outs)


def _stage_runner(mesh, group=None):
    """How a prove / verify runs its flat-axis stages: whole, or sharded
    over ``mesh`` (:func:`_shard_flat`)."""
    if mesh is None:
        return lambda fn, *arrays: fn(*arrays)
    return functools.partial(_shard_flat, mesh, group=group)


def prove(sk: SecretKey, ct1: Ciphertext, ct2: Ciphertext,
          a_list: Sequence[int], b_list: Sequence[int], secpar: int,
          rng=None, *, mesh=None, use_crt: bool = True) -> DDLEQProof:
    """ProveDDLEQ (ddleq.go:27-40, 55-127), batched over proofs and
    instances on the device of ``ct1``.  Requires the secret key
    (randomness extraction).

    ``use_crt`` runs the three per-(proof, instance) ladders mod n^3 and
    y^(n^2) through the p^3/q^3 split (bit-identical proofs).  Launches
    on a CUDA device: B1 7, B2 8, B4 1 with the split; B1 6, B2 5, B4 1
    without.  The same ``rng`` state gives the JAX package's proof.

    With ``mesh`` (:func:`..parallel.make_mesh`), every rank calls it
    with the whole chunk and the same ``rng`` state: the commitment and
    response stages run on this rank's block of the flat axis and are
    gathered, the per-proof work runs on every rank, and every rank
    returns the proof of one process, bit for bit (same launches)."""
    return _prove(sk, ct1, ct2, a_list, b_list, secpar, rng, use_crt,
                  _stage_runner(mesh))


@spanned("prove")
def _prove(sk, ct1, ct2, a_list, b_list, secpar, rng, use_crt,
           run) -> DDLEQProof:
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
            return crt.pow(base, digits, B2_WINDOW)
        return dk.pow(LEVEL_TWO, base, digits, B2_WINDOW)

    def commit_stage(x2, y3, c1r, c2r):
        """x^n, y^(n^2), alpha = ct1^(x^n) * y^(n^2), the challenge bits
        (ddleq.go:81-91)."""
        xn = dk.pow_int(LEVEL_ONE, x2, n)                      # [., 2L]
        yn2 = (crt.pow_shared(y3, n2) if crt is not None
               else dk.pow_int(LEVEL_TWO, y3, n2))             # [., 3L]
        alph = dk.mul(LEVEL_TWO, pow_n3(c1r, limbs_to_digits(xn, B2_WINDOW)),
                      yn2)
        return xn, alph, _challenge_bits(c2r, x2[:, :L], y3[:, :L], alph)

    xn, alpha, chal = run(commit_stage, X2, Y3, c1_rep, c2_rep)
    sel = (chal != 0)[:, None]

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

    def response_stage(selb, x2, y3, ai, ti, s3r, xnr):
        """The e and f responses (ddleq.go:94-115)."""
        e_out = torch.where(selb, dk.mul(LEVEL_ONE, x2, ai), x2)   # [., 2L]
        ed = limbs_to_digits(dk.pow_int(LEVEL_ONE, e_out, n), B2_WINDOW)
        t_inv_pow = pow_n3(ti, ed)                                  # t^{-e^n}
        s_xn = pow_n3(s3r, limbs_to_digits(xnr, B2_WINDOW))
        f_true = dk.mul(LEVEL_TWO, dk.mul(LEVEL_TWO, y3, s_xn), t_inv_pow)
        return e_out, torch.where(selb, f_true, y3)

    e, f = run(response_stage, sel, X2, Y3, AI, TI, S3_rep, xn)

    def shape(v):
        return v.reshape(B, S, v.shape[-1])
    return DDLEQProof(x=shape(X), y=shape(Y), alpha=shape(alpha),
                      e=shape(e), f=shape(f))


def verify(pk: PublicKey, ct1: Ciphertext, ct2: Ciphertext,
           proof: DDLEQProof, *, mesh=None) -> List[bool]:
    """VerifyDDLEQProof (ddleq.go:44-53, 129-153), batched on the device
    of ``ct1``: one bool per proof (all S instances must check).
    Launches on a CUDA device: B1 2, B2 1.  With ``mesh``, every rank
    checks its block of the flat axis and the [B*S] verdicts are gathered
    (the one collective); every rank returns all the verdicts."""
    return _verify(pk, ct1, ct2, proof, _stage_runner(mesh))


@spanned("verify")
def _verify(pk, ct1, ct2, proof, run) -> List[bool]:
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

    def check_stage(x, y, alph, e_in, f_in, c1r, c2r):
        selb = (_challenge_bits(c2r, x, y, alph) != 0)[:, None]
        en = dk.pow_int(LEVEL_ONE, e_in, n)                    # e^n mod n^2
        fn2 = dk.pow_int(LEVEL_TWO, f_in, n2)                  # f^(n^2)
        powed = dk.pow(LEVEL_TWO, torch.where(selb, c2r, c1r),
                       limbs_to_digits(en, B2_WINDOW), B2_WINDOW)
        return (dk.mul(LEVEL_TWO, powed, fn2) == alph).all(dim=-1)

    ok = run(check_stage, X, Y, alpha, E, F, c1_rep, c2_rep)
    return [bool(v) for v in ok.reshape(B, S).all(dim=1).tolist()]


def _worker_groups(mesh, workers: int) -> list:
    """One group over this rank's batch axis for each of ``workers``
    pipeline slots, created in the same order on every rank (each
    worker's collectives then run in one order on every rank)."""
    size, _ = axis(mesh, BATCH_AXIS)
    rows = mesh.mesh.reshape(-1, size).tolist()   # batch is the last axis
    me = dist.get_rank()
    mine = []
    for _ in range(workers):
        for ranks in rows:
            g = dist.new_group(ranks)
            if me in ranks:
                mine.append(g)
    return mine


def pipeline_prove_verify(sk: SecretKey, jobs, secpar: int, *, mesh=None,
                          workers: int = 2,
                          verify_pk: PublicKey | None = None):
    """Prove and verify a stream of chunks, chunk i's host work (native
    inverses, digit strings, decode / encode, the challenges' bytes)
    overlapping chunk i +- 1's device ladders.

    ``jobs`` is an iterable of (ct1, ct2, a_list, b_list, rng) chunk
    tuples.  Two worker threads: while one blocks on a readback or runs
    the GMP inverses (which release the GIL), the other's launches keep
    the card busy.  Chunk j goes to worker j mod ``workers``, which takes
    its chunks in order; with ``mesh`` each worker gathers over a group
    of its own, so every rank issues each group's collectives in one
    order.  Both workers launch on the caller's current stream of each
    chunk's device, so every tensor is made and read in one stream order.
    Run one chunk serially first: the engines and plans are built on
    first use.  Yields one List[bool] of per-proof verdicts per chunk, in
    order."""
    pk = verify_pk or sk.public()
    items = []                     # the streams are read in this thread
    for job in jobs:
        dev = job[0].c.device
        items.append((job, torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None))
    groups = (_worker_groups(mesh, workers) if mesh is not None
              else [None] * workers)
    futs = [Future() for _ in items]

    def slot(w):
        run = _stage_runner(mesh, groups[w])
        for j in range(w, len(items), workers):
            (ct1, ct2, a_l, b_l, rng), stream = items[j]
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else nullcontext()):
                    proof = _prove(sk, ct1, ct2, a_l, b_l, secpar, rng,
                                   True, run)
                    futs[j].set_result(_verify(pk, ct1, ct2, proof, run))
            except Exception as exc:
                for k in range(j, len(items), workers):
                    futs[k].set_exception(exc)
                return

    try:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            slots = [ex.submit(slot, w) for w in range(workers)]
            for fut in futs:
                yield fut.result()
            for fut in slots:
                fut.result()
    finally:
        if mesh is not None:
            for g in groups:
                dist.destroy_process_group(g)
