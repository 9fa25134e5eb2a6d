"""Share-decryption zero-knowledge proofs (reference:
thresholdkey.go:164-172, 225-326).

Fiat-Shamir: a = (c^4)^r, b = V^r mod n^2, e = SHA256(a||b||c^4||c_i^2),
z = r + e*delta*s_i.  The hash covers the unreduced integers c^4 and
c_i^2 (the reference exponentiates with a nil modulus at
thresholdkey.go:241,248): they are full-width limb products here, hashed
as their minimal big-endian bytes for bit parity.

The batch path keeps a server's proofs on the ciphertexts' device as
limb tensors (:class:`PartialDecryptionZKPBatch`):
:func:`partial_decrypt_with_zkp_batch` proves for several servers of one
key at once (the partial decryptions by ``partial_decrypt_all``, the
commitment ladders of a server as one per-row fixed-window ladder,
kernel B2 on a CUDA tensor, the challenges by the batched SHA-256 of
:mod:`ops.sha256`, the responses as limb products), and
:func:`combine_with_zkp_batch` verifies every server's rows (the four
verifier ladders as two, over the servers' stacked rows), drops each
server whose proofs do not all verify and combines the rest.  Host work:
the provers' draws of r, each made while the card runs the ladders
launched before it, and one batched inverse of the c_i^2 made while the
card runs the verifier's z ladders.  The list functions
(``partial_decrypt_with_zkp``, ``verify_proofs``, ``combine_with_zkp``)
convert to and from the batch path; ``verify_proof`` is the host
single-proof verifier.  Entry points that start from host ints take the
device to work on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..core.encrypt import Encryptor
from ..core.homomorphic import B2_WINDOW
from ..core.keys import Ciphertext, decode_batch, encode_batch
from ..ops import random as prand
from ..ops.oracle import zkp_hash
from ..ops.profiling import count, span, spanned
from ..ops.sha256 import concat_be, limbs_to_be_bytes, sha256_bytes
from .decrypt import (PartialDecryptionZKPBatch, combine, combine_ints,
                      partial_decrypt_all)
from .keys import (PartialDecryption, PartialDecryptionZKP,
                   ThresholdPublicKey, ThresholdSecretKey)

# Bits of a challenge (SHA-256), and its limbs.
E_BITS = 256
E_LIMBS = E_BITS // host.LIMB_BITS


def _zkp_challenges(a, b, c4_full, ci2_full) -> torch.Tensor:
    """Batched SHA256(a || b || c^4 || c_i^2) (thresholdkey.go:319-326) as
    limbs [B, 16] of the 256-bit big-endian digests.  Inputs are limb
    tensors [B, *]; each is hashed as its minimal big-endian encoding
    (Go's Bytes(), zero giving none)."""
    parts = [limbs_to_be_bytes(v) for v in (a, b, c4_full, ci2_full)]
    out_len = sum(p[0].shape[-1] for p in parts)
    buf, ln = concat_be(parts, out_len)
    words = sha256_bytes(buf, ln).flip(-1)        # least significant first
    return torch.stack([words & 0xFFFF, words >> 16], dim=-1).reshape(
        words.shape[0], E_LIMBS)


def _full_square(x: torch.Tensor) -> torch.Tensor:
    """x^2 at full width (no reduction: the reference hashes the
    unreduced integers)."""
    return vpu.mul(x, x, 2 * x.shape[-1])


def _v_rows(tpk: ThresholdPublicKey, rows: int, width: int,
            device) -> torch.Tensor:
    """The limbs of V on ``rows`` rows."""
    return encode_batch([tpk.v], width, device=device).expand(rows, width)


def _host_ints(x: torch.Tensor):
    """Queue a copy of limbs ``x`` to the host ahead of the work queued
    after it; the function returned waits for that copy alone and gives
    the ints (under the ``decode`` span)."""
    if x.device.type != "cuda":
        return lambda: decode_batch(x)
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def ints() -> List[int]:
        with span("decode", rows=x.shape[0]):
            done.synchronize()
            return host.limbs_to_ints(buf.numpy())
    return ints


@spanned("zkp_prove")
def partial_decrypt_with_zkp_batch(tsks: Sequence[ThresholdSecretKey],
                                   ct: Ciphertext, rngs=None
                                   ) -> List[PartialDecryptionZKPBatch]:
    """Batched PartialDecryptionWithZKP (thresholdkey.go:225-255) of
    several servers of one key on the ciphertexts' device: their partial
    decryptions (``partial_decrypt_all``), each server's commitments a
    and b as one B2 ladder over both bases' rows (per-row digits of
    r < n^2), the unreduced c^4 / c_i^2, the batched challenges of every
    server and z = r + e*delta*s_i (thresholdkey.go:313-317) as limb
    products.  Server ``tsks[i]`` draws its r with
    ``rngs[i].randrange(n^2)`` in row order, so each batch holds
    :func:`partial_decrypt_with_zkp`'s proofs from the same generator.
    Each server's draws run on the host while the card runs the ladders
    launched before them."""
    tsks = list(tsks)
    rngs = list(rngs) if rngs is not None else [prand.make_rng()
                                                for _ in tsks]
    if len(rngs) != len(tsks):
        raise ValueError(f"{len(tsks)} servers, {len(rngs)} generators")
    dev = ct.c.device
    dk = tsks[0].device(dev)
    L = dk.L
    c = ct.c.reshape(-1, 2 * L)
    B = c.shape[0]
    ds = [t.delta * t.share for t in tsks]
    ds_limbs = host.limbs_for_bits(max(d.bit_length() for d in ds))
    ds_rows = torch.cat([encode_batch([d], ds_limbs, device=dev).expand(
        B, ds_limbs) for d in ds])
    v = _v_rows(tsks[0], B, 2 * L, dev)

    parts = partial_decrypt_all(tsks, Ciphertext(c=c))
    c2m = dk.mul(1, c, c)
    bases = torch.cat([dk.mul(1, c2m, c2m), v])     # c^4 mod n^2, and V
    # the host draws each server's r, and launches the full-width c^4 and
    # c_i^2 (thousands of small kernels), while a ladder runs
    ci = torch.cat([p.c.reshape(-1, 2 * L) for p in parts])
    rs, ab = [], []
    for i, rng in enumerate(rngs):
        with span("host_int", op="zkp_r"):
            drawn = [rng.randrange(tsks[0].n2) for _ in range(B)]
        rs.append(encode_batch(drawn, 2 * L, device=dev))
        ab.append(dk.pow(1, bases, mont.limbs_to_digits(rs[-1], B2_WINDOW)
                         .repeat(2, 1), B2_WINDOW))
        if i == 0:
            c4_full = _full_square(_full_square(c)).repeat(len(tsks), 1)
    e = _zkp_challenges(torch.cat([x[:B] for x in ab]),
                        torch.cat([x[B:] for x in ab]), c4_full,
                        _full_square(ci))
    width = host.limbs_for_bits(max(tsks[0].n2.bit_length(),
                                    E_BITS + ds_limbs * host.LIMB_BITS) + 1)
    z, _ = vpu.add(vpu.mul(e, ds_rows, width),
                   torch.nn.functional.pad(torch.cat(rs),
                                           (0, width - 2 * L)))
    key = tsks[0].public()
    return [PartialDecryptionZKPBatch(
        id=t.id, key=key, c=c, ci=ci[i * B:(i + 1) * B],
        e=e[i * B:(i + 1) * B], z=z[i * B:(i + 1) * B])
        for i, t in enumerate(tsks)]


@spanned("zkp_verify")
def _verify(tpk: ThresholdPublicKey,
            batches: Sequence[PartialDecryptionZKPBatch]
            ) -> List[torch.Tensor]:
    """The verdicts (bool [B] a batch) of VerifyProof
    (thresholdkey.go:278-311) on every row of ``batches`` under ``tpk``:
    a = (c^4)^z * (c_i^2)^{-e}, b = V^z * v_i^{-e} mod n^2, then the
    batched SHA-256 recomputes the challenges.  The ladders of every
    batch's rows run together: the z ladders of both bases as one B2
    ladder, while the host inverts the c_i^2 (one batched inverse), then
    the e ladders as another (t^{-e} = (t^{-1})^e); v_i^{-1} is one
    inverse a server."""
    if not batches:
        return []
    dev = batches[0].c.device
    dk = tpk.device(dev)
    L = dk.L
    S = len(batches)
    sizes = [b.ci.shape[0] for b in batches]
    R = sum(sizes)

    ci = torch.cat([b.ci for b in batches])
    ci2m_ints = _host_ints(dk.mul(1, ci, ci))
    shared = S > 1 and all(b.c is batches[0].c for b in batches)
    c = batches[0].c if shared else torch.cat([b.c for b in batches])
    c2m = dk.mul(1, c, c)
    c4m = dk.mul(1, c2m, c2m)
    c4_full = _full_square(_full_square(c))
    if shared:
        c4m, c4_full = c4m.repeat(S, 1), c4_full.repeat(S, 1)
    zw = max(b.z.shape[-1] for b in batches)
    z = torch.cat([torch.nn.functional.pad(b.z, (0, zw - b.z.shape[-1]))
                   for b in batches])
    e = torch.cat([b.e for b in batches])
    ci2_full = _full_square(ci)
    # launches only up to here, queued behind the card's work; the first
    # wait for the card is V's copy, just before the z ladders
    zpow = dk.pow(1, torch.cat([c4m, _v_rows(tpk, R, 2 * L, dev)]),
                  mont.limbs_to_digits(z, B2_WINDOW).repeat(2, 1), B2_WINDOW)
    # the inverses of the c_i^2 on the host while the z ladders run
    ci2_inv = encode_batch(host.modinv_batch(ci2m_ints(), tpk.n2), 2 * L,
                           device=dev)
    vi_inv = encode_batch(host.modinv_batch(
        [tpk.vi[b.id - 1] for b in batches], tpk.n2), 2 * L, device=dev)
    vi_rows = torch.cat([x.expand(k, 2 * L) for x, k in zip(vi_inv, sizes)])
    epow = dk.pow(1, torch.cat([ci2_inv, vi_rows]),
                  mont.limbs_to_digits(e, B2_WINDOW).repeat(2, 1), B2_WINDOW)
    a = dk.mul(1, zpow[:R], epow[:R])
    b = dk.mul(1, zpow[R:], epow[R:])
    ok = (_zkp_challenges(a, b, c4_full, ci2_full) == e).all(dim=-1)
    count("zkp.rows_verified", R)
    return list(ok.split(sizes))


def verify_proofs_batch(batch: PartialDecryptionZKPBatch) -> torch.Tensor:
    """Batched VerifyProof (thresholdkey.go:278-311) of one server's
    proofs on their device, under the batch's key: bool [B], True where
    the row's proof verifies."""
    return _verify(batch.key, [batch])[0]


@dataclass
class CombinedWithZKP:
    """What :func:`combine_with_zkp_batch` gives: the plaintexts, the ids
    of the servers combined and of those dropped, and every batch's
    verdicts (bool [B], in the order the batches came)."""

    plaintexts: List[int]
    kept: List[int]
    dropped: List[int]
    verdicts: List[torch.Tensor]


@spanned("zkp_combine")
def combine_with_zkp_batch(tpk: ThresholdPublicKey,
                           batches: Sequence[PartialDecryptionZKPBatch]
                           ) -> CombinedWithZKP:
    """CombinePartialDecryptionsZKP (thresholdkey.go:164-172) on the
    batches' device: verify every row of every server under ``tpk``, drop
    each server whose proofs do not all verify, and ``combine`` the rest
    (which raises ValueError where fewer than t remain)."""
    verdicts = _verify(tpk, batches)
    good = torch.stack([v.all() for v in verdicts]).tolist() \
        if verdicts else []
    kept = [b for b, ok in zip(batches, good) if ok]
    dropped = [b.id for b, ok in zip(batches, good) if not ok]
    count("zkp.servers_dropped", len(dropped))
    pts = combine(tpk, [b.partials() for b in kept])
    return CombinedWithZKP(plaintexts=pts, kept=[b.id for b in kept],
                           dropped=dropped, verdicts=verdicts)


def _to_list(batch: PartialDecryptionZKPBatch) -> List[PartialDecryptionZKP]:
    cs, cis, es, zs = (decode_batch(x) for x in (batch.c, batch.ci, batch.e,
                                                 batch.z))
    return [PartialDecryptionZKP(id=batch.id, decryption=ci, key=batch.key,
                                 e=e, z=z, c=c)
            for c, ci, e, z in zip(cs, cis, es, zs)]


def _to_batch(proofs: Sequence[PartialDecryptionZKP], device
              ) -> PartialDecryptionZKPBatch:
    tpk = proofs[0].key
    L = host.limbs_for_bits(tpk.bits)
    z_limbs = host.limbs_for_bits(max(p.z.bit_length() for p in proofs))
    return PartialDecryptionZKPBatch(
        id=proofs[0].id, key=tpk,
        c=encode_batch([p.c for p in proofs], 2 * L, device=device),
        ci=encode_batch([p.decryption for p in proofs], 2 * L, device=device),
        e=encode_batch([p.e for p in proofs], E_LIMBS, device=device),
        z=encode_batch([p.z for p in proofs], z_limbs, device=device))


def partial_decrypt_with_zkp(tsk: ThresholdSecretKey, ct: Ciphertext,
                             rng=None) -> List[PartialDecryptionZKP]:
    """PartialDecryptionWithZKP (thresholdkey.go:225-255) of every
    ciphertext of ``ct``, a proof a row, as host ints: this server's
    :func:`partial_decrypt_with_zkp_batch`.  Each r is drawn with
    ``rng.randrange(n^2)`` in row order, as in the JAX package."""
    return _to_list(partial_decrypt_with_zkp_batch(
        [tsk], ct, [rng or prand.make_rng()])[0])


def verify_proofs(proofs: Sequence[PartialDecryptionZKP], *,
                  device="cuda") -> List[bool]:
    """Batched VerifyProof (thresholdkey.go:278-311) on ``device``: the
    proofs, a batch a server id, verified together under the first
    proof's key (all proofs must share one public key)."""
    if not proofs:
        return []
    rows: dict = {}
    for j, p in enumerate(proofs):
        rows.setdefault(p.id, []).append(j)
    oks = _verify(proofs[0].key, [_to_batch([proofs[j] for j in js], device)
                                  for js in rows.values()])
    out = [False] * len(proofs)
    for js, ok in zip(rows.values(), oks):
        for j, v in zip(js, ok.tolist()):
            out[j] = v
    return out


def verify_proof(pd: PartialDecryptionZKP) -> bool:
    """VerifyProof (thresholdkey.go:278-311), host single-proof variant
    (the batched one is :func:`verify_proofs`)."""
    tpk = pd.key
    n2 = tpk.n2
    c4 = pd.c ** 4
    ci2 = pd.decryption ** 2
    # a = (c^4)^Z * (c_i^2)^{-E} mod n^2
    a = (pow(c4 % n2, pd.z, n2)
         * host.modinv(pow(ci2 % n2, pd.e, n2), n2)) % n2
    # b = V^Z * (v_i)^{-E} mod n^2
    vi = tpk.vi[pd.id - 1]
    b = (pow(tpk.v, pd.z, n2)
         * host.modinv(pow(vi, pd.e, n2), n2)) % n2
    return zkp_hash(a, b, c4, ci2) == pd.e


def verify_partial_decryption(tsk: ThresholdSecretKey, rng=None, *,
                              device="cuda") -> None:
    """Self-test of one share (reference VerifyPartialDecryption,
    thresholdkey.go:258-275): encrypt a random message under the public
    key on ``device``, produce this share's proofs, and verify them.
    Raises ValueError("Invalid share") on failure."""
    rng = rng or prand.make_rng()
    m = rng.randrange(tsk.n)
    ct = Encryptor(tsk.public(), rng=rng, device=device).encrypt([m])
    batch = partial_decrypt_with_zkp_batch([tsk], ct, [rng])[0]
    if not bool(verify_proofs_batch(batch).all()):
        raise ValueError("Invalid share")


def combine_with_zkp(tpk: ThresholdPublicKey,
                     proofs_per_server: Sequence[
                         Sequence[PartialDecryptionZKP]], *,
                     device="cuda") -> List[int]:
    """CombinePartialDecryptionsZKP (thresholdkey.go:164-172) on
    ``device``: :func:`combine_with_zkp_batch` of the servers' proofs, a
    batch a server."""
    return combine_with_zkp_batch(
        tpk, [_to_batch(ps, device) for ps in proofs_per_server]).plaintexts


def verify_decryption(tpk: ThresholdPublicKey, encrypted: int, decrypted: int,
                      proofs: Sequence[PartialDecryptionZKP], *,
                      device="cuda") -> None:
    """VerifyDecryption (thresholdkey.go:175-189): check that ``proofs``
    decrypt ``encrypted`` to ``decrypted``; proofs that do not verify on
    ``device`` are left out of the host combine."""
    for p in proofs:
        if p.c != encrypted:
            raise ValueError("The encrypted message is not the same than "
                             "the one in the shares")
    oks = verify_proofs(proofs, device=device)
    survivors = [PartialDecryption(id=p.id, decryption=p.decryption)
                 for p, ok in zip(proofs, oks) if ok]
    if combine_ints(tpk, survivors) != decrypted:
        raise ValueError("The decrypted message is not the same than the "
                         "one in the shares")
