"""Share-decryption zero-knowledge proofs (reference:
thresholdkey.go:225-326).

Fiat-Shamir: a = (c^4)^r, b = V^r mod n^2, e = SHA256(a||b||c^4||c_i^2),
z = r + e*delta*s_i.  The hash covers the unreduced integers c^4 and
c_i^2 (the reference exponentiates with a nil modulus at
thresholdkey.go:241,248): they are full-width limb products here, hashed
as their minimal big-endian bytes for bit parity.

Batched over the ciphertexts on their device: the commitment ladders
and the verifier's ladders are per-row fixed-window ladders (kernel B2
on a CUDA tensor), products mod n^2 are ``DeviceKey.mul`` in residue
space, the challenges are the batched SHA-256 of :mod:`ops.sha256`.
Host work: the responses z = r + e*delta*s (one big-int multiply-add
each) and one batched inverse per negative-exponent base in the
verifier.  ``verify_proofs`` is the batched verifier; ``verify_proof``
the host single-proof one.  Entry points that start from host ints
(``verify_proofs`` and its callers) take the device to work on.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..bigint import host, vpu
from ..bigint import montgomery as mont
from ..core.encrypt import Encryptor
from ..core.homomorphic import B2_WINDOW
from ..core.keys import Ciphertext, decode_batch, encode_batch
from ..ops import random as prand
from ..ops.oracle import zkp_hash
from ..ops.sha256 import (concat_be, digest_to_ints, limbs_to_be_bytes,
                          sha256_bytes)
from .decrypt import (PartialDecryptionBatch, combine, combine_ints,
                      partial_decrypt)
from .keys import (PartialDecryption, PartialDecryptionZKP,
                   ThresholdPublicKey, ThresholdSecretKey)

# Bits of a challenge (SHA-256).
E_BITS = 256


def _zkp_challenges(a, b, c4_full, ci2_full) -> List[int]:
    """Batched SHA256(a || b || c^4 || c_i^2) (thresholdkey.go:319-326);
    one 256-bit challenge int per row.  Inputs are limb tensors [B, *];
    each is hashed as its minimal big-endian encoding (Go's Bytes(), zero
    giving none)."""
    parts = [limbs_to_be_bytes(v) for v in (a, b, c4_full, ci2_full)]
    out_len = sum(p[0].shape[-1] for p in parts)
    buf, ln = concat_be(parts, out_len)
    return digest_to_ints(sha256_bytes(buf, ln))


def _unreduced_powers(c: torch.Tensor, ci: torch.Tensor, L: int):
    """Full-width c^4 [B, 8L] and c_i^2 [B, 4L] (no reduction: the
    reference hashes the unreduced integers)."""
    c2 = vpu.mul(c, c, 4 * L)
    return vpu.mul(c2, c2, 8 * L), vpu.mul(ci, ci, 4 * L)


def _v_rows(tpk: ThresholdPublicKey, like: torch.Tensor) -> torch.Tensor:
    """The limbs of V, broadcast to ``like``'s shape."""
    return encode_batch([tpk.v], like.shape[-1],
                        device=like.device).expand(like.shape)


def partial_decrypt_with_zkp(tsk: ThresholdSecretKey, ct: Ciphertext,
                             rng=None) -> List[PartialDecryptionZKP]:
    """Batched PartialDecryptionWithZKP (thresholdkey.go:225-255) on the
    ciphertexts' device: the partial decryption (one B1 ladder), the two
    commitment ladders (B2, per-row digits of r < n^2), the unreduced
    c^4 / c_i^2 and the batched challenges.  Each r is drawn with
    ``rng.randrange(n^2)`` in row order, as in the JAX package."""
    rng = rng or prand.make_rng()
    dev = ct.c.device
    dk = tsk.device(dev)
    L = dk.L

    pd = partial_decrypt(tsk, ct)
    c = ct.c.reshape((-1, 2 * L))
    ci = pd.c.reshape((-1, 2 * L))
    rs = [rng.randrange(tsk.n2) for _ in range(c.shape[0])]

    c2m = dk.mul(1, c, c)
    c4m = dk.mul(1, c2m, c2m)                   # ladder base c^4 mod n^2
    c4_full, ci2_full = _unreduced_powers(c, ci, L)
    r_digits = mont.limbs_to_digits(encode_batch(rs, 2 * L, device=dev),
                                    B2_WINDOW)
    a = dk.pow(1, c4m, r_digits, B2_WINDOW)
    b = dk.pow(1, _v_rows(tsk, c4m), r_digits, B2_WINDOW)

    es = _zkp_challenges(a, b, c4_full, ci2_full)
    ci_vals = decode_batch(ci)
    c_vals = decode_batch(c)
    ds = tsk.delta * tsk.share
    key_pub = tsk.public()
    return [PartialDecryptionZKP(
        id=tsk.id, decryption=ci_vals[j], key=key_pub, e=es[j],
        z=rs[j] + es[j] * ds,            # thresholdkey.go:313-317
        c=c_vals[j]) for j in range(len(rs))]


def verify_proofs(proofs: Sequence[PartialDecryptionZKP], *,
                  device="cuda") -> List[bool]:
    """Batched VerifyProof (thresholdkey.go:278-311) on ``device``.

    a = (c^4)^z * (c_i^2)^{-e}, b = V^z * (v_i)^{-e} mod n^2, then the
    batched SHA-256 recomputes the challenges.  Each negative exponent
    is one batched host inverse and a 256-bit ladder
    (t^{-e} = (t^{-1})^e): four B2 ladders in all.  All proofs must share
    one public key."""
    if not proofs:
        return []
    tpk = proofs[0].key
    dk = tpk.device(device)
    dev = dk.device
    L = dk.L
    n2 = tpk.n2

    c = encode_batch([p.c for p in proofs], 2 * L, device=dev)
    ci = encode_batch([p.decryption for p in proofs], 2 * L, device=dev)
    c2m = dk.mul(1, c, c)
    c4m = dk.mul(1, c2m, c2m)
    ci2m = dk.mul(1, ci, ci)
    c4_full, ci2_full = _unreduced_powers(c, ci, L)

    zs = [p.z for p in proofs]
    es = [p.e for p in proofs]
    z_limbs = host.limbs_for_bits(max(z.bit_length() for z in zs))
    z_digits = mont.limbs_to_digits(encode_batch(zs, z_limbs, device=dev),
                                    B2_WINDOW)
    e_digits = mont.limbs_to_digits(
        encode_batch(es, E_BITS // host.LIMB_BITS, device=dev), B2_WINDOW)

    ci2_inv = encode_batch(host.modinv_batch(decode_batch(ci2m), n2), 2 * L,
                           device=dev)
    vi_inv = encode_batch(host.modinv_batch(
        [tpk.vi[p.id - 1] for p in proofs], n2), 2 * L, device=dev)

    a = dk.mul(1, dk.pow(1, c4m, z_digits, B2_WINDOW),
               dk.pow(1, ci2_inv, e_digits, B2_WINDOW))
    b = dk.mul(1, dk.pow(1, _v_rows(tpk, c4m), z_digits, B2_WINDOW),
               dk.pow(1, vi_inv, e_digits, B2_WINDOW))
    got = _zkp_challenges(a, b, c4_full, ci2_full)
    return [g == e for g, e in zip(got, es)]


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
    proofs = partial_decrypt_with_zkp(tsk, ct, rng)
    if not all(verify_proofs(proofs, device=device)):
        raise ValueError("Invalid share")


def combine_with_zkp(tpk: ThresholdPublicKey,
                     proofs_per_server: Sequence[
                         Sequence[PartialDecryptionZKP]], *,
                     device="cuda") -> List[int]:
    """CombinePartialDecryptionsZKP (thresholdkey.go:164-172): drop each
    server whose proofs do not all verify (:func:`verify_proofs` on
    ``device``), then combine the rest."""
    L = tpk.device(device).L
    valid = []
    for proofs in proofs_per_server:
        if all(verify_proofs(proofs, device=device)):
            valid.append(PartialDecryptionBatch(
                id=proofs[0].id,
                c=encode_batch([p.decryption for p in proofs], 2 * L,
                               device=device)))
    return combine(tpk, valid)


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
