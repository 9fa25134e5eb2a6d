"""Versioned, language-neutral serialization.

The reference serializes ciphertexts with Go's ``encoding/gob``
(paillier.go:374-401) — a Go-only format.  This format is a simple
self-describing binary layout instead (magic, version, level, method,
limb width, batch shape, little-endian uint32 limbs) plus JSON for key
material, so any language can read it.  It is the byte format of
``paillier_tpu.ops.serialize``: a ciphertext or key written by either
package loads in the other.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..core.keys import (ALTERNATIVE, MIXED, REGULAR, Ciphertext, PublicKey,
                         SecretKey)
from ..threshold.keys import ThresholdPublicKey, ThresholdSecretKey

_MAGIC = b"PTPU"
_VERSION = 1
_METHODS = {REGULAR: 0, ALTERNATIVE: 1, MIXED: 2}
_METHODS_REV = {v: k for k, v in _METHODS.items()}


def ciphertext_to_bytes(ct: Ciphertext) -> bytes:
    """Serialize a (batched) ciphertext (replaces Ciphertext.Bytes,
    paillier.go:393-401); the int64 limbs are written as uint32."""
    arr = ct.c.cpu().numpy()
    if arr.ndim == 1:
        arr = arr[None]
    header = struct.pack(
        "<4sBBBBII", _MAGIC, _VERSION, ct.level, _METHODS[ct.method],
        arr.ndim, arr.shape[0], arr.shape[-1])
    return header + arr.astype("<u4").tobytes()


def ciphertext_from_bytes(data: bytes, device="cuda") -> Ciphertext:
    """Deserialize onto ``device`` as int64 limbs (replaces
    NewCiphertextFromBytes, paillier.go:376-390)."""
    if len(data) == 0:
        raise ValueError("no data provided")
    if len(data) < 16 or data[:4] != _MAGIC:
        raise ValueError("not a paillier_tpu ciphertext")
    magic, ver, level, method, ndim, batch, limbs = struct.unpack(
        "<4sBBBBII", data[:16])
    if ver != _VERSION:
        raise ValueError(f"unsupported version {ver}")
    arr = np.frombuffer(data[16:], dtype="<u4").reshape(batch, limbs)
    return Ciphertext(c=torch.as_tensor(arr.astype(np.int64), device=device),
                      level=level, method=_METHODS_REV[method])


# ---------------------------------------------------------------------------
# Key material (JSON with hex ints — human-auditable, language-neutral)
# ---------------------------------------------------------------------------

def _enc(v: int) -> str:
    return hex(v)


def _dec(s: str) -> int:
    return int(s, 16)


def public_key_to_json(pk: PublicKey) -> str:
    d = {"kind": "public", "n": _enc(pk.n), "g": _enc(pk.g),
         "h": _enc(pk.h), "k": _enc(pk.k), "bits": pk.bits}
    if isinstance(pk, ThresholdPublicKey):
        d.update(kind="threshold_public", l=pk.l, t=pk.t, v=_enc(pk.v),
                 vi=[_enc(x) for x in pk.vi])
        if isinstance(pk, ThresholdSecretKey):
            d.update(kind="threshold_secret", id=pk.id, share=_enc(pk.share))
    elif isinstance(pk, SecretKey):
        d.update(kind="secret", lam=_enc(pk.lam), p=_enc(pk.p), q=_enc(pk.q))
    return json.dumps(d)


def key_from_json(s: str):
    d = json.loads(s)
    kind = d["kind"]
    base = dict(n=_dec(d["n"]), g=_dec(d["g"]), h=_dec(d["h"]),
                k=_dec(d["k"]), bits=d["bits"])
    if kind == "public":
        return PublicKey(**base)
    if kind == "secret":
        return SecretKey(**base, lam=_dec(d["lam"]), p=_dec(d["p"]),
                         q=_dec(d["q"]))
    if kind == "threshold_public":
        return ThresholdPublicKey(**base, l=d["l"], t=d["t"], v=_dec(d["v"]),
                                  vi=tuple(_dec(x) for x in d["vi"]))
    if kind == "threshold_secret":
        return ThresholdSecretKey(**base, l=d["l"], t=d["t"], v=_dec(d["v"]),
                                  vi=tuple(_dec(x) for x in d["vi"]),
                                  id=d["id"], share=_dec(d["share"]))
    raise ValueError(f"unknown key kind {kind!r}")
