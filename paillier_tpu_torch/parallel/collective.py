"""Distributed homomorphic reductions: collectives in the multiplicative
group Z*_{n^s+1}, on ``torch.distributed``.

The two seams where the port crosses devices, as in the JAX package's
``paillier_tpu.parallel.collective``:

* :func:`sharded_aggregate`: the 1M-ciphertext homomorphic sum (BASELINE
  config #3).  Each rank tree-reduces its local ciphertexts into one
  modular product, one ``[Ltot]`` limb row per rank is gathered over the
  batch axis, and a tree over those rows finishes.  Communication is
  O(ranks * limbs), independent of the batch size.
* :func:`distributed_combine`: threshold share combining (the reference's
  CombinePartialDecryptions, thresholdkey.go:149-161) where each mesh row
  holds some decryption servers' Lagrange-weighted shares.  The positive
  and negative products gather over the server axis, then the batch
  axis; the one modular inverse stays on the host.

Each rank passes its own block (the JAX functions take one array sharded
over the mesh) and every rank returns the whole result.  Every product is
canonical, so the results are the same integers as the single-device
``aggregate`` and ``combine``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..bigint import host
from ..core.homomorphic import aggregate
from ..core.keys import Ciphertext, PublicKey, decode_batch, encode_batch
from ..ops.profiling import spanned
from ..threshold.decrypt import _combine_products, _combine_tail
from ..threshold.keys import ThresholdPublicKey
from .mesh import BATCH_AXIS, SERVER_AXIS, axis


@spanned("gather")
def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[ranks of ``group``, *t.shape]: every rank's ``t``, in group-rank
    order, on ``t``'s device.  Every rank passes the same shape and dtype.
    NCCL gathers the device tensors themselves; any other backend (gloo)
    gathers host copies, which are moved back to ``t``'s device.  Bool
    tensors travel as uint8."""
    stage = t.device.type != "cpu" and "nccl" not in str(
        dist.get_backend(group))
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = (src.cpu() if stage else src).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    res = torch.stack(out).to(t.device)
    return res.bool() if t.dtype == torch.bool else res


def sharded_aggregate(pk: PublicKey, ct_local: Ciphertext, mesh
                      ) -> Ciphertext:
    """Homomorphic sum of a batch sharded over the mesh's batch axis:
    ``ct_local`` is this rank's block (any number of rows).  Every rank
    returns the product of the whole batch, the same integer as
    ``aggregate`` of the whole batch on one device.

    Both trees are :func:`..core.homomorphic.aggregate`'s, each with its
    own canonical exit, so the JAX function's bookkeeping of the limb
    Montgomery R-deficit across the two trees has no counterpart."""
    local = aggregate(pk, ct_local, axis=0)                   # [Ltot]
    rows = _all_gather(local.c, mesh.get_group(BATCH_AXIS))   # [ranks, Ltot]
    return aggregate(pk, Ciphertext(c=rows, level=ct_local.level), axis=0)


def distributed_combine(tpk: ThresholdPublicKey,
                        server_powed_local: torch.Tensor,
                        signs: Sequence[int], mesh) -> List[int]:
    """Threshold combining across a ("servers", "batch") mesh.

    ``server_powed_local``: int64 limbs [S / rows, B / cols, 2L], this
    rank's block of the servers' c_s^(|2 lambda_s|) mod n^2
    (:func:`..threshold.decrypt.lagrange_powers`), server rows in the
    order of the global server index; ``signs``: +1 / -1 per server
    (all S) for the sign of its Lagrange weight.  Each rank multiplies
    its block's positive and negative shares, gathers both products over
    the server axis and multiplies again, gathers over the batch axis,
    then finishes on its own: one host batch inverse of the negative
    product, the L function and the constant (4 delta^2)^-1.  Every rank
    returns the plaintexts of the whole batch."""
    dk = tpk.device(server_powed_local.device)
    s_local = server_powed_local.shape[0]
    _, row = axis(mesh, SERVER_AXIS)
    mine = signs[row * s_local:(row + 1) * s_local]
    sel = torch.tensor([s > 0 for s in mine],
                       device=server_powed_local.device)[:, None, None]
    pos, neg = _combine_products(dk, server_powed_local, sel)  # [B_l, 2L]
    g = _all_gather(torch.stack([pos, neg]),
                    mesh.get_group(SERVER_AXIS))              # [rows, 2, B_l, 2L]
    rows = g.shape[0]
    sel = (torch.arange(2 * rows, device=g.device) < rows)[:, None, None]
    pos, neg = _combine_products(dk, g.transpose(0, 1).flatten(0, 1), sel)
    g = _all_gather(torch.stack([pos, neg]),
                    mesh.get_group(BATCH_AXIS))               # [cols, 2, B_l, 2L]
    pos, neg = g.transpose(0, 1).reshape(2, -1, g.shape[-1])  # [B, 2L] each
    neg_inv = encode_batch(host.modinv_batch(decode_batch(neg), tpk.n2),
                           g.shape[-1], device=g.device)
    return decode_batch(_combine_tail(dk, tpk, pos, neg_inv))
