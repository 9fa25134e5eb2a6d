"""Device mesh and sharding helpers on ``torch.distributed``.

The parallelism model is the JAX package's (``paillier_tpu.parallel.mesh``):

* batch axis  -> data parallelism: ciphertexts shard across devices; every
  ladder is elementwise over the batch, so encryption, decryption and the
  homomorphic ops need no collective at all.
* server axis -> threshold decryption servers: the Lagrange-weighted
  shares combine by a modular product gathered over the server axis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the caller's process group, one device a rank: started by ``torchrun``
(env://), by an explicit ``init_process_group``, or on one host by
:func:`.launch.run_ranks` (the driver entry points' spawner).  Every
rank holds its own tensors, so where the JAX package places one global
array on the mesh, a rank here holds its block of it
(:func:`shard_batch`); the JAX module's ``batch_sharding`` and
``replicated`` (its shardings of such an array) have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import get_config

BATCH_AXIS = "batch"
SERVER_AXIS = "servers"


def make_mesh(n_devices: Optional[int] = None, *,
              servers: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D ``("batch",)`` mesh, or 2-D ``("servers", "batch")`` mesh when
    ``servers`` > 1, over the first ``n_devices`` ranks of the caller's
    process group.

    Defaults resolve through the port's Config (mesh_devices /
    mesh_servers), then to the world size on a 1-D batch axis.  Every
    rank of the process group calls it, with the same arguments (it
    creates the groups of each axis).  ``device_type`` is the mesh's
    device type ("cpu" for ranks that compute on the CPU)."""
    cfg = get_config()
    servers = servers if servers is not None else (cfg.mesh_servers or 1)
    n = n_devices or cfg.mesh_devices or _world_size()
    if servers > 1 and n % servers:
        raise ValueError(f"{n} devices not divisible into {servers} "
                         "server groups")
    if n > _world_size():
        raise ValueError(f"{n} devices asked for, the process group has "
                         f"{_world_size()} ranks")
    if servers > 1:
        return init_device_mesh(device_type, (servers, n // servers),
                                mesh_dim_names=(SERVER_AXIS, BATCH_AXIS))
    return init_device_mesh(device_type, (n,), mesh_dim_names=(BATCH_AXIS,))


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the caller's process group: "
                           "start the ranks with torchrun or call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def axis(mesh: DeviceMesh, name: str) -> tuple:
    """(size, this rank's index) of the mesh axis ``name``."""
    return (mesh.shape[mesh.mesh_dim_names.index(name)],
            mesh.get_local_rank(name))


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of axis 0 of ``x``: the contiguous block that the
    JAX package's ``NamedSharding(mesh, P("batch", None))`` gives the
    device at this rank's place (block i of the batch axis's size, the
    same block on every server row).  Raises ValueError when the batch
    does not divide."""
    size, i = axis(mesh, BATCH_AXIS)
    B = x.shape[0]
    if B % size:
        raise ValueError(f"batch {B} does not divide the mesh's {size} "
                         "batch shards")
    blk = B // size
    return x[i * blk:(i + 1) * blk]
