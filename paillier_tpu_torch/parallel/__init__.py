"""Multi-device sharding on ``torch.distributed``: the device mesh
(:mod:`.mesh`) and the two collectives that cross devices (:mod:`.collective`).
The port of ``paillier_tpu.parallel``; DDLEQ's sharded stages take the
same mesh (``zk.ddleq.prove(..., mesh=)``).

    # every rank, after torch.distributed.init_process_group (or torchrun)
    from paillier_tpu_torch import Ciphertext
    from paillier_tpu_torch.parallel import (make_mesh, shard_batch,
                                             sharded_aggregate)
    mesh = make_mesh()                           # 1-D over every rank
    local = Ciphertext(c=shard_batch(ct.c, mesh))
    total = sharded_aggregate(pk, local, mesh)   # the same on every rank
"""

from .collective import distributed_combine, sharded_aggregate
from .mesh import BATCH_AXIS, SERVER_AXIS, make_mesh, shard_batch

__all__ = ["distributed_combine", "sharded_aggregate", "BATCH_AXIS",
           "SERVER_AXIS", "make_mesh", "shard_batch"]
