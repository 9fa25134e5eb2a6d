"""Mesh scaling probe of the port (the counterpart of the repo's
``scripts/scaling_probe.py``).

Times the two collective seams at a FIXED total workload on n ranks:

  * sharded_aggregate   -- 512 level-1 ciphertexts of a 128-bit key,
                           one all-gather of one row a rank;
  * distributed_combine -- 64 ciphertexts of a (4, 3)-threshold 64-bit
                           key on a (servers x batch) mesh of min(4, n)
                           server rows.

Each time is the least of 10 calls after a warm-up, each call ending in
``torch.cuda.synchronize()`` on a card; the line reports the slowest
rank's.  Ranks that share one card (gloo) or the CPU time the seams'
overhead at n ranks, not a speed-up; NCCL ranks on n cards time the
real scaling.

    python -m paillier_tpu_torch.scaling_probe <n_devices> [--device cpu]

prints one JSON line: {"n_devices": n, "t_aggregate_s": .., "t_combine_s":
..}.  The ranks are spawned as in :mod:`paillier_tpu_torch.dryrun`.
"""

from __future__ import annotations

import argparse
import json
import random
import tempfile
import time

import torch
from torch.distributed.device_mesh import init_device_mesh

B = 512                                  # fixed total work
ITERS = 10


def _timeit(fn, dev, iters: int = ITERS) -> float:
    """Least of ``iters`` timed calls after one warm-up; each call ends
    when the card is idle."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def probe_rank(rank: int, world: int, device: str) -> dict:
    """A rank's body: the two seams' least times on this rank."""
    from .core.encrypt import Encryptor
    from .core.keygen import keygen
    from .core.keys import LEVEL_ONE, Ciphertext
    from .parallel.collective import distributed_combine, sharded_aggregate
    from .parallel.launch import rank_device
    from .parallel.mesh import (BATCH_AXIS, SERVER_AXIS, axis, make_mesh,
                                shard_batch)
    from .threshold.decrypt import (compute_lambda, lagrange_powers,
                                    partial_decrypt_all)
    from .threshold.keygen import generate_threshold_keys

    dev = rank_device(device)
    rng = random.Random(0x5CA1E)

    # --- aggregate seam (128-bit key) ---
    sk, pk = keygen(128, rng, device=dev)
    enc = Encryptor(pk, LEVEL_ONE, rng=rng, device=dev)
    ct = enc.encrypt([rng.randrange(pk.n) for _ in range(B)])
    mesh = make_mesh(world, device_type=dev.type)
    ct_sh = Ciphertext(c=shard_batch(ct.c, mesh), level=LEVEL_ONE)
    t_agg = _timeit(lambda: sharded_aggregate(pk, ct_sh, mesh), dev)

    # --- threshold combine seam (4 servers x batch) ---
    keys = generate_threshold_keys(64, 4, 3, rng, device=dev)
    tpk = keys[0].public()
    enc_t = Encryptor(tpk, LEVEL_ONE, rng=rng, device=dev)
    ct_t = enc_t.encrypt([rng.randrange(tpk.n) for _ in range(64)])
    ids = [k.id for k in keys]
    lam2 = [2 * compute_lambda(tpk, k.id, ids) for k in keys]
    signs = [1 if v >= 0 else -1 for v in lam2]
    # (servers x batch) with min(4, n) server rows, a 1-row mesh included
    srv = min(4, world)
    mesh2 = init_device_mesh(dev.type, (srv, world // srv),
                             mesh_dim_names=(SERVER_AXIS, BATCH_AXIS))
    rows, row = axis(mesh2, SERVER_AXIS)
    mine = slice(row * (4 // rows), (row + 1) * (4 // rows))
    pds = partial_decrypt_all(keys[mine],
                              Ciphertext(c=shard_batch(ct_t.c, mesh2)))
    powed = lagrange_powers(tpk, torch.stack([p.c for p in pds]),
                            [abs(v) for v in lam2[mine]])
    t_comb = _timeit(lambda: distributed_combine(tpk, powed, signs, mesh2),
                     dev)
    return {"t_aggregate_s": t_agg, "t_combine_s": t_comb}


def run(n_devices: int, device: str = "cuda", timeout: float = 600.0
        ) -> dict:
    """Spawn ``n_devices`` ranks of :func:`probe_rank`; the JSON line's
    fields, each the slowest rank's time."""
    from .parallel.launch import plan, run_ranks
    backend = plan(n_devices, device)
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(probe_rank, n_devices, device, init_dir=tmp,
                         timeout=timeout, backend=backend)
    return record(outs)


def record(outs: list) -> dict:
    """The JSON line's fields from every rank's :func:`probe_rank`."""
    return {"n_devices": len(outs),
            "t_aggregate_s": max(o["t_aggregate_s"] for o in outs),
            "t_combine_s": max(o["t_combine_s"] for o in outs)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m paillier_tpu_torch.scaling_probe",
        description="time the two collective seams on n spawned ranks")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n_devices, args.device)))


if __name__ == "__main__":
    main()
