"""Spawned ``torch.distributed`` ranks on one host.

    run_ranks(body, world, *args, init_dir=tmp, timeout=120, backend="gloo")

starts ``world`` processes (the ``spawn`` start method: CUDA cannot start
again in a forked child), each joining one process group through a file
in ``init_dir`` (gloo, or NCCL with card ``rank`` for rank ``rank``),
runs ``body(rank, world, *args)`` in each and returns their results in
rank order.  Any rank that raises or dies fails the call, and ranks still
running at ``timeout`` seconds are killed and fail it too.  ``body`` must
be importable by name (a module-level function) and its arguments and
results picklable (plain Python data, numpy arrays, CPU tensors).  Each
rank's spans (``ops.profiling.take()``, recorded where the rank ran a
``torch.profiler``) travel with its result and join this process's
record, tagged with the rank (``ops.profiling.merge``).

The driver entry points (:mod:`paillier_tpu_torch.dryrun`,
:mod:`paillier_tpu_torch.scaling_probe`) and the tests start their ranks
with it; a deployment across hosts starts them with ``torchrun``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops import profiling


def run_ranks(body, world: int, *args, init_dir, timeout: float = 120.0,
              backend: str = "gloo") -> list:
    ctx = mp.get_context("spawn")
    init = os.path.join(str(init_dir), f"rendezvous-{os.getpid()}-"
                        f"{time.monotonic_ns()}")
    results_q = ctx.Queue()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(body, rank, world, init, backend, args,
                               results_q))
             for rank in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(results)} of {world} ranks "
                                   f"still running after {timeout} s")
            try:
                rank, ok, value, record = results_q.get(
                    timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
            profiling.merge(rank, record)
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _rank(body, rank, world, init, backend, args, results_q):
    try:
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method="file://" + init,
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=300))
        out = body(rank, world, *args)
        dist.barrier()
        results_q.put((rank, True, out, profiling.take()))
    except BaseException:
        results_q.put((rank, False, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_device(device: str) -> torch.device:
    """A rank's device: the CPU for ``"cpu"``, else its current card (the
    card ``run_ranks`` set for an NCCL rank, card 0 for gloo ranks that
    share one)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def plan(world: int, device: str = "cuda") -> str:
    """The backend for ``world`` ranks on ``device``: gloo on the CPU;
    NCCL with one card a rank where the host has ``world`` cards, else
    gloo ranks sharing card 0.  Raises RuntimeError for ``"cuda"``
    without a card."""
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for CPU ranks")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"
