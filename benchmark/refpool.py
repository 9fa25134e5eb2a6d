"""Run the reference's tasks on the host's cores, after the window.

A pool of spawned processes that import only the reference (pure Python
integers), started once the window has closed and shut down before the
result is printed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

# below this many tasks a pool's start-up costs more than it saves
_SERIAL_BELOW = 8
# processes at most (None: every core the process may use, up to 32)
WORKERS = None


def run(fn, args: list) -> list:
    """[fn(*a) for a in args], spread over ``WORKERS`` processes."""
    if len(args) < _SERIAL_BELOW:
        return [fn(*a) for a in args]
    n = WORKERS or min(32, len(os.sched_getaffinity(0)))
    n = max(1, min(n, len(args)))
    if n == 1:
        return [fn(*a) for a in args]
    with ProcessPoolExecutor(max_workers=n,
                             mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_call, [(fn, a) for a in args],
                           chunksize=max(1, len(args) // (4 * n))))


def _call(item):
    fn, a = item
    return fn(*a)
