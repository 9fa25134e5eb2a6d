"""Probes P1-P5: the JAX package's v5e probe kernels as H100 probes.

Each module is the counterpart of one script of ``scripts/perf_*.py``
(whose Pallas kernels ran on the TPU) and holds a plain PyTorch version
of the script's kernel beside a wrapper of a hand-written CUDA kernel
(``paillier_tpu_torch/csrc/probe_*.cu``, built for ``sm_90a`` by
:mod:`paillier_tpu_torch.bigint.cuda_build` at first use):

  P1 :mod:`.dotvar`    product layouts of a Montgomery multiply's extensions
  P2 :mod:`.dotchain`  latency of a dependent tensor-core product chain
  P3 :mod:`.overlap`   do products and elementwise reductions overlap
  P4 :mod:`.pad`       L2 read rate of the matrices; a column permutation
  P5 :mod:`.vpuops`    one pass of each elementwise op class

The products of P1-P4 are kernel B1's own fragment code
(``csrc/rns2_mont_mma.cuh``, shared through ``csrc/probes.cuh``), so the
probes measure B1's multiply.  A wrapper takes a CPU tensor to the plain
version and a CUDA tensor to its kernel (it never falls back), adding one
to its ``launches`` where it launches.  ``python -m
paillier_tpu_torch.probes`` runs them at the scripts' shapes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..bigint import cuda_build

K = 320            # channels a half: kernel B1's k at 2048-bit keys
D = 2 * K          # int8 digits a row, the products' contraction depth
TILES = (8, 16, 32)

INT8_OPS = 1.979e15     # H100 SXM dense int8 tensor-core op/s (700 W)
HBM = 3.35e12           # H100 SXM device-memory bytes/s
CLOCK = 1.98e9          # H100 SXM boost clock, Hz
ISSUE_LANES = 128       # an SM issues 4 warp instructions a clock


def issue_rate(device) -> float:
    """Thread instructions a second that the card can issue at most: SMs
    x 128 lanes x the clock.  The elementwise probes' bounds count the
    fewest instructions their op needs a value at this rate (not the
    64 INT32 lanes of an SM: the compiler fuses some of the JAX kernels'
    ops, and some run on the 128 FP32 lanes).  For a CPU device: an
    H100 SXM's 132 SMs."""
    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)
    return sms * ISSUE_LANES * CLOCK


def chain_draws(rng: np.random.Generator, rows: int) -> tuple:
    """x int8 [rows, 640], mlo and mhi int8 [640, 320], in [0, 100), drawn
    in the order the scripts of P1-P3 draw them."""
    return (rng.integers(0, 100, (rows, D), dtype=np.int8),
            rng.integers(0, 100, (D, K), dtype=np.int8),
            rng.integers(0, 100, (D, K), dtype=np.int8))


def on_cuda(t: torch.Tensor, probe: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"probe {probe} runs on CUDA tensors, got {t.device}")
    return True


def check(t: torch.Tensor, name: str, dtype, shape) -> torch.Tensor:
    """t as a contiguous tensor, or ValueError unless it has ``dtype`` and
    ``shape`` (None: any size)."""
    if t.dtype != dtype or t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")
    return t.contiguous()


def tile_rows(B: int) -> int:
    """The tile kernel B1's rule (``rns2_sliding_rows``) picks for B rows
    at k = 320 on the current device."""
    from ..bigint import sliding_kernel
    rows = sliding_kernel.load().rns2_sliding_rows(B, K)
    if rows <= 0:
        raise RuntimeError(f"kernel B1's tile rule failed: cudaError {-rows}")
    return rows


def pick_tile(rows, B: int) -> int:
    rows = tile_rows(B) if rows is None else rows
    if rows not in TILES:
        raise ValueError(f"tile rows must be one of {TILES}, got {rows}")
    return rows


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sass_faults(code: str, expect: dict) -> list[str]:
    """Check ``cuobjdump -sass`` output against ``expect``: for each
    function-name pattern, a list of (opcode pattern, least count) or
    (opcode pattern, least, most) that the instructions inside the
    function's loops must meet (so an op the compiler hoisted or folded
    out of its loop shows).  Returns what failed; every pattern must
    match a function."""
    import re
    loops = cuda_build.sass_loop_ops(code)
    faults = []
    for fpat, wants in expect.items():
        names = [n for n in loops if re.search(fpat, n)]
        if not names:
            faults.append(f"no function matches {fpat}")
        for n in names:
            for opat, least, *most in wants:
                got = sum(bool(re.match(opat, op)) for op in loops[n])
                if got < least or (most and got > most[0]):
                    want = f"{least}..{most[0]}" if most else f">= {least}"
                    faults.append(f"{n}: {got} {opat} in its loops, want "
                                  f"{want}")
    return faults


class Kernel:
    """A probe's CUDA library, ``csrc/probe_<name>.cu``: built at first
    :meth:`load` (once per source hash), its C entry points bound with
    ctypes (each returns a cudaError_t)."""

    def __init__(self, name: str, argtypes: dict):
        self.source = cuda_build.CSRC / f"probe_{name}.cu"
        self._argtypes = argtypes
        self._lib = None
        self.build_log = ""          # nvcc / ptxas output of this build

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_log = cuda_build.build(self.source)
            for fn, args in self._argtypes.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, device, *args) -> None:
        lib = self.load()
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args)
        if err:
            raise RuntimeError(f"{fn} failed: cudaError {err}")


VP, CI = ctypes.c_void_p, ctypes.c_int
