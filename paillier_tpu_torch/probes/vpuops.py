"""Probe P5: what one pass of each elementwise op class costs.

Replaces ``scripts/perf_vpuops.py:mk`` (its ``pl.pallas_call`` at :78):
``reps`` repetitions of one op on x int32 [B, 320] with f f32 [B, 320]
(the ops of :data:`OPS`).  On the H100 (``csrc/probe_vpuops.cu``) a block
of 640 threads holds 32 rows in registers, one instantiation an op, each
repetition fenced so that the compiler cannot fold the chain (f, where an
op reads it, through an XOR with a run-time zero: one LOP3 a value).

The script draws f with ``rng.random``; here f lies on a 1/256 grid in
[0, 100), so that lanesum's row sums (at most 32,000, 23 bits) are exact
in any order of summation and the kernel equals the plain version and
the JAX kernel bit for bit.  x is the script's draw times 4 plus 7, so
that the reductions see values above their modulus.
"""

from __future__ import annotations

import numpy as np
import torch

from . import CI, K, VP, Kernel, check, on_cuda, stream

SCRIPT = "scripts/perf_vpuops.py:23"     # mk
B = 4096
REPS = 2000
ROWS = 32           # rows of a block (csrc/probe_vpuops.cu ROWS)
# op class: the fewest instructions a value and pass that the op's
# function needs, whatever the kernel's layout (not the kernel's fence on
# f, nor lanesum's shuffles): castf, floor an F2I and an add; fmul an FMUL
# more; lanesum a float add a value for the row sum and the add to x (and
# one F2I a row, added in ops()); red I2F, FMUL, F2I, IMAD and one add-min
# (VIADDMNMX) for each of its two corrections
OPS = {"add": 1, "mul": 1, "mulvar": 3, "shift": 2, "where": 2, "castf": 2,
       "fmul": 3, "floor": 2, "lanesum": 2, "red": 6, "redfast": 5,
       "redlazy": 4}
_C = 6.1e-5         # the script's constant, rounded to f32 where it is used

KERNEL = Kernel("vpuops", {"vpuops_launch": [VP, VP, VP, CI, CI, CI, VP]})

# opcodes that each op's loop must hold at least once for each of the 16
# values a thread holds (sm_90 SASS; VIADD is Hopper's integer add)
_LOOP_OPS = {
    "add": [r"IADD3|VIADD"], "mul": [r"IMAD"], "mulvar": [r"IMAD", r"LOP3"],
    "shift": [r"SHF|IMAD\.SHL|LEA|LOP3"],
    "where": [r"SEL|ISETP|IMNMX|VIMNMX|VIADDMNMX|VIADD"],
    "castf": [r"F2I"], "fmul": [r"FMUL", r"F2I"], "floor": [r"F2I"],
    "lanesum": [r"SHFL"], "red": [r"I2F", r"F2I"], "redfast": [r"I2F", r"F2I"],
    "redlazy": [r"I2F", r"F2I"]}
SASS_EXPECT = {rf"vpu_kernelILi{i}E": [(p, ROWS * K // 640) for p in pats]
               for i, pats in enumerate(_LOOP_OPS.values())}


def inputs(rows: int = B, seed: int = 0, device="cpu") -> tuple:
    """(x, f): x int32 = 4 d + 7 for the script's draws d in [0, 16000),
    so that x reaches 64,000 and the reductions (the identity below
    16,383) move too; f f32 on a 1/256 grid in [0, 100)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16000, (rows, K), dtype=np.int32) * 4 + 7
    f = (rng.integers(0, 25600, (rows, K)) / 256).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(f, device=device))


def _apply(op: str, x, f):
    c = torch.tensor(_C, dtype=torch.float32, device=x.device)
    if op == "add":
        return x + 12345
    if op == "mul":
        return x * 12347
    if op == "mulvar":
        return (x * (x | 1)) & 0x3FFF
    if op == "shift":
        return (x << 7) & 0xFFFF
    if op == "where":
        return torch.where(x > 8192, x - 8192, x)
    if op == "castf":
        return x + f.to(torch.int32)
    if op == "fmul":
        return x + (f * 1.5).to(torch.int32)
    if op == "floor":
        return x + torch.floor(f).to(torch.int32)
    if op == "lanesum":
        return x + f.sum(dim=-1, keepdim=True).to(torch.int32)
    if op == "redfast":
        q = ((x - 420).float() * c).to(torch.int32)
        return x - q * 16383
    q = torch.floor(x.float() * c).to(torch.int32)
    r = x - q * 16383
    if op == "redlazy":
        return r
    r = torch.where(r < 0, r + 16383, r)
    return torch.where(r >= 16383, r - 16383, r)


def vpuops_plain(x, f, reps: int, op: str) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"op must be one of {tuple(OPS)}, got {op!r}")
    for _ in range(reps):
        x = _apply(op, x, f)
    return x


def vpuops(x, f, reps: int, op: str) -> torch.Tensor:
    """``reps`` passes of ``op`` on x int32 [B, 320], f f32 [B, 320].  A
    CPU tensor runs :func:`vpuops_plain`; a CUDA tensor launches the op's
    kernel and adds one to ``vpuops.launches``."""
    if not on_cuda(x, "P5"):
        return vpuops_plain(x, f, reps, op)
    if op not in OPS:
        raise ValueError(f"op must be one of {tuple(OPS)}, got {op!r}")
    x = check(x, "x", torch.int32, (None, K))
    f = check(f, "f", torch.float32, tuple(x.shape))
    out = torch.empty_like(x)
    KERNEL.launch("vpuops_launch", x.device, x.data_ptr(), f.data_ptr(),
                  out.data_ptr(), x.shape[0], reps, list(OPS).index(op),
                  stream(x))
    vpuops.launches += 1
    return out


vpuops.launches = 0


def ops(rows: int, reps: int, op: str) -> int:
    """Instructions of ``reps`` passes (at least)."""
    per_row = K * OPS[op] + (op == "lanesum")
    return rows * reps * per_row
