"""Kernel B4: the limb-domain Montgomery ladder (shared or per-row moduli
and exponents) on the GPU.

Replaces ``paillier_tpu/bigint/pallas_kernels.py:_modexp_kernel``
(wrapper ``mont_pow_pallas``).  The kernel is hand-written CUDA C++ in
``paillier_tpu_torch/csrc/limb_modexp.cu`` (its header note gives the
layout, a group of lanes per row, and what bounds it); :mod:`cuda_build`
builds it with ``nvcc`` for ``sm_90a`` at first use and binds its plain C
entry point with ``ctypes``; it launches on PyTorch's current stream.
The launch shape (lanes per row, rows per block) is chosen here, by
:func:`lanes_per_row` and :func:`rows_per_block`.

:func:`mont_pow_b4` takes a CPU tensor to the plain version,
:func:`mont_pow_digits_plain` (re-exported here from :mod:`montgomery`),
and a CUDA tensor to the kernel.  There is no fallback: a CUDA tensor
that the kernel does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .host import limbs_to_ints
from .modexp_kernel import _check_digits
from .montgomery import MontCtx, mont_ctx_arrays, mont_pow_digits_plain

__all__ = ["mont_pow_b4", "mont_pow_digits_plain", "load", "MAX_LIMBS"]

SOURCE = cuda_build.CSRC / "limb_modexp.cu"
MAX_LIMBS = 256                  # 4096-bit moduli (n^2 of 2048-bit keys)
SMEM_MAX = 232448                # shared memory a block may use (227 KB)
WORDS_PER_LANE = (1, 2, 3, 4, 8)  # the cases of limb_modexp_launch
BLOCK_THREADS = 128              # threads of a block (rows x lanes)
WARPS_PER_SM = 6                 # warps a batch should give each SM

_lib = None
build_log = ""       # nvcc / ptxas output of the build this process made


def load():
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.limb_modexp_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, vp,
                                       ci, ci, ci, ci, ci, vp]
    lib.limb_modexp_launch.restype = ci
    lib.limb_modexp_row_bytes.argtypes = [ci, ci]
    lib.limb_modexp_row_bytes.restype = ci
    _lib = lib
    return lib


def lanes_per_row(nw: int, rows: int, sms: int) -> int:
    """Lanes of a warp that serve each of ``rows`` rows of ``nw`` 32-bit
    words on a device with ``sms`` SMs: the fewest (a power of two from 4
    to 32, at most nw, giving a number of words a lane the kernel takes)
    whose rows make :data:`WARPS_PER_SM` warps on every SM, else the
    most.  Fewer lanes a row cost fewer shuffles; more hide the latency
    of a word step when rows are few.  Every lane count was timed on an
    H100 (132 SMs; PERF.md §6) at L = 128 on 512 to 8192 rows, at L = 256
    on 256 to 4096 and at L = 64 on 64 and 256 per-row moduli: the
    fastest count fell to the next fewer lanes where those reach between
    5.8 and 6.8 warps an SM (at L = 256 between 3.9 and 7.8)."""
    lanes = [t for t in (4, 8, 16, 32) if (t <= nw or t == 4)
             and padded_words(nw, t) // t in WORDS_PER_LANE]
    for t in lanes:
        if rows * t >= WARPS_PER_SM * 32 * sms:
            return t
    return lanes[-1]


def padded_words(nw: int, tpi: int) -> int:
    """Words of a row as the kernel holds it: nw rounded up to a multiple
    of ``tpi`` (the extra words are zero, and R grows with them)."""
    return -(-nw // tpi) * tpi


def rows_per_block(row_bytes: int, max_rows: int) -> int:
    """Rows of one block: as many as shared memory holds, at most
    ``max_rows``; raises when not even one row fits."""
    rb = min(max_rows, SMEM_MAX // row_bytes)
    if rb < 1:
        raise ValueError(f"one row needs {row_bytes} B of shared memory, "
                         f"more than {SMEM_MAX}: lower the window")
    return rb


def _kernel_ctx(ctx: MontCtx, n_words: int | None = None) -> tuple:
    """(n, n0, r2, L') as the kernel takes them: int32 16-bit limbs of n
    and R^2 mod n, and the low 32 bits of -n^-1 mod R, each shared ([L'],
    [1]) or per row ([B, L'], [B]), with L' = 2 ``n_words`` limbs
    (default: L rounded up to even).  Where L' > L, n is padded with zero
    limbs and the constants are rebuilt on the host for R = 2^(16 L')."""
    n, nprime, r2 = ctx.n, ctx.nprime, ctx.r2
    L = 2 * (n_words or -(-ctx.n_limbs // 2))
    if L != ctx.n_limbs:
        mods = limbs_to_ints(n.reshape(-1, n.shape[-1]).cpu().numpy())
        arrs = [mont_ctx_arrays(m, L) for m in mods]
        n, nprime, r2 = (torch.as_tensor(
            np.stack([a[f] for a in arrs]).astype(np.int64),
            device=ctx.device).reshape(ctx.n.shape[:-1] + (L,))
            for f in range(3))
    n0 = nprime[..., 0] | (nprime[..., 1] << 16)
    n0 = torch.where(n0 >= 1 << 31, n0 - (1 << 32), n0)   # as int32 bits
    return (n.to(torch.int32).contiguous(),
            n0.to(torch.int32).reshape(-1).contiguous(),
            r2.to(torch.int32).contiguous(), L)


def check_width(ctx: MontCtx) -> None:
    """Raise ValueError, naming the modulus bits, where the kernel cannot
    take ``ctx``'s width (more than :data:`MAX_LIMBS` limbs)."""
    L = ctx.n_limbs
    if L > MAX_LIMBS:
        bits = max(v.bit_length() for v in limbs_to_ints(
            ctx.n.reshape(-1, L).cpu().numpy()))
        raise ValueError(
            f"kernel B4 takes moduli of at most {16 * MAX_LIMBS} bits "
            f"({MAX_LIMBS} limbs), got a {bits}-bit modulus in {L} limbs")


def mont_pow_b4(ctx: MontCtx, base: torch.Tensor, digits,
                window: int = 4) -> torch.Tensor:
    """base^e mod n by the fixed-window Montgomery ladder.

    base: limbs [B, L] (or [L]) < R; digits: int [D] shared or [B, D] per
    row, MSB-first base-2^window; ctx fields [L] shared or [B, L] per row.
    Returns the canonical base^e mod n as int64 limbs [B, L], equal to
    :func:`mont_pow_digits_plain`.  The kernel runs :func:`lanes_per_row`
    lanes a row (by the batch and the device's SMs), in blocks of
    :data:`BLOCK_THREADS` threads (fewer rows where shared memory does
    not hold them).  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel and adds one to
    ``mont_pow_b4.launches``.
    """
    if base.device.type == "cpu":
        return mont_pow_digits_plain(ctx, base, digits, window)
    if base.device.type != "cuda":
        raise ValueError(f"kernel B4 runs on CUDA tensors, got {base.device}")
    squeeze = base.dim() == 1
    if squeeze:
        base = base[None]
    L = ctx.n_limbs
    if base.dim() != 2 or base.shape[-1] != L:
        raise ValueError(f"base must be limbs [B, {L}], got "
                         f"{tuple(base.shape)}")
    check_width(ctx)
    B = base.shape[0]
    per_row_ctx = ctx.n.dim() == 2
    if per_row_ctx and ctx.n.shape[0] != B:
        raise ValueError(f"per-row context has {ctx.n.shape[0]} rows, base "
                         f"has {B}")
    for name, f in ctx._asdict().items():
        if f.device != base.device:
            raise ValueError(f"context {name} on {f.device}, base on "
                             f"{base.device}")
    if not 1 <= window <= 8:
        raise ValueError(f"window {window} outside 1..8")
    digits = torch.as_tensor(digits, device=base.device)
    _check_digits(digits, B, window)
    digits = digits.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(base.device).multi_processor_count
    out = launch(ctx, base, digits, window,
                 lanes_per_row(-(-L // 2), B, sms))
    return out[0] if squeeze else out


def launch(ctx: MontCtx, base: torch.Tensor, digits: torch.Tensor,
           window: int, tpi: int) -> torch.Tensor:
    """Kernel B4 on checked CUDA operands (base limbs [B, L], int32
    digits) with ``tpi`` lanes a row, in blocks of :data:`BLOCK_THREADS`
    threads (fewer rows where shared memory does not hold them); adds one
    to ``mont_pow_b4.launches``.  :func:`mont_pow_b4` picks ``tpi``; the
    tests take every other value the kernel takes."""
    B, L = base.shape
    nw = padded_words(-(-L // 2), tpi)
    if nw // tpi not in WORDS_PER_LANE:
        raise ValueError(f"{tpi} lanes a row give {nw // tpi} words a lane; "
                         f"the kernel takes {WORDS_PER_LANE}")
    n, n0, r2, Lk = _kernel_ctx(ctx, nw)
    x = torch.nn.functional.pad(base.to(torch.int32), (0, Lk - L)
                                ).contiguous()
    lib = load()
    rb = rows_per_block(lib.limb_modexp_row_bytes(nw, window),
                        BLOCK_THREADS // tpi)
    out = torch.empty((B, Lk), dtype=torch.int32, device=base.device)
    stream = torch.cuda.current_stream(base.device).cuda_stream
    with torch.cuda.device(base.device):
        err = lib.limb_modexp_launch(
            x.data_ptr(), digits.data_ptr(), digits.shape[-1],
            int(digits.dim() == 2), n.data_ptr(), n0.data_ptr(),
            r2.data_ptr(), int(ctx.n.dim() == 2), out.data_ptr(), B, nw,
            window, tpi, rb, stream)
    if err:
        raise RuntimeError(f"kernel B4 launch failed: cudaError {err}")
    cuda_build.count_launch(mont_pow_b4)
    return out[:, :L].to(torch.int64)


mont_pow_b4.launches = 0
