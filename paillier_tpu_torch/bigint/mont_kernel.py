"""Kernel B4: the limb-domain Montgomery ladder (shared or per-row moduli
and exponents) on the GPU, and B4w, its variant for moduli past 768 limbs.

Replaces ``paillier_tpu/bigint/pallas_kernels.py:_modexp_kernel``
(wrapper ``mont_pow_pallas``).  Both kernels are hand-written CUDA C++:
B4 in ``paillier_tpu_torch/csrc/limb_modexp.cu`` (a group of lanes per
row, the operands in registers), B4w in
``paillier_tpu_torch/csrc/limb_modexp_wide.cu`` (a thread block, or a
cluster of blocks, per row, running the three-product Montgomery
multiply of the TPU kernel; their header notes give the layouts and what
bounds them).  :mod:`cuda_build` builds each with ``nvcc`` for ``sm_90a``
at first use and binds its plain C entry point with ``ctypes``; they
launch on PyTorch's current stream.  The launch shapes are chosen here:
B4's lanes per row and rows per block by :func:`lanes_per_row` and
:func:`rows_per_block`, B4w's mode by :func:`wide_mode` and its warps,
cluster size by :func:`wide_shape`.

:func:`mont_pow_b4` takes a CPU tensor to the plain version,
:func:`mont_pow_digits_plain` (re-exported here from :mod:`montgomery`),
and a CUDA tensor to B4 or B4w (:func:`mont_pow_b4w`) as :func:`variant`
decides before the launch, by the modulus' width, the rows and the SMs:
B4w past :data:`REGISTER_MAX_LIMBS` limbs always, and below them where a
few wide rows would leave B4 latency bound.  There is no fallback: a CUDA
tensor that a kernel does not take, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.profiling import span, spanned
from . import cuda_build
from .host import ints_to_limbs, limbs_to_ints
from .modexp_kernel import _check_digits
from .montgomery import MontCtx, mont_pow_digits_plain

__all__ = ["mont_pow_b4", "mont_pow_b4w", "mont_pow_digits_plain", "load",
           "load_wide", "REGISTER_MAX_LIMBS"]

SOURCE = cuda_build.CSRC / "limb_modexp.cu"
WIDE_SOURCE = cuda_build.CSRC / "limb_modexp_wide.cu"
REGISTER_MAX_LIMBS = 768         # B4's widest modulus (12,288 bits, n^3 of
# a 4096-bit key); wider moduli run on B4w
SMEM_MAX = 232448                # shared memory a block may use (227 KB)
WORDS_PER_LANE = (1, 2, 3, 4, 8, 12)  # the cases of limb_modexp_launch
BLOCK_THREADS = 128              # threads of a block (rows x lanes)
WARPS_PER_SM = 6                 # warps a batch should give each SM
# B4w (a block, or a cluster of blocks, a row); the launch rule's constants
# are fitted to scripts/ab_sliding.py --kernel b4w (PERF.md §6)
WIDE_PAD = 32                    # zero words around a column array
WIDE_CLUSTERS = (1, 2, 4, 8)     # blocks of a row's cluster
WIDE_MIN_WARPS = 8               # warps of a block the rule gives,
WIDE_MAX_WARPS = 32              # at least and at most (1024 threads)
WIDE_CLUSTER_FROM = 768          # words of a row from which clusters pay,
WIDE_MIN_WORDS_A_BLOCK = 192     # and the fewest words a block then keeps
WIDE_FROM_LIMBS = 256            # B4w below 768 limbs from this width on,
WIDE_ROWS_PER_SM = 2             # up to this many rows an SM

_lib = None
_wide_lib = None
build_log = ""       # nvcc / ptxas output of the B4 build this process made
build_log_wide = ""  # and of the B4w build


def load():
    """Build (once per source hash) and load kernel B4's library."""
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


def load_wide():
    """Build (once per source hash) and load kernel B4w's library."""
    global _wide_lib, build_log_wide
    if _wide_lib is not None:
        return _wide_lib
    lib, build_log_wide = cuda_build.build(WIDE_SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.limb_modexp_wide_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci,
                                            vp, ci, ci, ci, ci, ci, ci, vp,
                                            vp]
    lib.limb_modexp_wide_launch.restype = ci
    lib.limb_modexp_wide_row_bytes.argtypes = [ci, ci, ci]
    lib.limb_modexp_wide_row_bytes.restype = ctypes.c_longlong
    _wide_lib = lib
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
    5.8 and 6.8 warps an SM (at L = 256 between 3.9 and 7.8).  Rows
    that no lane count holds without padding (129 to 224 and 257 to 352
    words) take 32 lanes, padded by :func:`padded_words`.  Twelve words a
    lane serve only rows past 256 words (n^3 of a 4096-bit key: 384), at
    32 lanes; narrower rows keep the counts timed above."""
    cases = WORDS_PER_LANE if nw > 256 else WORDS_PER_LANE[:-1]
    lanes = [t for t in (4, 8, 16, 32) if (t <= nw or t == 4)
             and -(-nw // t) in cases] or [32]
    for t in lanes:
        if rows * t >= WARPS_PER_SM * 32 * sms:
            return t
    return lanes[-1]


def padded_words(nw: int, tpi: int) -> int:
    """Words of a row as the kernel holds it at ``tpi`` lanes: ``tpi``
    times the fewest words a lane in :data:`WORDS_PER_LANE` that hold nw
    (the extra words are zero, and R grows with them); nw rounded up to a
    multiple of ``tpi`` where no case holds it."""
    w = -(-nw // tpi)
    return tpi * next((c for c in WORDS_PER_LANE if c >= w), w)


def rows_per_block(row_bytes: int, max_rows: int) -> int:
    """Rows of one block: as many as shared memory holds, at most
    ``max_rows``; raises when not even one row fits."""
    rb = min(max_rows, SMEM_MAX // row_bytes)
    if rb < 1:
        raise ValueError(f"one row needs {row_bytes} B of shared memory, "
                         f"more than {SMEM_MAX}: lower the window")
    return rb


def _kernel_ctx(ctx: MontCtx, n_words: int | None = None) -> tuple:
    """(n, n0, r2, L') as the kernels take them: int32 16-bit limbs of n
    and R^2 mod n, and the low 32 bits of -n^-1 mod R, each shared ([L'],
    [1]) or per row ([B, L'], [B]), with L' = 2 ``n_words`` limbs
    (default: L rounded up to even).  Where L' > L, n is padded with zero
    limbs and R^2 mod n is rebuilt on the host for R = 2^(16 L') (n0
    depends on n mod 2^32 alone)."""
    n, nprime, r2 = ctx.n, ctx.nprime, ctx.r2
    L = 2 * (n_words or -(-ctx.n_limbs // 2))
    n0 = nprime[..., 0] | (nprime[..., 1] << 16)
    if L != ctx.n_limbs:
        mods = limbs_to_ints(n.reshape(-1, n.shape[-1]).cpu().numpy())
        rr = 1 << (32 * L)
        n, r2 = (torch.as_tensor(ints_to_limbs(vals, L).astype(np.int64),
                                 device=ctx.device).reshape(
                                     ctx.n.shape[:-1] + (L,))
                 for vals in (mods, [rr % m for m in mods]))
    n0 = torch.where(n0 >= 1 << 31, n0 - (1 << 32), n0)   # as int32 bits
    return (n.to(torch.int32).contiguous(),
            n0.to(torch.int32).reshape(-1).contiguous(),
            r2.to(torch.int32).contiguous(), L)


def variant(n_limbs: int, rows: int | None = None, sms: int = 132) -> str:
    """The kernel that a CUDA call of :func:`mont_pow_b4` launches for a
    modulus of ``n_limbs`` limbs on ``rows`` rows (None: a batch that
    fills the card) of a device with ``sms`` SMs: "B4w" past
    :data:`REGISTER_MAX_LIMBS` limbs, and below them from
    :data:`WIDE_FROM_LIMBS` limbs on where the batch has at most
    :data:`WIDE_ROWS_PER_SM` rows an SM (B4's lane groups would leave the
    card latency bound); else "B4".  Fitted to ``scripts/ab_sliding.py
    --kernel b4w`` (PERF.md §6)."""
    if n_limbs > REGISTER_MAX_LIMBS:
        return "B4w"
    if (rows is not None and n_limbs >= WIDE_FROM_LIMBS
            and rows <= WIDE_ROWS_PER_SM * sms):
        return "B4w"
    return "B4"


def wide_words(L: int) -> int:
    """Words of a row of L limbs as B4w holds it: L / 2 rounded up to a
    multiple of 32 (a warp; the extra words are zero, and R grows with
    them)."""
    return 32 * -(-L // 64)


def _ops_words(nw: int) -> int:
    # n, n', acc, x, y, m; t (2 nw + 32); three column arrays with pads
    return 14 * nw + 32 + 6 * WIDE_PAD


def _seg_words(nw: int) -> int:
    return 3 * (nw // 16 + 8)


def wide_row_bytes(nw: int, window: int, mode: int) -> int:
    """Shared-memory bytes of one B4w row's block (the C side's
    ``limb_modexp_wide_row_bytes``): the operands, the product and the
    column words, the 2^window-entry table (mode 0) and the segment
    flags of the carry-lookahead; mode 1 without the table, mode 2 the
    flags alone."""
    words = _seg_words(nw)
    if mode < 2:
        words += _ops_words(nw)
    if mode == 0:
        words += (1 << window) * nw
    return 4 * words


def wide_scratch_words(nw: int, window: int, mode: int) -> int:
    """Words of one B4w row's global scratch: the table (mode 1),
    everything but the segment flags (mode 2), none (mode 0)."""
    tab = (1 << window) * nw
    return 0 if mode == 0 else tab if mode == 1 else _ops_words(nw) + tab


def wide_mode(nw: int, window: int) -> int:
    """Where B4w keeps a row of ``nw`` words: all in shared memory (0)
    where one row's operands, columns and table fit in :data:`SMEM_MAX`,
    else the table in a global scratch tensor (1; at window 4 past 1,888
    words, a 60,416-bit modulus), else the operands and columns too (2;
    past 4,064 words)."""
    for mode in (0, 1):
        if wide_row_bytes(nw, window, mode) <= SMEM_MAX:
            return mode
    return 2


def wide_shape(nw: int, rows: int, sms: int, window: int = 4) -> tuple:
    """(warps a block, blocks a cluster) of a B4w launch of ``rows`` rows
    of ``nw`` words on ``sms`` SMs.  The cluster: the most of
    :data:`WIDE_CLUSTERS` whose blocks the card holds at once (rows x
    cluster <= sms), from :data:`WIDE_CLUSTER_FROM` words on and with at
    least :data:`WIDE_MIN_WORDS_A_BLOCK` words a block; 1 in mode 2.
    The warps: one column pair a thread (32 w c >= nw), within
    :data:`WIDE_MIN_WARPS` and :data:`WIDE_MAX_WARPS`.  Fitted to
    ``scripts/ab_sliding.py --kernel b4w`` (PERF.md §6)."""
    cluster = 1
    if wide_mode(nw, window) < 2 and nw >= WIDE_CLUSTER_FROM:
        for c in reversed(WIDE_CLUSTERS):
            if rows * c <= sms and nw >= c * WIDE_MIN_WORDS_A_BLOCK:
                cluster = c
                break
    warps = max(WIDE_MIN_WARPS, min(WIDE_MAX_WARPS,
                                    -(-nw // (32 * cluster))))
    return warps, cluster


def hensel_nprime(n: int, x: int, bits: int, target: int) -> int:
    """-n^-1 mod 2^target from x = -n^-1 mod 2^bits, for odd n, by
    Hensel lifting: x (2 + n x) holds -n^-1 to twice the bits that x
    holds."""
    while bits < target:
        bits = min(2 * bits, target)
        x = x * (2 + n * x) % (1 << bits)
    return x


def _wide_ctx(ctx: MontCtx, nw: int) -> tuple:
    """(n, n', R^2 mod n) as B4w takes them: int32 16-bit limbs [2 nw],
    or [B, 2 nw] per row, for R = 2^(32 nw).  Where 2 nw > L, n is
    padded with zero limbs, R^2 mod n is rebuilt on the host and n' is
    lifted from the context's -n^-1 mod 2^(16 L) by
    :func:`hensel_nprime` (one or two products a row, not an inverse)."""
    L, Lk = ctx.n_limbs, 2 * nw
    fields = (ctx.n, ctx.nprime, ctx.r2)
    if Lk != L:
        mods = limbs_to_ints(ctx.n.reshape(-1, L).cpu().numpy())
        nps = limbs_to_ints(ctx.nprime.reshape(-1, L).cpu().numpy())
        rr = 1 << (64 * nw)
        vals = (mods,
                [hensel_nprime(m, x, 16 * L, 32 * nw)
                 for m, x in zip(mods, nps)],
                [rr % m for m in mods])
        fields = [torch.as_tensor(ints_to_limbs(v, Lk).astype(np.int64),
                                  device=ctx.device).reshape(
                                      ctx.n.shape[:-1] + (Lk,))
                  for v in vals]
    return tuple(f.to(torch.int32).contiguous() for f in fields)


def _operands(ctx: MontCtx, base: torch.Tensor, digits, window: int,
              kernel: str) -> tuple:
    """Check a CUDA call of B4 or B4w: (base limbs [B, L], int32 digits,
    squeeze) or ValueError."""
    if base.device.type != "cuda":
        raise ValueError(f"kernel {kernel} runs on CUDA tensors, got "
                         f"{base.device}")
    squeeze = base.dim() == 1
    if squeeze:
        base = base[None]
    L = ctx.n_limbs
    if base.dim() != 2 or base.shape[-1] != L:
        raise ValueError(f"base must be limbs [B, {L}], got "
                         f"{tuple(base.shape)}")
    B = base.shape[0]
    if ctx.n.dim() == 2 and ctx.n.shape[0] != B:
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
    return base, digits.to(torch.int32).contiguous(), squeeze


def mont_pow_b4(ctx: MontCtx, base: torch.Tensor, digits,
                window: int = 4) -> torch.Tensor:
    """base^e mod n by the fixed-window Montgomery ladder.

    base: limbs [B, L] (or [L]) < R; digits: int [D] shared or [B, D] per
    row, MSB-first base-2^window; ctx fields [L] shared or [B, L] per row.
    Returns the canonical base^e mod n as int64 limbs [B, L], equal to
    :func:`mont_pow_digits_plain`.  A CPU tensor runs the plain version.
    On a CUDA tensor :func:`variant` picks the kernel by the width, the
    rows and the device's SMs: B4 launches with :func:`lanes_per_row`
    lanes a row, in blocks of :data:`BLOCK_THREADS` threads (fewer rows
    where shared memory does not hold them), and adds one to
    ``mont_pow_b4.launches``; B4w launches as :func:`mont_pow_b4w` does
    and adds one to ``mont_pow_b4w.launches``.
    """
    kernel = "B4"
    if base.device.type == "cuda":
        sms = torch.cuda.get_device_properties(
            base.device).multi_processor_count
        kernel = variant(ctx.n_limbs, base.shape[0] if base.dim() == 2
                         else 1, sms)
    with span("ladder", kernel=kernel):
        if base.device.type == "cpu":
            return mont_pow_digits_plain(ctx, base, digits, window)
        base, digits, squeeze = _operands(ctx, base, digits, window, "B4")
        if kernel == "B4w":
            out = launch_wide(ctx, base, digits, window)
        else:
            out = launch(ctx, base, digits, window, lanes_per_row(
                -(-ctx.n_limbs // 2), base.shape[0], sms))
        return out[0] if squeeze else out


@spanned("ladder", kernel="B4w")
def mont_pow_b4w(ctx: MontCtx, base: torch.Tensor, digits,
                 window: int = 4) -> torch.Tensor:
    """:func:`mont_pow_b4`'s contract on kernel B4w, at any width: a block
    (or a cluster of blocks) a row, the row padded to :func:`wide_words`,
    its operands where :func:`wide_mode` puts them, the launch shape of
    :func:`wide_shape`.  A CPU tensor runs the plain version; a CUDA
    tensor launches B4w and adds one to ``mont_pow_b4w.launches``.
    :func:`mont_pow_b4` calls it where :func:`variant` says "B4w"; the
    tests also call it at B4's widths."""
    if base.device.type == "cpu":
        return mont_pow_digits_plain(ctx, base, digits, window)
    base, digits, squeeze = _operands(ctx, base, digits, window, "B4w")
    out = launch_wide(ctx, base, digits, window)
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


def launch_wide(ctx: MontCtx, base: torch.Tensor, digits: torch.Tensor,
                window: int, shape: tuple | None = None) -> torch.Tensor:
    """Kernel B4w on checked CUDA operands (base limbs [B, L], int32
    digits) with ``shape`` = (warps a block, blocks a cluster),
    :func:`wide_shape`'s by default; adds one to
    ``mont_pow_b4w.launches``.  The tests and the sweep take other
    shapes; a shape the kernel does not take raises."""
    B, L = base.shape
    nw = wide_words(L)
    mode = wide_mode(nw, window)
    sms = torch.cuda.get_device_properties(base.device).multi_processor_count
    warps, cluster = shape or wide_shape(nw, B, sms, window)
    n, nprime, r2 = _wide_ctx(ctx, nw)
    x = torch.nn.functional.pad(base.to(torch.int32), (0, 2 * nw - L)
                                ).contiguous()
    lib = load_wide()
    out = torch.empty((B, 2 * nw), dtype=torch.int32, device=base.device)
    scratch = torch.empty((B, wide_scratch_words(nw, window, mode)) if mode
                          else (0,), dtype=torch.int32, device=base.device)
    stream = torch.cuda.current_stream(base.device).cuda_stream
    with torch.cuda.device(base.device):
        err = lib.limb_modexp_wide_launch(
            x.data_ptr(), digits.data_ptr(), digits.shape[-1],
            int(digits.dim() == 2), n.data_ptr(), nprime.data_ptr(),
            r2.data_ptr(), int(ctx.n.dim() == 2), out.data_ptr(), B, nw,
            window, warps, cluster, mode,
            scratch.data_ptr() if mode else None, stream)
    if err:
        raise RuntimeError(f"kernel B4w launch failed: cudaError {err} "
                           f"({warps} warps, cluster {cluster}, mode "
                           f"{mode})")
    cuda_build.count_launch(mont_pow_b4w)
    return out[:, :L].to(torch.int64)


mont_pow_b4w.launches = 0
