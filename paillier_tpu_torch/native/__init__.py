"""Native host-math runtime of the port (C++ over the system GMP ABI).

The port's own copy of the JAX package's loader: ``hostmath.cpp`` here is
a byte-for-byte copy of ``paillier_tpu/native/hostmath.cpp``, compiled at
first use with ``g++`` against the system ``libgmp.so.10`` (no GMP
headers needed) into ``build/paillier_tpu_torch/`` beside the package,
keyed by the source's hash, and loaded with ctypes.  It serves the host
control plane: primality of key-generation candidates, modular inverses,
and the JAX loader's other wrappers (``powm``, ``powm_batch``, ``gcd``,
``mulmod``).

If ``g++`` or libgmp is missing, or ``PAILLIER_TPU_NO_NATIVE`` is set
(the switch the JAX package reads, so both packages take the same path in
the same environment), :func:`available` is False and the callers in
:mod:`paillier_tpu_torch.bigint.host` take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().with_name("hostmath.cpp")
BUILD_DIR = _SRC.parents[2] / "build" / "paillier_tpu_torch"
_GMP_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libgmp.so.10",
    "/lib/x86_64-linux-gnu/libgmp.so.10",
    "/usr/lib/libgmp.so.10",
    "/usr/lib/x86_64-linux-gnu/libgmp.so",
)

_lib = None
_lock = threading.Lock()
_tried = False


def enabled() -> bool:
    """False when ``PAILLIER_TPU_NO_NATIVE`` is set (non-empty)."""
    return not os.environ.get("PAILLIER_TPU_NO_NATIVE")


def _find_gmp() -> Optional[str]:
    for p in _GMP_CANDIDATES:
        if os.path.exists(p):
            return p
    return None


def library_path() -> Path:
    """Where the build goes: named by the source's hash, so a stale build
    is never loaded."""
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"hostmath_{h}.so"


def _build() -> Optional[Path]:
    gmp = _find_gmp()
    if gmp is None:
        return None
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + f".tmp{os.getpid()}")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), gmp,
           "-lpthread", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError) as e:
        print(f"# paillier_tpu_torch.native: build failed ({e}); "
              "using the Python paths", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not enabled():
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            print(f"# paillier_tpu_torch.native: load failed ({e})",
                  file=sys.stderr)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        sz = ctypes.c_size_t
        ci = ctypes.c_int
        lib.pt_abi_version.restype = ci
        lib.pt_powm.argtypes = [u8p, sz, u8p, sz, u8p, sz, u8p]
        lib.pt_powm.restype = ci
        lib.pt_powm_batch.argtypes = [u8p, sz, sz, u8p, sz, u8p, sz, u8p, ci]
        lib.pt_powm_batch.restype = ci
        lib.pt_probab_prime.argtypes = [u8p, sz, ci]
        lib.pt_probab_prime.restype = ci
        lib.pt_invert.argtypes = [u8p, sz, u8p, sz, u8p]
        lib.pt_invert.restype = ci
        lib.pt_gcd.argtypes = [u8p, sz, u8p, sz, u8p, sz]
        lib.pt_gcd.restype = ci
        lib.pt_mulmod.argtypes = [u8p, sz, u8p, sz, u8p, sz, u8p]
        lib.pt_mulmod.restype = ci
        lib.pt_first_prime.argtypes = [u8p, sz, sz, ci, ci, ci]
        lib.pt_first_prime.restype = ctypes.c_long
        lib.pt_modinv_batch.argtypes = [u8p, sz, sz, u8p, sz, u8p, ci]
        lib.pt_modinv_batch.restype = ctypes.c_long
        if lib.pt_abi_version() != 2:
            return None
        _lib = lib
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native runtime unavailable (no g++/libgmp, or "
            "PAILLIER_TPU_NO_NATIVE is set); use the pure-Python paths "
            "in paillier_tpu_torch.bigint.host")
    return lib


def available() -> bool:
    return _load() is not None


def _be(x: int, length: Optional[int] = None) -> bytes:
    if length is None:
        length = max(1, (x.bit_length() + 7) // 8)
    return x.to_bytes(length, "big")


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def _out(length: int):
    return (ctypes.c_uint8 * length)()


def powm(base: int, exp: int, mod: int) -> int:
    """base^exp mod mod (exp >= 0, mod > 0)."""
    lib = _require()
    b, e, m = _be(base), _be(exp), _be(mod)
    out = _out(len(m))
    rc = lib.pt_powm(_buf(b), len(b), _buf(e), len(e), _buf(m), len(m), out)
    if rc != 0:
        raise ValueError("powm failed (zero modulus?)")
    return int.from_bytes(bytes(out), "big")


def powm_batch(bases, exp: int, mod: int, threads: int = 0) -> list:
    """[b^exp mod mod for b in bases], multithreaded."""
    lib = _require()
    m = _be(mod)
    ml = len(m)
    stride = max(ml, max((b.bit_length() + 7) // 8 for b in bases))
    flat = b"".join(_be(b, stride) for b in bases)
    out = _out(ml * len(bases))
    threads = threads or min(len(bases), os.cpu_count() or 1)
    e = _be(exp)
    rc = lib.pt_powm_batch(_buf(flat), len(bases), stride, _buf(e), len(e),
                           _buf(m), ml, out, threads)
    if rc != 0:
        raise ValueError("powm_batch failed (zero modulus?)")
    raw = bytes(out)
    return [int.from_bytes(raw[i * ml:(i + 1) * ml], "big")
            for i in range(len(bases))]


def is_probable_prime(n: int, reps: int = 20) -> bool:
    """GMP probab_prime (BPSW + reps Miller-Rabin rounds)."""
    if n < 2:
        return False
    lib = _require()
    x = _be(n)
    return lib.pt_probab_prime(_buf(x), len(x), reps) > 0


def modinv(a: int, m: int) -> int:
    lib = _require()
    if m == 0:
        raise ValueError("modinv failed (zero modulus?)")
    ab, mb = _be(a % m), _be(m)
    out = _out(len(mb))
    ok = lib.pt_invert(_buf(ab), len(ab), _buf(mb), len(mb), out)
    if ok < 0:
        raise ValueError("modinv failed (zero modulus?)")
    if ok == 0:
        raise ValueError("base is not invertible for the given modulus")
    return int.from_bytes(bytes(out), "big")


def gcd(a: int, b: int) -> int:
    lib = _require()
    ab, bb = _be(a), _be(b)
    outl = max(len(ab), len(bb))
    out = _out(outl)
    rc = lib.pt_gcd(_buf(ab), len(ab), _buf(bb), len(bb), out, outl)
    if rc != 0:
        raise ValueError("gcd result does not fit the output buffer")
    return int.from_bytes(bytes(out), "big")


def mulmod(a: int, b: int, m: int) -> int:
    """(a * b) mod m."""
    lib = _require()
    ab, bb, mb = _be(a), _be(b), _be(m)
    out = _out(len(mb))
    rc = lib.pt_mulmod(_buf(ab), len(ab), _buf(bb), len(bb), _buf(mb),
                       len(mb), out)
    if rc != 0:
        raise ValueError("mulmod failed (zero modulus?)")
    return int.from_bytes(bytes(out), "big")


def modinv_batch(values: Sequence[int], mod: int, threads: int = 0) -> list:
    """[v^{-1} mod mod for v in values], multithreaded; raises ValueError
    if any element is not invertible."""
    lib = _require()
    m = _be(mod)
    ml = len(m)
    stride = max(ml, max((v.bit_length() + 7) // 8 for v in values))
    flat = b"".join(_be(v % mod, stride) for v in values)
    out = _out(ml * len(values))
    threads = threads or min(len(values), os.cpu_count() or 1)
    bad = lib.pt_modinv_batch(_buf(flat), len(values), stride, _buf(m), ml,
                              out, threads)
    if bad:
        raise ValueError(f"{bad} element(s) not invertible mod modulus")
    raw = bytes(out)
    return [int.from_bytes(raw[i * ml:(i + 1) * ml], "big")
            for i in range(len(values))]


def invertible_mask(rows: np.ndarray, mod: int, threads: int = 0
                    ) -> np.ndarray:
    """Which of ``rows`` (uint8 [count, stride], each row a big-endian
    integer) are invertible mod ``mod``, i.e. have gcd 1 with it: one
    threaded ``pt_modinv_batch`` call, which zeroes exactly the outputs of
    the elements without an inverse (an inverse mod m > 1 is nonzero)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    count, stride = rows.shape
    if count == 0:
        return np.zeros(0, dtype=bool)
    lib = _require()
    m = _be(mod)
    out = np.zeros((count, len(m)), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    threads = threads or min(count, os.cpu_count() or 1)
    bad = lib.pt_modinv_batch(rows.ctypes.data_as(u8p), count, stride,
                              _buf(m), len(m), out.ctypes.data_as(u8p),
                              threads)
    if bad < 0:
        raise ValueError("invertible_mask failed (zero modulus?)")
    return out.any(axis=1)


def first_prime(cands: Sequence[int], *, safe: bool = False, reps: int = 20,
                threads: int = 0) -> Optional[int]:
    """Index of the first candidate that passes the primality filter, or
    None.  ``safe=True`` takes each candidate as a Sophie Germain q and
    asks 2q+1 to be prime too (sieve, q % 3 != 1, BPSW / Miller-Rabin,
    Fermat base 2; reference safe_prime.go:208-278).  Deterministic: the
    result depends only on the candidate list, not on the thread count."""
    if not cands:
        return None
    lib = _require()
    width = max(1, max((c.bit_length() + 7) // 8 for c in cands))
    flat = b"".join(_be(c, width) for c in cands)
    threads = threads or (os.cpu_count() or 1)
    idx = lib.pt_first_prime(_buf(flat), len(cands), width, reps,
                             1 if safe else 0, threads)
    return None if idx < 0 else int(idx)
