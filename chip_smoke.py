#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paillier_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device  -- a CUDA device is required; prints nvidia-smi's name and
                power limit.
  2. build   -- builds kernel B1 (csrc/rns2_sliding.cu) with nvcc into
                build/paillier_tpu_torch/ and prints the build time and
                ptxas' register / shared-memory report.
  3. kernel  -- kernel B1 against its plain torch version on the same
                CUDA inputs: residues must be bit-identical (tolerance:
                exact) at k = 64 (256-bit modulus) and at the main
                path's shapes, 4096 rows at k = 320 (n^2 of a 2048-bit
                key, with the fused G^m operand) and k = 192 (p^2); a
                few rows must equal Python's pow.  Both are timed at
                the main path's shapes.
  4. main    -- the port's main path at full width: keygen(2048),
                Encryptor(pk, device="cuda") on 4096 plaintexts,
                Decryptor(sk, crt=True, device="cuda") on all of them.
                Every plaintext must round-trip, 16 ciphertexts must
                equal (1 + m*n) * r^n mod n^2 computed on the host, and
                the kernel's launch counter must show that both went
                through kernel B1.
Then one JSON line describing the kernel, and as the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

BATCH = 4096           # bench.py's headline batch
KEY_BITS = 2048
SEED = 2048
WARM_ROWS = 64         # rows of the untimed first encrypt / decrypt


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_name_power() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paillier_tpu_torch")):
        fail("paillier_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

    from paillier_tpu_torch import Decryptor, Encryptor, keygen
    from paillier_tpu_torch.bigint import sliding_kernel as sk_mod
    from paillier_tpu_torch.bigint.rns2 import (Rns2Engine,
                                                sliding_window_schedule)
    from paillier_tpu_torch.core.keys import decode_batch, encode_batch
    from paillier_tpu_torch.ops.random import random_units
    b1 = sk_mod.rns2_pow_sliding_b1
    plain = sk_mod.rns2_pow_sliding_plain
    dev = torch.device("cuda:0")

    # -- 1. device ---------------------------------------------------------
    card = smi_name_power()
    phase("device", f"{torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {card}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    sk_mod.load()
    ptxas = [ln.strip() for ln in sk_mod.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"kernel B1 built in {time.perf_counter() - t0:.2f} s; "
          + " | ".join(ptxas))

    # -- 3. kernel vs plain ------------------------------------------------
    max_err = 0
    n_cmp = 0

    def compare(eng, x, sched, window, fin, label):
        nonlocal max_err, n_cmp
        got = b1(eng.ctx, x, sched, window, fin=fin)
        want = plain(eng.ctx, x, sched, window, fin=fin)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        n_cmp += 1
        if not torch.equal(got, want):
            fail(f"kernel B1 != plain ({label}): max |diff| {err}")
        return got

    def check_pow(eng, xs, e, fs, got, rows, label):
        N = eng.spec.N
        want = [pow(x, e, N) * f % N for x, f in zip(xs[:rows], fs[:rows])]
        if eng.decode(got[:rows]) != want:
            fail(f"kernel B1 != Python pow ({label})")

    t0 = time.perf_counter()
    rng = random.Random(0x5EED)
    n256 = rng.getrandbits(256) | (1 << 255) | 1
    eng = Rns2Engine(n256, device=dev)
    xs = [rng.randrange(n256) for _ in range(16)]
    fs = [rng.randrange(n256) for _ in range(16)]
    x, fin = eng.encode(xs), eng.encode(fs)
    for window in (5, 6):
        for e in (1, 2, 3, rng.getrandbits(130) | (1 << 129)):
            sched = sliding_window_schedule(e, window)
            got = compare(eng, x, sched, window, None, f"k=64 e={e} w={window}")
            check_pow(eng, xs, e, [1] * 16, got, 16, f"k=64 w={window}")
        padded = list(sched) + [-2, -2, -2]
        got = compare(eng, x, padded, window, fin, f"k=64 fin -2 w={window}")
        check_pow(eng, xs, e, fs, got, 16, f"k=64 fin w={window}")
    phase("kernel", f"k={eng.spec.k}: {n_cmp} ladders bit-identical to plain "
          f"and to pow ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    skey, pk = keygen(KEY_BITS, random.Random(SEED))
    phase("main", f"keygen({KEY_BITS}) in {time.perf_counter() - t0:.2f} s")

    def time_both(eng, x, sched, fin):
        """CUDA-event ms of one kernel launch and one plain ladder."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        b1(eng.ctx, x, sched, 6, fin=fin)
        ev[1].record()
        plain(eng.ctx, x, sched, 6, fin=fin)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    # the main path's ladder shapes: BATCH rows at k = 320 (r^n * G^m mod
    # n^2, encryption) and at k = 192 (c^(p-1) mod p^2, one CRT half)
    t0 = time.perf_counter()
    eng_n2 = pk.device(dev).rns(1)
    xs = [rng.randrange(1, pk.n2) for _ in range(BATCH)]
    fs = [rng.randrange(pk.n2) for _ in range(BATCH)]
    L2 = eng_n2.converter.L
    x = eng_n2.from_limbs(encode_batch(xs, L2, device=dev))
    fin = eng_n2.from_limbs(encode_batch(fs, L2, device=dev))
    sched = sliding_window_schedule(pk.n, 6)
    got = compare(eng_n2, x, sched, 6, fin, f"k={eng_n2.spec.k} r^n*fin")
    check_pow(eng_n2, xs, pk.n, fs, got, 4, f"k={eng_n2.spec.k}")
    kernel_ms, plain_ms = time_both(eng_n2, x, sched, fin)
    phase("kernel", f"k={eng_n2.spec.k}, {BATCH} rows, e=n "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")

    p2 = skey.p * skey.p
    eng_p2 = Rns2Engine(p2, device=dev)
    xs = [rng.randrange(1, p2) for _ in range(BATCH)]
    x = eng_p2.from_limbs(encode_batch(xs, eng_p2.converter.L, device=dev))
    sched = sliding_window_schedule(skey.p - 1, 6)
    got = compare(eng_p2, x, sched, 6, None, f"k={eng_p2.spec.k} c^(p-1)")
    check_pow(eng_p2, xs, skey.p - 1, [1] * 4, got, 4,
              f"k={eng_p2.spec.k}")
    k192_ms, k192_plain_ms = time_both(eng_p2, x, sched, None)
    phase("kernel", f"k={eng_p2.spec.k}, {BATCH} rows, e=p-1 "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {k192_ms:.3f} ms, plain {k192_plain_ms:.3f} ms; "
          f"{n_cmp} comparisons, max |diff| {max_err} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 4. main path ------------------------------------------------------
    t0 = time.perf_counter()
    enc = Encryptor(pk, device=dev, rng=random.Random(SEED + 1))
    dec = Decryptor(skey, crt=True, device=dev)
    mrng = random.Random(SEED + 2)
    ms = [mrng.randrange(pk.n) for _ in range(BATCH)]
    rs = random_units(pk.n, BATCH, mrng)
    dec.decrypt(enc.encrypt(ms[:WARM_ROWS], rs[:WARM_ROWS]))   # warm-up
    phase("main", f"Encryptor + Decryptor built and warmed in "
          f"{time.perf_counter() - t0:.2f} s")

    b1.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ct = enc.encrypt(ms, rs)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc_launches = b1.launches
    t0 = time.perf_counter()
    out = dec.decrypt(ct)                 # decode_batch synchronises
    t_dec = time.perf_counter() - t0
    launches = b1.launches
    dec_launches = launches - enc_launches

    if enc_launches < 1 or dec_launches < 2:
        fail(f"main path bypassed kernel B1: {enc_launches} launches in "
             f"encryption, {dec_launches} in decryption")
    if tuple(ct.c.shape) != (BATCH, 2 * pk.device(dev).L):
        fail(f"ciphertext shape {tuple(ct.c.shape)}")
    if out != ms:
        bad = sum(a != b for a, b in zip(out, ms))
        fail(f"{bad} of {BATCH} ciphertexts did not decrypt to their plaintext")
    host = [(1 + m * pk.n) * pow(r, pk.n, pk.n2) % pk.n2
            for m, r in zip(ms[:16], rs[:16])]
    if decode_batch(ct.c[:16]) != host:
        fail("ciphertexts differ from (1 + m*n) * r^n mod n^2")
    phase("main", f"B1 launches: {enc_launches} in encryption, "
          f"{dec_launches} in CRT decryption")
    phase("main", f"encrypt {BATCH} x {KEY_BITS}-bit: {t_enc:.4f} s, "
          f"{BATCH / t_enc:.1f} enc/s; CRT decrypt: {t_dec:.4f} s, "
          f"{BATCH / t_dec:.1f} dec/s; all {BATCH} round-trip, 16 equal "
          f"the host formula")

    print(json.dumps({"kernels": [{
        "name": "rns2_sliding",
        "route": "cuda",
        "source": "paillier_tpu_torch/csrc/rns2_sliding.cu",
        "replaces": "paillier_tpu/bigint/pallas_rns2.py:185",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(f"nvidia-smi: {smi_name_power()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
