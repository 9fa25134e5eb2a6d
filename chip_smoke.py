#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paillier_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure exits
non-zero):
  1. device  -- a CUDA device is required; prints nvidia-smi's name and
                power limit.
  2. build   -- builds kernels B1 (csrc/rns2_sliding.cu), B2
                (csrc/rns2_modexp.cu), B3 (csrc/rns2_fixed_base.cu) and B4
                (csrc/limb_modexp.cu) and the probes P1-P5
                (csrc/probe_*.cu), one nvcc each, all at once, into
                build/paillier_tpu_torch/, and prints the build time and
                ptxas' register and spill report of every instantiation;
                counts the IMMA (int8 tensor-core) and IDP4A instructions
                in the SASS of B1-B3 (cuobjdump -sass) and fails unless
                each has IMMA and no IDP4A, and unless the loops of P1-P4
                hold IMMA and each of P5's loops its op class once for
                every value a thread holds.
  3. kernel  -- each kernel against its plain torch version on the same
                CUDA inputs: residues must be bit-identical (tolerance:
                exact) and a few rows must equal Python's pow.
                B1: k = 64 (256-bit modulus); the main path's shapes,
                4096 rows at k = 320 (r^n * G^m mod n^2) and k = 192
                (c^(p-1) mod p^2); 1024 rows at k = 512 (r^(n^2) mod n^3);
                64 rows at k = 704 (a random odd 8192-bit modulus); each
                k also the other way round (with fin where the main shape
                has none, and without where it has it) on 33 rows with a
                256-bit exponent.  Each main shape prints its tile rows
                and us per Montgomery multiply, and the L2 bytes per
                multiply and read rate that its shape implies (blocks x
                both [2k, 2k] int8 matrices; worked out, not counted).
                B2: shared and per-row digits at k = 64; per-row 2048-bit
                exponents on 4096 rows at k = 320 (const_mult); 1024 rows
                at k = 512 with the 1024 digits of level-1 ciphertexts
                (nested_add); each main shape prints its tile rows and us
                per multiply.
                B3: k = 64 with and without fin; the main path's shapes,
                4096 rows at k = 320 (h1's comb, 256 per-row digits of
                r < K) and 1024 rows at k = 512 (h2's comb), each
                printing its tile rows and us per multiply.
                B4: L = 16 with shared and per-row digits and per-row
                moduli; L = 128 on 4096 rows against plain over a 32-digit
                exponent, the full 2048-bit exponent of extract_randomness
                on 4096 and on 1024 rows (64 and 16 rows against pow), and
                64 per-row 1024-bit moduli with per-row exponents (the
                Fermat batch: 32 digits against plain, all 256 against
                pow); each prints its lanes per row and us per Montgomery
                product.
                The threshold path's shapes: B1 at k = 320 with a
                4,100-bit exponent (partial decryption's 2*delta*s_i; 33
                rows against plain and pow, 4096 timed); B2 on the 12,288
                stacked rows of combine's Lagrange ladder, 4 per-row
                digits; B4 at L = 256 (mod n^2) on 5 rows with per-row
                1,025-digit exponents (the verification keys; 32 digits
                against plain, all against pow).
                DDLEQ's shapes on bench.py's chunk (128 proofs x secpar
                40 = 5,120 rows): B1 and B2 at k = 256 (the prover's
                p^3 half: y^(n^2 mod p^2(p-1)), 1,024 per-row digits)
                against plain on all rows; the verifier's B1 (f^(n^2))
                and B2 (1,024 digits) at k = 512 timed on all rows, 4
                against pow (the same exponents run against plain above
                at 1024 rows).
                Kernel and plain times are CUDA events.
  4. main    -- the first slice's path at full width: keygen(2048),
                Encryptor(pk, device="cuda") on 4096 plaintexts,
                Decryptor(sk, crt=True, device="cuda") on all of them:
                every plaintext round-trips, 16 ciphertexts equal
                (1 + m*n) * r^n mod n^2 on the host.
  5. homomorphic -- level 1, batch 4096: add, sub, const_mult (shared
                and per-element 2048-bit scalars), randomize, aggregate
                over a 65,536-row tile, aggregate_streaming over 4 chunks,
                Decryptor(crt=False) over all 4096.  Each result is
                checked by CRT decryption against plaintext arithmetic
                mod n, and 8 rows against the host formula.
  6. level2  -- batch 1024: Encryptor(pk, 2) (8 rows equal
                (1+n)^m * r^(n^2) mod n^3), Decryptor(sk, 2) round trip,
                nested_encrypt -> nested_add / nested_sub /
                nested_randomize -> nested_decrypt give x+y, x-y and x.
  7. alternative -- Encryptor(pk, 1, "alternative") on 4096 plaintexts
                and a CRT round trip (8 rows equal (1+m*n) * h1^r mod n^2);
                Encryptor(pk, 2, "alternative") on 1024 and a
                Decryptor(sk, 2) round trip (8 rows against the host
                formula); alt enc/s.
  8. limb    -- extract_randomness on 4096 level-1 and 1024 level-2
                regular ciphertexts returns every r that encrypted;
                keygen(2048, device_primes=True) finds p, q (host
                Miller-Rabin, 3 mod 4, a 2048-bit n) through B4's per-row
                moduli.
  9. probes  -- every variant of P1-P5 (paillier_tpu_torch/probes/
                cases.py, P4 also with W loaded past L1) is bit-identical
                to its plain version on CUDA inputs, on 37 and 300 rows
                and each tile, 3 steps; then the probes' path, python -m
                paillier_tpu_torch.probes's run_p1..run_p5 at the scripts'
                full shapes (CUDA events), each probe's headline case also
                against its plain version at that shape; fails if a probe
                runs faster than its bound, the least work of its function
                (a folded loop).
 10. threshold -- bench.py's (3, 5)-threshold configuration at 2048 bits:
                ThresholdKeyGenerator(2048, 5, 3, random.Random(0x7357))
                .generate_from_primes on bench.py's fixed safe primes (the
                5 verification keys on B4, equal to pow); 4096 plaintexts
                encrypted under the threshold key, partial_decrypt_all
                of servers 1-3 (3 B1) and combine (1 B2): all round-trip,
                8 rows equal combine_ints; threshold dec/s and the
                seconds of each step (B1 ladders; combine's Lagrange
                ladder, residue trees, modinv_batch, tail); then
                partial_decrypt_with_zkp of servers 1-3 on the same 4096
                (1 B1 + 2 B2 each), verify_proofs of each (4 B2), a
                tampered proof that must fail, combine_with_zkp giving the
                plaintexts; the SHA-256 challenges timed apart.
 11. ddleq   -- bench.py's ddleq configuration at 2048 bits (phase 4's
                key): 128 nested encryptions, nested_randomize, a
                warm-up prove + verify at secpar 40; a timed serial
                chunk (prove B1 7, B2 8, B4 1; verify B1 2, B2 1) with
                the hashes, random_units_limbs, modinv_batch and the
                level-2 Decryptor of extract_randomness timed apart;
                the p^3/q^3 split equals full width on 8 proofs; one
                verification where a tampered f fails its proof only
                and a proof against an unrelated nested ciphertext
                fails; 8 instances pass the host formula;
                then pipeline_prove_verify over two chunks (256 proofs,
                seeds 0xDD1E0 + i): DDLEQ prove+verify/s with the
                card's name and power limit.
Phases 4-11 each set the launch counters to 0 just before their
operations and read them just after; a phase, or an operation in it,
whose B1, B2, B3 and B4 launches differ from the exact count its entry
points make fails (the prime search's B4 count is the number of Fermat
batches it reports; phase 10: keys B4 1, partial decryption B1 3,
combine B2 1, the proofs B1 3 and B2 35; phase 11: the serial chunk
B1 9, B2 9, B4 1, the checks B1 15, B2 14, B4 2, the pipeline B1 18,
B2 18, B4 2), and phase 9 fails unless every probe kernel launched.
Then lines of the threshold and DDLEQ shapes' bounds, one JSON line
describing the kernels, the card's name and power limit, and as the
last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

BATCH = 4096           # bench.py's headline batch
L2_BATCH = 1024        # level-2 batch
AGG_TILE = 1 << 16     # bench.py's aggregation chunk
KEY_BITS = 2048
SEED = 2048
WARM_ROWS = 64         # rows of the untimed first encrypt / decrypt
HOST_ROWS = 8          # rows checked against the host formula
THR_E_BITS = 4100      # partial decryption's 2*delta*s_i at 2048 bits
DD_CHUNK = 128         # bench.py's ddleq configuration: proofs a chunk,
DD_SECPAR = 40         # instances a proof,
DD_CHUNKS = 2          # and chunks (256 proofs) in its pipeline
DD_ROWS = DD_CHUNK * DD_SECPAR
THR_SEED = 0x7357      # bench.py's threshold configuration: its rng seed
# and its fixed 1024-bit safe primes p = 2p' + 1 (bench.py:49-50)
SAFE_P1024 = int(
    "e422c56ca3c0f2d84f17306861a0b801cb6994fcccff85a797b18be4c14226fa"
    "77c2440b48dee0efa7aea10bab5a2a9a1fcd1095a4c221b3825c2dce2facd955"
    "c13c370de6c6d15cf850e4b47c52c83698afd26add3ae25953424839b657675a"
    "c2b3ec41729024ce3bfaf62c197377cb44a93f532b80d9040096f8c08ff7eb73", 16)
SAFE_Q1024 = int(
    "c35701846e378ba4ace9de4018b37137cc090f0fc2056b78502e38abe63cccb0"
    "efba37e3f16a8dcc12b9f655179794558fe416b9b5cf8d558e501a8226a3f4c8"
    "ed7d4a01d4038dc1d762f93bff23a33ec2604eb75afc06faefe359c44f20468c"
    "252742b742f10f07f075d57371d9b529bcab6a801db5c2e7324c7e905f12f807", 16)


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


def ptxas_report(log: str) -> list[str]:
    """'<wide,maxthreads,minblocks>: registers, spills' per instantiation
    from nvcc -Xptxas -v output."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            t = re.search(r"ILb([01])ELi(\d+)ELi(\d+)E", m.group(1))
            r = re.search(r"ILi(\d+)ELb([01])ELi(\d+)E", m.group(1))
            w = re.search(r"limb_modexp_kernelILi(\d+)EE", m.group(1))
            p = re.search(r"(?:probes|vpuops)\d+(\w+?_kernel)I((?:Li\d+E)+)E",
                          m.group(1))
            name = (f"<wide={t.group(1)},{t.group(2)},{t.group(3)}>" if t
                    else f"<rows={r.group(1)},wide={r.group(2)},{r.group(3)}>"
                    if r else f"<words={w.group(1)}>" if w
                    else f" {p.group(1)}<"
                    + ",".join(re.findall(r"\d+", p.group(2))) + ">" if p
                    else m.group(1))
        elif "registers" in ln or "spill" in ln:
            out.append(f"{name} {ln.split(':', 1)[-1].strip()}")
    return out


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paillier_tpu_torch")):
        fail("paillier_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

    from paillier_tpu_torch import (Ciphertext, Decryptor, Encryptor,
                                    homomorphic as hom, keygen,
                                    nested_decrypt, nested_encrypt)
    from paillier_tpu_torch.bigint import cuda_build
    from paillier_tpu_torch.bigint import fixed_base_kernel as fb_mod
    from paillier_tpu_torch.bigint import host as bhost
    from paillier_tpu_torch.bigint import modexp_kernel as mx_mod
    from paillier_tpu_torch.bigint import mont_kernel as mk_mod
    from paillier_tpu_torch.bigint import sliding_kernel as sk_mod
    from paillier_tpu_torch.bigint.montgomery import (exp_digits,
                                                      limbs_to_digits,
                                                      make_mont_ctx,
                                                      n_digits_for_bits,
                                                      stack_mont_ctx)
    from paillier_tpu_torch.bigint.rns2 import (Rns2Engine,
                                                build_fixed_base_table,
                                                sliding_window_schedule)
    from paillier_tpu_torch.core import keygen as kg_mod
    from paillier_tpu_torch.core.keys import decode_batch, encode_batch
    from paillier_tpu_torch.ops.random import random_units
    from paillier_tpu_torch.threshold import (PartialDecryption,
                                              ThresholdKeyGenerator, combine,
                                              combine_ints, combine_with_zkp,
                                              compute_lambda,
                                              partial_decrypt_all,
                                              partial_decrypt_with_zkp,
                                              verify_proof, verify_proofs)
    from paillier_tpu_torch.threshold import decrypt as thr_dec
    from paillier_tpu_torch.threshold import zkp as thr_zkp
    from paillier_tpu_torch import probes
    from paillier_tpu_torch.ops.oracle import oracle_bit
    from paillier_tpu_torch.zk import ddleq as zd
    from paillier_tpu_torch.zk.ddleq import DDLEQProof
    from paillier_tpu_torch.probes import __main__ as probe_cli
    from paillier_tpu_torch.probes import dotchain as pr_dotchain
    from paillier_tpu_torch.probes import dotvar as pr_dotvar
    from paillier_tpu_torch.probes import overlap as pr_overlap
    from paillier_tpu_torch.probes import pad as pr_pad
    from paillier_tpu_torch.probes import vpuops as pr_vpuops
    from paillier_tpu_torch.probes.cases import CASES as probe_case_list
    b1 = sk_mod.rns2_pow_sliding_b1
    b1_plain = sk_mod.rns2_pow_sliding_plain
    b2 = mx_mod.rns2_pow_b2
    b2_plain = mx_mod.rns2_pow_plain
    b3 = fb_mod.rns2_pow_fixed_base_b3
    b3_plain = fb_mod.rns2_pow_fixed_base_plain
    b4 = mk_mod.mont_pow_b4
    b4_plain = mk_mod.mont_pow_digits_plain
    wrappers = {"B1": b1, "B2": b2, "B3": b3, "B4": b4}
    mods = {"B1": sk_mod, "B2": mx_mod, "B3": fb_mod, "B4": mk_mod}
    probe_mods = {"P1": pr_dotvar, "P2": pr_dotchain, "P3": pr_overlap,
                  "P4": pr_pad, "P5": pr_vpuops}
    probe_wrappers = {"P1": pr_dotvar.dotvar, "P2": pr_dotchain.dotchain,
                      "P3": pr_overlap.overlap, "P4": pr_pad.pad,
                      "P4 roll": pr_pad.roll, "P5": pr_vpuops.vpuops}
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    card = smi_name_power()
    phase("device", f"{torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {card}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    loaders = [mod.load for mod in mods.values()] + [
        mod.KERNEL.load for mod in probe_mods.values()]
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
    phase("build", f"kernels {', '.join(mods)} and probes "
          f"{', '.join(probe_mods)} built in {time.perf_counter() - t0:.2f} s")
    for name, mod in mods.items():
        for ln in ptxas_report(mod.build_log):
            phase("build", f"{name}{ln}")
    for name, mod in probe_mods.items():
        for ln in ptxas_report(mod.KERNEL.build_log):
            phase("build", f"{name}{ln}")
    sass = {}
    for name in ("B1", "B2", "B3"):
        code = cuda_build.sass(mods[name].SOURCE)
        # IDP4A prints as IDP.4A (.S8.S8) in the SASS of sm_90
        sass[name] = (len(re.findall(r"\bIMMA\.", code)),
                      len(re.findall(r"\bIDP\.?4A\b", code)))
    phase("build", "SASS instructions (IMMA, IDP4A): " + ", ".join(
        f"{name} {v}" for name, v in sass.items()))
    for name, (n_imma, n_dp4a) in sass.items():
        if n_imma == 0 or n_dp4a != 0:
            fail(f"kernel {name}'s SASS has {n_imma} IMMA and {n_dp4a} "
                 f"IDP4A: its products are not on the int8 tensor cores")
    imma = {}
    for name, mod in probe_mods.items():
        code = cuda_build.sass(mod.KERNEL.source)
        faults = probes.sass_faults(code, mod.SASS_EXPECT)
        if faults:
            fail(f"probe {name}'s SASS: " + "; ".join(faults))
        imma[name] = len(re.findall(r"\bIMMA\.", code))
    phase("build", "probe SASS: every loop holds its op (IMMA in P1-P4: "
          + ", ".join(f"{k} {v}" for k, v in imma.items() if v) + ")")

    # -- 3. kernel vs plain ------------------------------------------------
    stats = {kname: {"err": 0, "n": 0, "times": []} for kname in mods}

    def compare(kname, run_kernel, run_plain, label, warm=False):
        """Kernel and plain version on the same inputs: bit-identical, or
        fail.  Times both with CUDA events (the kernel once more first
        when ``warm``); returns the kernel's output."""
        if warm:
            run_kernel()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        got = run_kernel()
        ev[1].record()
        want = run_plain()
        ev[2].record()
        torch.cuda.synchronize()
        st = stats[kname]
        err = int((got.long() - want.long()).abs().max())
        st["err"] = max(st["err"], err)
        st["n"] += 1
        if not torch.equal(got, want):
            fail(f"kernel {kname} != plain ({label}): max |diff| {err}")
        ms, plain_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        if warm:                       # the slice's shapes
            st["times"].append({"shape": label, "ms": ms,
                                "plain_ms": plain_ms})
        return got, ms, plain_ms

    def check_pow(eng, xs, es, fs, got, rows, label):
        N = eng.spec.N
        want = [pow(x, e, N) * f % N
                for x, e, f in zip(xs[:rows], es[:rows], fs[:rows])]
        if eng.decode(got[:rows]) != want:
            fail(f"kernel output != Python pow ({label})")

    def residues(eng, vals):
        return eng.from_limbs(encode_batch(vals, eng.converter.L, device=dev))

    # B1 and B2 at k = 64
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
            got, _, _ = compare(
                "B1", lambda: b1(eng.ctx, x, sched, window),
                lambda: b1_plain(eng.ctx, x, sched, window),
                f"k=64 e={e.bit_length()}-bit w={window}")
            check_pow(eng, xs, [e] * 16, [1] * 16, got, 16, f"B1 k=64 w={window}")
        padded = list(sched) + [-2, -2, -2]
        got, _, _ = compare(
            "B1", lambda: b1(eng.ctx, x, padded, window, fin=fin),
            lambda: b1_plain(eng.ctx, x, padded, window, fin=fin),
            f"k=64 fin -2 w={window}")
        check_pow(eng, xs, [e] * 16, fs, got, 16, f"B1 k=64 fin w={window}")
    for window in (2, 4, 5):
        e = rng.getrandbits(120) | (1 << 119)
        nd = n_digits_for_bits(120, window)
        shared = torch.as_tensor(exp_digits(e, window, nd), device=dev)
        got, _, _ = compare("B2", lambda: b2(eng.ctx, x, shared, window),
                            lambda: b2_plain(eng.ctx, x, shared, window),
                            f"k=64 shared w={window}")
        check_pow(eng, xs, [e] * 16, [1] * 16, got, 16, f"B2 k=64 w={window}")
        es = [rng.getrandbits(120) for _ in range(15)] + [0]
        per = torch.as_tensor(np.stack([exp_digits(v, window, nd)
                                        for v in es]), device=dev)
        got, _, _ = compare("B2", lambda: b2(eng.ctx, x, per, window),
                            lambda: b2_plain(eng.ctx, x, per, window),
                            f"k=64 per-row w={window}")
        check_pow(eng, xs, es, [1] * 16, got, 16, f"B2 k=64 per-row w={window}")
    # B3 at k = 64: a comb of 15 digits, with and without fin
    base = rng.randrange(2, n256)
    es = [rng.getrandbits(60) for _ in range(15)] + [0]
    nd = n_digits_for_bits(60, 4)
    table = build_fixed_base_table(eng, base, nd, 4)
    per = torch.as_tensor(np.stack([exp_digits(v, 4, nd) for v in es]),
                          device=dev)
    for f_ops, f_vals in ((None, [1] * 16), (fin, fs)):
        got, _, _ = compare(
            "B3", lambda: b3(eng.ctx, table, per, 4, fin=f_ops),
            lambda: b3_plain(eng.ctx, table, per, 4, fin=f_ops),
            f"k=64 comb fin={f_ops is not None}")
        check_pow(eng, [base] * 16, es, f_vals, got, 16, "B3 k=64")

    def check_limbs(got, xs, es, ns, rows, label):
        want = [pow(x, e, m) for x, e, m in zip(xs[:rows], es[:rows],
                                                ns[:rows])]
        if bhost.limbs_to_ints(got[:rows].cpu().numpy()) != want:
            fail(f"kernel output != Python pow ({label})")

    def limbs(vals, L):
        return torch.as_tensor(bhost.ints_to_limbs(vals, L).astype(np.int64),
                               device=dev)

    # B4 at L = 16: shared and per-row digits, per-row moduli
    ctx256 = make_mont_ctx(n256, device=dev)
    xl = limbs(xs, 16)
    es = [rng.getrandbits(120) for _ in range(15)] + [0]
    nd = n_digits_for_bits(120, 4)
    per = torch.as_tensor(np.stack([exp_digits(v, 4, nd) for v in es]),
                          device=dev)
    for digits, want_e in ((per, es), (per[0], [es[0]] * 16)):
        got, _, _ = compare("B4", lambda: b4(ctx256, xl, digits, 4),
                            lambda: b4_plain(ctx256, xl, digits, 4),
                            f"L=16 digits {tuple(digits.shape)}")
        check_limbs(got, xs, want_e, [n256] * 16, 16, "B4 L=16")
    moduli = [rng.getrandbits(256) | (1 << 255) | 1 for _ in range(16)]
    sctx = stack_mont_ctx(moduli, 16, device=dev)
    got, _, _ = compare("B4", lambda: b4(sctx, xl, per, 4),
                        lambda: b4_plain(sctx, xl, per, 4),
                        "L=16 per-row moduli")
    check_limbs(got, xs, es, moduli, 16, "B4 L=16 per-row moduli")
    phase("kernel", f"k=64 / L=16: " + ", ".join(
        f"{k} {v['n']}" for k, v in stats.items()) + " ladders bit-identical "
          f"to plain and to pow ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    skey, pk = keygen(KEY_BITS, random.Random(SEED), device_primes=False)
    phase("main", f"keygen({KEY_BITS}) in {time.perf_counter() - t0:.2f} s")
    dk = pk.device(dev)

    b1_lib = sk_mod.load()

    def b1_tile(eng, rows, sched, ms):
        """Tile rows and us per Montgomery multiply of a timed B1 shape,
        with the L2 bytes per multiply its shape implies (blocks x both
        [2k, 2k] int8 matrices, each read once per block; not a counter)
        and the read rate that implies at the measured time."""
        k = eng.spec.k
        tile = b1_lib.rns2_sliding_rows(rows, k)
        mults = (1 << 5) + 2 + int((sched[1:] >= -1).sum()) + \
            int((sched[1:] >= 0).sum())                    # window 6
        l2 = -(-rows // tile) * 2 * (2 * k) ** 2
        us = ms * 1e3 / mults
        return (f"tile {tile} rows, {us:.2f} us per multiply ({mults}); "
                f"implied L2 reads {l2 / 1e6:.1f} MB per multiply, "
                f"{l2 / us / 1e6:.2f} TB/s")

    def b1_other_fin(eng, with_fin):
        """B1 the other way round from the main shape: 33 rows, a 256-bit
        exponent, with or without fin."""
        N = eng.spec.N
        xs = [rng.randrange(1, N) for _ in range(33)]
        fs = [rng.randrange(N) for _ in range(33)] if with_fin else [1] * 33
        x = residues(eng, xs)
        f = residues(eng, fs) if with_fin else None
        e = rng.getrandbits(256) | (1 << 255)
        sched = sliding_window_schedule(e, 6)
        label = f"k={eng.spec.k} rows=33 e=256-bit fin={with_fin}"
        got, _, _ = compare("B1", lambda: b1(eng.ctx, x, sched, 6, fin=f),
                            lambda: b1_plain(eng.ctx, x, sched, 6, fin=f),
                            label)
        check_pow(eng, xs, [e] * 4, fs, got, 4, f"B1 {label}")

    # B1 at the main path's shapes: k = 320 (r^n * G^m mod n^2) and k = 192
    # (c^(p-1) mod p^2), BATCH rows
    t0 = time.perf_counter()
    eng_n2 = dk.rns(1)
    xs = [rng.randrange(1, pk.n2) for _ in range(BATCH)]
    fs = [rng.randrange(pk.n2) for _ in range(BATCH)]
    x, fin = residues(eng_n2, xs), residues(eng_n2, fs)
    sched = sliding_window_schedule(pk.n, 6)
    got, b1_ms, b1_plain_ms = compare(
        "B1", lambda: b1(eng_n2.ctx, x, sched, 6, fin=fin),
        lambda: b1_plain(eng_n2.ctx, x, sched, 6, fin=fin),
        f"k={eng_n2.spec.k} rows={BATCH} e=n fin", warm=True)
    check_pow(eng_n2, xs, [pk.n] * 4, fs, got, 4, "B1 k=320")
    phase("kernel", f"B1 k={eng_n2.spec.k}, {BATCH} rows, e=n "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {b1_ms:.3f} ms, plain {b1_plain_ms:.3f} ms; "
          f"{b1_tile(eng_n2, BATCH, sched, b1_ms)}")
    b1_other_fin(eng_n2, False)

    # B1 at the threshold path's shape: partial decryption's shared
    # exponent 2*delta*s_i (~4,100 bits) at k = 320; 33 rows against plain
    # and pow, then BATCH rows timed
    e_thr = rng.getrandbits(THR_E_BITS) | (1 << (THR_E_BITS - 1))
    sched_thr = sliding_window_schedule(e_thr, 6)
    xs = [rng.randrange(1, pk.n2) for _ in range(BATCH)]
    x = residues(eng_n2, xs)
    got, _, _ = compare(
        "B1", lambda: b1(eng_n2.ctx, x[:33], sched_thr, 6),
        lambda: b1_plain(eng_n2.ctx, x[:33], sched_thr, 6),
        f"k={eng_n2.spec.k} rows=33 e={THR_E_BITS}-bit")
    check_pow(eng_n2, xs, [e_thr] * 4, [1] * 4, got, 4, "B1 4100-bit e")
    b1(eng_n2.ctx, x[:64], sched_thr, 6)                           # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    b1(eng_n2.ctx, x, sched_thr, 6)
    ev[1].record()
    torch.cuda.synchronize()
    thr_ms = {"B1": ev[0].elapsed_time(ev[1])}
    stats["B1"]["times"].append({"shape": f"k={eng_n2.spec.k} rows={BATCH} "
                                 f"e={THR_E_BITS}-bit (no plain run)",
                                 "ms": thr_ms["B1"], "plain_ms": None})
    phase("kernel", f"B1 k={eng_n2.spec.k}, {THR_E_BITS}-bit e (partial "
          f"decryption's 2*delta*s_i; {len(sched_thr) - 1} steps): 33 rows "
          f"bit-identical to plain and to pow; {BATCH} rows "
          f"{thr_ms['B1']:.3f} ms, "
          f"{b1_tile(eng_n2, BATCH, sched_thr, thr_ms['B1'])}")

    p2 = skey.p * skey.p
    eng_p2 = Rns2Engine(p2, device=dev)
    xs = [rng.randrange(1, p2) for _ in range(BATCH)]
    x = residues(eng_p2, xs)
    sched = sliding_window_schedule(skey.p - 1, 6)
    got, ms, plain_ms = compare(
        "B1", lambda: b1(eng_p2.ctx, x, sched, 6),
        lambda: b1_plain(eng_p2.ctx, x, sched, 6),
        f"k={eng_p2.spec.k} rows={BATCH} e=p-1", warm=True)
    check_pow(eng_p2, xs, [skey.p - 1] * 4, [1] * 4, got, 4, "B1 k=192")
    phase("kernel", f"B1 k={eng_p2.spec.k}, {BATCH} rows, e=p-1 "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"{b1_tile(eng_p2, BATCH, sched, ms)}")
    b1_other_fin(eng_p2, True)

    # B1 wide: k = 512 (level-2 encryption's r^(n^2) mod n^3), k = 704
    eng_n3 = dk.rns(2)
    xs = [rng.randrange(1, pk.n3) for _ in range(L2_BATCH)]
    x = residues(eng_n3, xs)
    sched = sliding_window_schedule(pk.n2, 6)
    got, b1w_ms, b1w_plain_ms = compare(
        "B1", lambda: b1(eng_n3.ctx, x, sched, 6),
        lambda: b1_plain(eng_n3.ctx, x, sched, 6),
        f"k={eng_n3.spec.k} rows={L2_BATCH} e=n^2", warm=True)
    check_pow(eng_n3, xs, [pk.n2] * 4, [1] * 4, got, 4, "B1 k=512")
    phase("kernel", f"B1 k={eng_n3.spec.k}, {L2_BATCH} rows, e=n^2 mod n^3 "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {b1w_ms:.3f} ms, plain {b1w_plain_ms:.3f} ms; "
          f"{b1_tile(eng_n3, L2_BATCH, sched, b1w_ms)}")
    b1_other_fin(eng_n3, True)

    n8192 = rng.getrandbits(8192) | (1 << 8191) | 1
    eng_w = Rns2Engine(n8192, device=dev)
    if eng_w.spec.k != 704:
        fail(f"8192-bit modulus gave k={eng_w.spec.k}, expected 704")
    xs = [rng.randrange(n8192) for _ in range(64)]
    fs = [rng.randrange(n8192) for _ in range(64)]
    x, fin = residues(eng_w, xs), residues(eng_w, fs)
    e = rng.getrandbits(2048) | (1 << 2047)
    sched = sliding_window_schedule(e, 6)
    got, ms, plain_ms = compare(
        "B1", lambda: b1(eng_w.ctx, x, sched, 6, fin=fin),
        lambda: b1_plain(eng_w.ctx, x, sched, 6, fin=fin),
        "k=704 rows=64 e=2048-bit fin", warm=True)
    check_pow(eng_w, xs, [e] * 4, fs, got, 4, "B1 k=704")
    phase("kernel", f"B1 k=704, 64 rows, 2048-bit e with fin "
          f"({len(sched) - 1} steps): bit-identical to plain and to pow; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"{b1_tile(eng_w, 64, sched, ms)}")
    b1_other_fin(eng_w, False)
    del eng_w, x, fin

    b2_lib = mx_mod.load()

    def b2_tile(eng, rows, nd, ms):
        """Tile rows and us per Montgomery multiply of a timed B2 shape
        (window 4: 14 table multiplies, 5 a digit, entry and exit)."""
        mults = 1 + 14 + 5 * nd + 1
        return (f"tile {b2_lib.rns2_modexp_rows(rows, eng.spec.k)} rows, "
                f"{ms * 1e3 / mults:.2f} us per multiply ({mults})")

    # B2 at the slice's shapes: per-row 2048-bit exponents at k = 320
    # (const_mult), per-row ciphertext digits at k = 512 (nested_add)
    xs = [rng.randrange(1, pk.n2) for _ in range(BATCH)]
    es = [rng.randrange(pk.n) for _ in range(BATCH)]
    x = residues(eng_n2, xs)
    nd = n_digits_for_bits(max(v.bit_length() for v in es), 4)
    per = torch.as_tensor(np.stack([exp_digits(v, 4, nd) for v in es]),
                          device=dev)
    got, b2_ms, b2_plain_ms = compare(
        "B2", lambda: b2(eng_n2.ctx, x, per, 4),
        lambda: b2_plain(eng_n2.ctx, x, per, 4),
        f"k={eng_n2.spec.k} rows={BATCH} per-row {nd} digits", warm=True)
    check_pow(eng_n2, xs, es, [1] * 4, got, 4, "B2 k=320")
    b2_nd = nd
    phase("kernel", f"B2 k={eng_n2.spec.k}, {BATCH} rows, per-row {nd} "
          f"digits: bit-identical to plain and to pow; kernel "
          f"{b2_ms:.3f} ms, plain {b2_plain_ms:.3f} ms; "
          f"{b2_tile(eng_n2, BATCH, nd, b2_ms)}")

    # B2 at the threshold path's shape: combine's Lagrange ladder over the
    # 3 servers' stacked rows, each row the 4 digits of its server's
    # |2 lambda| (servers {1, 2, 3} of l = 5: 720, 720, 240)
    rows = 3 * BATCH
    xs = [rng.randrange(1, pk.n2) for _ in range(rows)]
    x = residues(eng_n2, xs)
    es = [v for v in (720, 720, 240) for _ in range(BATCH)]
    per = torch.as_tensor(np.stack([exp_digits(v, 4, 4) for v in es]),
                          device=dev)
    got, ms, plain_ms = compare(
        "B2", lambda: b2(eng_n2.ctx, x, per, 4),
        lambda: b2_plain(eng_n2.ctx, x, per, 4),
        f"k={eng_n2.spec.k} rows={rows} per-row 4 digits", warm=True)
    check_pow(eng_n2, xs[::BATCH], es[::BATCH], [1] * 3, got[::BATCH], 3,
              "B2 stacked rows")
    thr_ms["B2"] = ms
    phase("kernel", f"B2 k={eng_n2.spec.k}, {rows} stacked rows, per-row 4 "
          f"digits (the Lagrange ladder): bit-identical to plain and to "
          f"pow; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"{b2_tile(eng_n2, rows, 4, ms)}")

    mrng = random.Random(SEED + 3)
    c1 = Encryptor(pk, device=dev, rng=mrng).encrypt(
        [mrng.randrange(pk.n) for _ in range(L2_BATCH)])
    dig = limbs_to_digits(c1.c, 4)
    es = decode_batch(c1.c)
    xs = [rng.randrange(1, pk.n3) for _ in range(L2_BATCH)]
    x = residues(eng_n3, xs)
    got, b2w_ms, b2w_plain_ms = compare(
        "B2", lambda: b2(eng_n3.ctx, x, dig, 4),
        lambda: b2_plain(eng_n3.ctx, x, dig, 4),
        f"k={eng_n3.spec.k} rows={L2_BATCH} per-row {dig.shape[-1]} digits",
        warm=True)
    check_pow(eng_n3, xs, es, [1] * 4, got, 4, "B2 k=512")
    phase("kernel", f"B2 k={eng_n3.spec.k}, {L2_BATCH} rows, per-row "
          f"{dig.shape[-1]} digits of level-1 ciphertexts: bit-identical "
          f"to plain and to pow; kernel {b2w_ms:.3f} ms, plain "
          f"{b2w_plain_ms:.3f} ms; "
          f"{b2_tile(eng_n3, L2_BATCH, dig.shape[-1], b2w_ms)}; "
          f"comparisons B1 {stats['B1']['n']}, "
          f"B2 {stats['B2']['n']}, max |diff| "
          f"{max(stats['B1']['err'], stats['B2']['err'])} "
          f"({time.perf_counter() - t0:.1f} s)")
    del x, got

    # B1 and B2 at DDLEQ's shapes (bench.py's ddleq chunk: 128 proofs x
    # secpar 40 = DD_ROWS rows): the prover's p^3 half at k = 256 (B1:
    # y^(n^2 mod p^2(p-1)); B2: 1,024 per-row digits of x^n), against
    # plain on all rows, on the prover's own engine; the verifier's
    # k = 512 ladders (B1: f^(n^2); B2: 1,024 digits of e^n) timed on all
    # rows, 4 rows against pow (the same exponents run against plain at
    # L2_BATCH rows above)
    t0 = time.perf_counter()
    eng_p3 = zd.crt_plans(skey, dev).eng_p
    p3 = eng_p3.spec.N
    dd_e = pk.n2 % (skey.p * skey.p * (skey.p - 1))
    dd_sched = sliding_window_schedule(dd_e, 6)
    xs = [rng.randrange(1, p3) for _ in range(DD_ROWS)]
    x = residues(eng_p3, xs)
    got, dd_b1_ms, dd_b1_plain_ms = compare(
        "B1", lambda: b1(eng_p3.ctx, x, dd_sched, 6),
        lambda: b1_plain(eng_p3.ctx, x, dd_sched, 6),
        f"k={eng_p3.spec.k} rows={DD_ROWS} e={dd_e.bit_length()}-bit",
        warm=True)
    check_pow(eng_p3, xs, [dd_e] * 4, [1] * 4, got, 4, "B1 k=256")
    phase("kernel", f"B1 k={eng_p3.spec.k} (p^3), {DD_ROWS} rows, "
          f"{dd_e.bit_length()}-bit e ({len(dd_sched) - 1} steps): "
          f"bit-identical to plain and to pow; kernel {dd_b1_ms:.3f} ms, "
          f"plain {dd_b1_plain_ms:.3f} ms; "
          f"{b1_tile(eng_p3, DD_ROWS, dd_sched, dd_b1_ms)}")
    es = [rng.randrange(pk.n2) for _ in range(DD_ROWS)]
    dd_dig = limbs_to_digits(limbs(es, 2 * dk.L), 4)
    got, dd_b2_ms, dd_b2_plain_ms = compare(
        "B2", lambda: b2(eng_p3.ctx, x, dd_dig, 4),
        lambda: b2_plain(eng_p3.ctx, x, dd_dig, 4),
        f"k={eng_p3.spec.k} rows={DD_ROWS} per-row {dd_dig.shape[-1]} "
        f"digits", warm=True)
    check_pow(eng_p3, xs, es, [1] * 4, got, 4, "B2 k=256")
    phase("kernel", f"B2 k={eng_p3.spec.k} (p^3), {DD_ROWS} rows, per-row "
          f"{dd_dig.shape[-1]} digits: bit-identical to plain and to pow; "
          f"kernel {dd_b2_ms:.3f} ms, plain {dd_b2_plain_ms:.3f} ms; "
          f"{b2_tile(eng_p3, DD_ROWS, dd_dig.shape[-1], dd_b2_ms)}")
    xs = [rng.randrange(1, pk.n3) for _ in range(DD_ROWS)]
    x = residues(eng_n3, xs)
    sched_n2 = sliding_window_schedule(pk.n2, 6)
    dd_wide = {}
    for kname, run_k, es_k in (
            ("B1", lambda: b1(eng_n3.ctx, x, sched_n2, 6), [pk.n2] * 4),
            ("B2", lambda: b2(eng_n3.ctx, x, dd_dig, 4), es)):
        run_k()                                                    # warm
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = run_k()
        ev[1].record()
        torch.cuda.synchronize()
        check_pow(eng_n3, xs, es_k, [1] * 4, got, 4, f"{kname} k=512 DDLEQ")
        dd_wide[kname] = ms = ev[0].elapsed_time(ev[1])
        stats[kname]["times"].append({"shape": f"k={eng_n3.spec.k} "
                                      f"rows={DD_ROWS} (DDLEQ verifier; "
                                      f"no plain run)", "ms": ms,
                                      "plain_ms": None})
    phase("kernel", f"DDLEQ verifier at k={eng_n3.spec.k}, {DD_ROWS} rows "
          f"(4 rows equal pow): B1 f^(n^2) "
          f"{dd_wide['B1']:.3f} ms, "
          f"{b1_tile(eng_n3, DD_ROWS, sched_n2, dd_wide['B1'])}; B2 "
          f"{dd_dig.shape[-1]} digits {dd_wide['B2']:.3f} ms, "
          f"{b2_tile(eng_n3, DD_ROWS, dd_dig.shape[-1], dd_wide['B2'])} "
          f"({time.perf_counter() - t0:.1f} s)")
    del x, got

    # B3 at the main path's shapes: h1's comb at k = 320 on BATCH rows and
    # h2's at k = 512 on L2_BATCH rows, 256 per-row digits of r < K, fin
    t0 = time.perf_counter()
    b3_lib = fb_mod.load()
    r_bits = pk.k.bit_length() - 1
    nd_r = n_digits_for_bits(r_bits, 4)
    b3_shapes = {}
    for level, rows, eng_l in ((1, BATCH, eng_n2), (2, L2_BATCH, eng_n3)):
        table = dk.comb_table(level, 4)
        hs = dk.hs_int_for_level(level)
        N = eng_l.spec.N
        es = [rng.randrange(pk.k) for _ in range(rows)]
        fs = [rng.randrange(N) for _ in range(rows)]
        per = limbs_to_digits(limbs(es, bhost.limbs_for_bits(r_bits)), 4, nd_r)
        fin = residues(eng_l, fs)
        got, ms, plain_ms = compare(
            "B3", lambda: b3(eng_l.ctx, table, per, 4, fin=fin),
            lambda: b3_plain(eng_l.ctx, table, per, 4, fin=fin),
            f"k={eng_l.spec.k} rows={rows} comb {nd_r} digits fin", warm=True)
        check_pow(eng_l, [hs] * HOST_ROWS, es, fs, got, HOST_ROWS,
                  f"B3 k={eng_l.spec.k}")
        b3_shapes[level] = dict(ms=ms, plain_ms=plain_ms, rows=rows,
                                k=eng_l.spec.k, D=nd_r, table=table)
        # nd_r multiplies: nd_r - 1 comb steps and the exit
        phase("kernel", f"B3 k={eng_l.spec.k}, {rows} rows, {nd_r} per-row "
              f"digits with fin: bit-identical to plain, {HOST_ROWS} rows to "
              f"pow; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; tile "
              f"{b3_lib.rns2_fixed_base_rows(rows, eng_l.spec.k)} rows, "
              f"{ms * 1e3 / nd_r:.2f} us per multiply ({nd_r})")
    del got

    # B4 at L = 128 (mod n): BATCH rows against plain over a 32-digit
    # exponent; the full exponent of extract_randomness on BATCH and on
    # L2_BATCH rows (64 and 16 against pow); 64 per-row 1024-bit moduli
    # with per-row exponents

    def b4_shape(L, rows, nd, ms):
        """Lanes per row and us per Montgomery product of a timed B4 shape
        (window 4: 16 table products, 5 a digit, the exit)."""
        prods = 16 + 5 * nd + 1
        lanes = mk_mod.lanes_per_row(-(-L // 2), rows, torch.cuda.
                                     get_device_properties(0).
                                     multi_processor_count)
        return (f"{lanes} lanes per row, "
                f"{ms * 1e3 / prods:.2f} us per product ({prods})")

    L = dk.L
    ctx_n = dk.mont_ctx_n()
    xs = [rng.randrange(pk.n) for _ in range(BATCH)]
    xl = limbs(xs, L)
    e32 = rng.getrandbits(128) | (1 << 127)
    d32 = torch.as_tensor(exp_digits(e32, 4, 32), device=dev)
    got, b4_ms, b4_plain_ms = compare(
        "B4", lambda: b4(ctx_n, xl, d32, 4), lambda: b4_plain(ctx_n, xl, d32, 4),
        f"L={L} rows={BATCH} shared 32 digits", warm=True)
    check_limbs(got, xs, [e32] * 64, [pk.n] * 64, 64, "B4 L=128 32 digits")
    e_full = pow(pk.n, -1, skey.lam)
    nd_full = n_digits_for_bits(e_full.bit_length(), 4)
    d_full = torch.as_tensor(exp_digits(e_full, 4, nd_full), device=dev)
    b4(ctx_n, xl[:64], d_full, 4)                                  # warm
    b4_full = {}
    for rows, n_pow in ((BATCH, 64), (L2_BATCH, 16)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = b4(ctx_n, xl[:rows], d_full, 4)
        ev[1].record()
        torch.cuda.synchronize()
        b4_full[rows] = ev[0].elapsed_time(ev[1])
        check_limbs(got, xs, [e_full] * n_pow, [pk.n] * n_pow, n_pow,
                    f"B4 L=128 full e, {rows} rows")
        stats["B4"]["times"].append({"shape": f"L={L} rows={rows} shared "
                                     f"{nd_full} digits (no plain run)",
                                     "ms": b4_full[rows], "plain_ms": None})
    cands = kg_mod.sieve_candidates(KEY_BITS // 2, 64, random.Random(SEED + 7))
    Lh = bhost.limbs_for_bits(KEY_BITS // 2)
    sctx = stack_mont_ctx(cands, Lh, device=dev)
    es = [c - 1 for c in cands]
    xs64 = [rng.randrange(2, c) for c in cands]
    dig = limbs_to_digits(limbs(es, Lh), 4)
    xl64 = limbs(xs64, Lh)
    es32 = [e % (1 << 128) for e in es]          # the last 32 digits
    got, _, _ = compare("B4", lambda: b4(sctx, xl64, dig[:, -32:], 4),
                        lambda: b4_plain(sctx, xl64, dig[:, -32:], 4),
                        f"L={Lh} rows=64 per-row moduli, 32 digits")
    check_limbs(got, xs64, es32, cands, 64, "B4 per-row moduli, 32 digits")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = b4(sctx, xl64, dig, 4)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    check_limbs(got, xs64, es, cands, 64, "B4 per-row 1024-bit moduli")
    stats["B4"]["times"].append({"shape": f"L={Lh} rows=64 per-row moduli, "
                                 f"{dig.shape[-1]} digits (no plain run)",
                                 "ms": ms, "plain_ms": None})
    phase("kernel", f"B4 L={L}, {BATCH} rows: 32 digits bit-identical to "
          f"plain (kernel {b4_ms:.3f} ms, plain {b4_plain_ms:.3f} ms; "
          f"{b4_shape(L, BATCH, 32, b4_ms)})")
    for rows, ms_r in b4_full.items():
        phase("kernel", f"B4 L={L}, {rows} rows, {nd_full} digits "
              f"(extract_randomness' exponent): {ms_r:.3f} ms, "
              f"{64 if rows == BATCH else 16} rows equal pow; "
              f"{b4_shape(L, rows, nd_full, ms_r)}")
    phase("kernel", f"B4 L={Lh}, 64 per-row moduli and per-row digits: "
          f"32 digits bit-identical to plain and to pow; "
          f"{dig.shape[-1]} digits {ms:.3f} ms, equal to pow; "
          f"{b4_shape(Lh, 64, dig.shape[-1], ms)}")
    # B4 at L = 256 (mod n^2): the threshold verification keys' ladder, 5
    # rows with per-row 1,025-digit exponents; 32 digits against plain,
    # all against pow
    ctx_n2 = make_mont_ctx(pk.n2, device=dev)
    L4 = ctx_n2.n_limbs
    xs5 = [rng.randrange(pk.n2) for _ in range(5)]
    es5 = [rng.getrandbits(THR_E_BITS) | (1 << (THR_E_BITS - 1))
           for _ in range(5)]
    nd5 = n_digits_for_bits(THR_E_BITS, 4)
    dig5 = torch.as_tensor(np.stack([exp_digits(e, 4, nd5) for e in es5]),
                           device=dev)
    xl5 = limbs(xs5, L4)
    got, _, _ = compare("B4", lambda: b4(ctx_n2, xl5, dig5[:, -32:], 4),
                        lambda: b4_plain(ctx_n2, xl5, dig5[:, -32:], 4),
                        f"L={L4} rows=5 per-row, 32 digits")
    check_limbs(got, xs5, [e % (1 << 128) for e in es5], [pk.n2] * 5, 5,
                "B4 L=256, 32 digits")
    b4(ctx_n2, xl5, dig5, 4)                                       # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = b4(ctx_n2, xl5, dig5, 4)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    check_limbs(got, xs5, es5, [pk.n2] * 5, 5, "B4 L=256 full e")
    thr_ms["B4"] = ms
    stats["B4"]["times"].append({"shape": f"L={L4} rows=5 per-row {nd5} "
                                 f"digits (no plain run)", "ms": ms,
                                 "plain_ms": None})
    phase("kernel", f"B4 L={L4}, 5 rows, per-row {nd5} digits (the "
          f"threshold verification keys): 32 digits bit-identical to plain "
          f"and to pow, all {nd5} equal to pow; {ms:.3f} ms; "
          f"{b4_shape(L4, 5, nd5, ms)} ({time.perf_counter() - t0:.1f} s)")
    del got, xl

    launches = {kname: 0 for kname in wrappers}
    op_s: dict = {}

    def counts():
        return {kname: w.launches for kname, w in wrappers.items()}

    def timed(name, fn, b1_want=0, b2_want=0, b3_want=0, b4_want=0):
        """fn() between two synchronisations; its seconds go to op_s.
        Fails unless fn launched B1, B2, B3 and B4 exactly as often as
        its entry point does."""
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        op_s[name] = time.perf_counter() - t
        got = tuple(v - before[k] for k, v in counts().items())
        want = (b1_want, b2_want, b3_want, b4_want)
        if got != want:
            fail(f"{name} launched (B1, B2, B3, B4) {got}, expected {want}: "
                 f"an operation bypassed its kernel")
        return res

    def op_line():
        line = ", ".join(f"{k} {v:.4f}" for k, v in op_s.items())
        op_s.clear()
        return line

    def run_path(name, ops, want):
        """Counters to 0, ops(), counters read; fail unless each kernel
        was launched exactly ``want[kname]`` times (the count its entry
        points make; a kernel not named: 0).  ``want`` may be a function
        of ops()' result.  Returns (result, seconds)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ops()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = counts()
        want = want(res) if callable(want) else want
        want = {kname: want.get(kname, 0) for kname in wrappers}
        if got != want:
            fail(f"{name} launched {got}, expected {want}: an operation "
                 f"bypassed its kernel")
        for kname in got:
            launches[kname] += got[kname]
        phase(name, f"{dt:.4f} s; launches " + ", ".join(
            f"{k} {v}" for k, v in got.items()))
        return res, dt

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

    # one B1 ladder for r^n; two for CRT decryption (c^(p-1), c^(q-1))
    ct, t_enc = run_path("main", lambda: enc.encrypt(ms, rs),
                         {"B1": 1, "B2": 0})
    out, t_dec = run_path("main", lambda: dec.decrypt(ct),
                          {"B1": 2, "B2": 0})
    if tuple(ct.c.shape) != (BATCH, 2 * dk.L):
        fail(f"ciphertext shape {tuple(ct.c.shape)}")
    if out != ms:
        bad = sum(a != b for a, b in zip(out, ms))
        fail(f"{bad} of {BATCH} ciphertexts did not decrypt to their plaintext")
    host = [(1 + m * pk.n) * pow(r, pk.n, pk.n2) % pk.n2
            for m, r in zip(ms[:16], rs[:16])]
    if decode_batch(ct.c[:16]) != host:
        fail("ciphertexts differ from (1 + m*n) * r^n mod n^2")
    phase("main", f"encrypt {BATCH} x {KEY_BITS}-bit: {t_enc:.4f} s, "
          f"{BATCH / t_enc:.1f} enc/s; CRT decrypt: {t_dec:.4f} s, "
          f"{BATCH / t_dec:.1f} dec/s; all {BATCH} round-trip, 16 equal "
          f"the host formula")

    # -- 5. homomorphic, level 1 -------------------------------------------
    t0 = time.perf_counter()
    n, n2 = pk.n, pk.n2
    hrng = random.Random(SEED + 4)
    xs = [hrng.randrange(n) for _ in range(BATCH)]
    ys = [hrng.randrange(n) for _ in range(BATCH)]
    cx, cy = enc.encrypt(xs), enc.encrypt(ys)
    k_shared = hrng.randrange(n)
    ks = [hrng.randrange(n) for _ in range(BATCH)]
    zrng = random.Random(SEED + 5)
    z_state = zrng.getstate()
    tile = Ciphertext(c=cx.c.repeat(AGG_TILE // BATCH, 1))
    chunks = [Ciphertext(c=part) for part in tile.c.chunk(4)]
    cx_h, cy_h = decode_batch(cx.c[:HOST_ROWS]), decode_batch(cy.c[:HOST_ROWS])
    phase("homomorphic", f"inputs: 2 x {BATCH} encryptions, a {AGG_TILE}-row "
          f"tile ({time.perf_counter() - t0:.2f} s)")

    def hom_ops():
        # add, sub and the aggregates are RNS products in plain torch
        return dict(
            add=timed("add", lambda: hom.add(pk, cx, cy), 0),
            sub=timed("sub", lambda: hom.sub(pk, cx, cy), 0),
            cm_shared=timed("const_mult shared",
                            lambda: hom.const_mult(pk, cx, k_shared), 1),
            cm_per=timed("const_mult per-element",
                         lambda: hom.const_mult(pk, cx, ks), 0, 1),
            rnd=timed("randomize", lambda: hom.randomize(pk, cx, zrng), 1),
            agg=timed("aggregate", lambda: hom.aggregate(pk, tile), 0),
            stream=timed("aggregate_streaming",
                         lambda: hom.aggregate_streaming(pk, chunks), 0),
            plain=timed("Decryptor(crt=False)", lambda: Decryptor(
                skey, device=dev).decrypt_array(cx), 1))

    res, t_hom = run_path("homomorphic", hom_ops, {"B1": 3, "B2": 1})
    phase("homomorphic", f"seconds: {op_line()}")
    zrng.setstate(z_state)
    zr = random_units(n, HOST_ROWS, zrng)
    agg_sum = sum(xs) * (AGG_TILE // BATCH) % n
    agg_host = 1
    for c in decode_batch(tile.c):
        agg_host = agg_host * c % n2
    checks = [
        ("add", res["add"], [(a + b) % n for a, b in zip(xs, ys)],
         [a * b % n2 for a, b in zip(cx_h, cy_h)]),
        ("sub", res["sub"], [(a - b) % n for a, b in zip(xs, ys)],
         [a * pow(b, -1, n2) % n2 for a, b in zip(cx_h, cy_h)]),
        ("const_mult shared", res["cm_shared"], [a * k_shared % n for a in xs],
         [pow(a, k_shared, n2) for a in cx_h]),
        ("const_mult per-element", res["cm_per"],
         [a * k % n for a, k in zip(xs, ks)],
         [pow(a, k, n2) for a, k in zip(cx_h, ks)]),
        ("randomize", res["rnd"], xs,
         [a * pow(r, n, n2) % n2 for a, r in zip(cx_h, zr)]),
    ]
    for name, got, want, host in checks:
        if dec.decrypt(got) != want:
            fail(f"homomorphic {name}: decryption != plaintext arithmetic")
        if decode_batch(got.c[:HOST_ROWS]) != host:
            fail(f"homomorphic {name}: ciphertexts != host formula")
    for name in ("agg", "stream"):
        got = res[name]
        if dec.decrypt(Ciphertext(c=got.c[None])) != [agg_sum]:
            fail(f"homomorphic {name}: decryption != sum of the tile")
        if decode_batch(got.c[None]) != [agg_host]:
            fail(f"homomorphic {name}: != host product of the tile")
    if decode_batch(res["plain"]) != xs:
        fail("Decryptor(crt=False) != plaintexts")
    phase("homomorphic", f"add, sub, const_mult (shared, per-element), "
          f"randomize on {BATCH}, aggregate over {AGG_TILE} and "
          f"aggregate_streaming over 4 chunks, Decryptor(crt=False) on "
          f"{BATCH}: every check passed "
          f"({time.perf_counter() - t0:.1f} s in all)")

    # -- 6. level 2 --------------------------------------------------------
    t0 = time.perf_counter()
    lrng = random.Random(SEED + 6)
    n3 = pk.n3
    m2 = [lrng.randrange(n2) for _ in range(L2_BATCH)]
    r2 = random_units(n, L2_BATCH, lrng)
    xs = [lrng.randrange(n) for _ in range(L2_BATCH)]
    ys = [lrng.randrange(n) for _ in range(L2_BATCH)]
    enc2 = Encryptor(pk, 2, device=dev, rng=lrng)
    dec2 = Decryptor(skey, 2, device=dev)
    yct = enc.encrypt(ys)
    phase("level2", f"set-up {time.perf_counter() - t0:.2f} s")

    def l2_ops():
        # nested_encrypt: one B1 ladder per level; nested_randomize: a^n
        # and b^(n^2) on B1, ct^(a^n) on B2; nested_decrypt: the
        # generic decryption at level 2, then at level 1
        c2 = timed("encrypt", lambda: enc2.encrypt(m2, r2), 1)
        back = timed("decrypt", lambda: dec2.decrypt(c2), 1)
        nx = timed("nested_encrypt",
                   lambda: nested_encrypt(pk, xs, lrng, device=dev), 2)
        na = timed("nested_add", lambda: hom.nested_add(pk, nx, yct), 0, 1)
        ns = timed("nested_sub", lambda: hom.nested_sub(pk, nx, yct), 0, 1)
        nr = timed("nested_randomize",
                   lambda: hom.nested_randomize(pk, nx, lrng)[0], 2, 1)
        return dict(c2=c2, back=back,
                    add=timed("nested_decrypt",
                              lambda: nested_decrypt(skey, na, device=dev), 2),
                    sub=timed("nested_decrypt (sub)",
                              lambda: nested_decrypt(skey, ns, device=dev), 2),
                    rnd=timed("nested_decrypt (randomize)",
                              lambda: nested_decrypt(skey, nr, device=dev), 2))

    res, t_l2 = run_path("level2", l2_ops, {"B1": 12, "B2": 3})
    phase("level2", f"seconds ({L2_BATCH} rows): {op_line()}")
    host = [pow(1 + n, m, n3) * pow(r, n2, n3) % n3
            for m, r in zip(m2[:HOST_ROWS], r2[:HOST_ROWS])]
    if decode_batch(res["c2"].c[:HOST_ROWS]) != host:
        fail("level-2 ciphertexts != (1+n)^m * r^(n^2) mod n^3")
    if res["back"] != m2:
        fail("Decryptor(sk, 2) did not round-trip")
    if res["add"] != [(a + b) % n for a, b in zip(xs, ys)]:
        fail("nested_add did not decrypt to x + y")
    if res["sub"] != [(a - b) % n for a, b in zip(xs, ys)]:
        fail("nested_sub did not decrypt to x - y")
    if res["rnd"] != xs:
        fail("nested_randomize did not decrypt to x")
    phase("level2", f"Encryptor(pk, 2) + Decryptor(sk, 2) on {L2_BATCH} "
          f"(8 equal the host formula), nested_encrypt -> nested_add / "
          f"nested_sub / nested_randomize -> nested_decrypt: every check "
          f"passed ({time.perf_counter() - t0:.1f} s in all)")

    # -- 7. alternative encryption ------------------------------------------
    t0 = time.perf_counter()
    arng = random.Random(SEED + 8)
    ms1 = [arng.randrange(n) for _ in range(BATCH)]
    rs1 = random_units(n, BATCH, arng)
    ms2 = [arng.randrange(n2) for _ in range(L2_BATCH)]
    rs2 = random_units(n, L2_BATCH, arng)
    alt1 = Encryptor(pk, 1, "alternative", device=dev, rng=arng)
    alt2 = Encryptor(pk, 2, "alternative", device=dev, rng=arng)
    dec.decrypt(alt1.encrypt(ms1[:WARM_ROWS], rs1[:WARM_ROWS]))   # warm-up
    phase("alternative", f"Encryptors built and warmed in "
          f"{time.perf_counter() - t0:.2f} s")

    def alt_ops():
        # one comb (B3) per encryption; CRT decryption two B1 ladders,
        # level-2 decryption one
        c1 = timed("alt encrypt L1", lambda: alt1.encrypt(ms1, rs1), 0, 0, 1)
        back1 = timed("CRT decrypt", lambda: dec.decrypt(c1), 2)
        c2 = timed("alt encrypt L2", lambda: alt2.encrypt(ms2, rs2), 0, 0, 1)
        back2 = timed("decrypt L2", lambda: dec2.decrypt(c2), 1)
        return dict(c1=c1, back1=back1, c2=c2, back2=back2)

    res, _ = run_path("alternative", alt_ops, {"B1": 3, "B3": 2})
    t_alt1, t_alt2 = op_s["alt encrypt L1"], op_s["alt encrypt L2"]
    phase("alternative", f"seconds: {op_line()}")
    h1, h2 = dk.hs_int_for_level(1), dk.hs_int_for_level(2)
    K = pk.k
    if res["c1"].method != "alternative" or res["c2"].method != "alternative":
        fail("alternative ciphertexts not marked as such")
    if decode_batch(res["c1"].c[:HOST_ROWS]) != [
            (1 + m * n) * pow(h1, r % K, n2) % n2
            for m, r in zip(ms1[:HOST_ROWS], rs1[:HOST_ROWS])]:
        fail("alternative level-1 ciphertexts != (1 + m*n) * h1^r mod n^2")
    if decode_batch(res["c2"].c[:HOST_ROWS]) != [
            pow(1 + n, m, n3) * pow(h2, r % K, n3) % n3
            for m, r in zip(ms2[:HOST_ROWS], rs2[:HOST_ROWS])]:
        fail("alternative level-2 ciphertexts != (1+n)^m * h2^r mod n^3")
    if res["back1"] != ms1 or res["back2"] != ms2:
        fail("alternative ciphertexts did not round-trip")
    phase("alternative", f"alt encrypt {BATCH} x {KEY_BITS}-bit at level 1: "
          f"{t_alt1:.4f} s, {BATCH / t_alt1:.1f} enc/s; {L2_BATCH} at level "
          f"2: {t_alt2:.4f} s, {L2_BATCH / t_alt2:.1f} enc/s; all round-trip, "
          f"{HOST_ROWS} of each equal the host formula "
          f"({time.perf_counter() - t0:.1f} s in all)")

    # -- 8. limb ladder: extract_randomness, device prime search -----------
    t0 = time.perf_counter()
    xrng = random.Random(SEED + 9)
    xm1 = [xrng.randrange(n) for _ in range(BATCH)]
    xr1 = random_units(n, BATCH, xrng)
    xm2 = [xrng.randrange(n2) for _ in range(L2_BATCH)]
    xr2 = random_units(n, L2_BATCH, xrng)
    xc1, xc2 = enc.encrypt(xm1, xr1), enc2.encrypt(xm2, xr2)
    phase("limb", f"inputs: {BATCH} level-1 and {L2_BATCH} level-2 "
          f"encryptions ({time.perf_counter() - t0:.2f} s)")

    def limb_ops():
        # each: the plain decryption (one B1 ladder), one B4 ladder mod n
        return dict(
            r1=timed("extract_randomness L1",
                     lambda: hom.extract_randomness(skey, xc1), 1, 0, 0, 1),
            r2=timed("extract_randomness L2",
                     lambda: hom.extract_randomness(skey, xc2), 1, 0, 0, 1))

    res, _ = run_path("limb", limb_ops, {"B1": 2, "B4": 2})
    phase("limb", f"seconds: {op_line()}")
    if res["r1"] != xr1 or res["r2"] != xr2:
        fail("extract_randomness did not return the encryption randomness")
    batches0 = kg_mod.device_batched_prime.batches
    (sk3, pk3), t_kg = run_path(
        "limb", lambda: keygen(KEY_BITS, random.Random(SEED + 1),
                               device_primes=True, device=dev),
        lambda _: {"B4": kg_mod.device_batched_prime.batches - batches0})
    fermat = kg_mod.device_batched_prime.batches - batches0
    for p_ in (sk3.p, sk3.q):
        if p_ % 4 != 3 or p_.bit_length() != KEY_BITS // 2 \
                or not bhost.is_probable_prime(p_, 30):
            fail("device prime search returned a bad prime")
    if pk3.n.bit_length() != KEY_BITS or sk3.p == sk3.q or fermat < 2:
        fail(f"device keygen: n of {pk3.n.bit_length()} bits, "
             f"{fermat} Fermat batches")
    phase("limb", f"extract_randomness returned all {BATCH} level-1 and "
          f"{L2_BATCH} level-2 rs; keygen({KEY_BITS}, device_primes=True) "
          f"in {t_kg:.3f} s: {fermat} Fermat batches of 64 = {fermat} B4 "
          f"launches, p and q pass Miller-Rabin, 3 mod 4 "
          f"({time.perf_counter() - t0:.1f} s in all)")
    # -- 9. probes: every variant against its plain version, then the path
    t0 = time.perf_counter()
    perr = {key: 0 for key in probe_wrappers}
    ncmp = 0

    for rows in (37, 300):
        for tile in probes.TILES:
            for case in probe_case_list:
                if not case.tiled and tile != 8:
                    continue           # P4's roll and P5 take no tile
                got, want = case.run(rows, tile, dev)
                for g, w in zip(got, want, strict=True):
                    err = int((g.long() - w.long()).abs().max())
                    perr[case.key] = max(perr[case.key], err)
                    ncmp += 1
                    if not torch.equal(g, w):
                        fail(f"probe {case.probe} {case.case} != plain "
                             f"({rows} rows, tile {tile}): max |diff| {err}")
    phase("probes", f"{ncmp} outputs of every variant of P1-P5 on 37 and "
          f"300 rows, tiles {probes.TILES}, bit-identical to plain "
          f"({time.perf_counter() - t0:.1f} s)")

    # the probes' path: the entry point's run_p1 .. run_p5 at full shape
    for w in probe_wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    recs = [r for run in (probe_cli.run_p1, probe_cli.run_p2,
                          probe_cli.run_p3, probe_cli.run_p4,
                          probe_cli.run_p5) for r in run(dev)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    plaunch = {key: w.launches for key, w in probe_wrappers.items()}
    if not all(plaunch.values()):
        fail(f"the probes' path launched {plaunch}: a probe bypassed its "
             f"kernel")
    for r in recs:
        phase("probes", r["line"])
        if r["ms"] < r["bound_ms"]:
            fail(f"probe {r['probe']} {r['case']} took {r['ms']:.4f} ms, "
                 f"less than its bound {r['bound_ms']:.4f}: a folded loop")
    phase("probes", f"path {dt:.2f} s; launches " + ", ".join(
        f"{k} {v}" for k, v in plaunch.items()))

    def rec_of(probe, case):
        return next(r for r in recs if r["probe"] == probe
                    and r["case"] == case)

    dv, dc, ov = pr_dotvar, pr_dotchain, pr_overlap
    pd, vp = pr_pad, pr_vpuops
    heads = {   # key: (record, inputs, kernel, plain version) at full shape
        "P1": (rec_of("P1", "fused2"), dv.inputs(dv.B, device=dev),
               lambda a: [dv.dotvar(*a, dv.STEPS, "fused2")],
               lambda a: [dv.dotvar_plain(*a, dv.STEPS, "fused2")]),
        "P2": (rec_of("P2", f"{dc.B} rows, tile {probes.tile_rows(dc.B)}"),
               dc.inputs(dc.B, device=dev),
               lambda a: [dc.dotchain(*a, dc.STEPS)],
               lambda a: [dc.dotchain_plain(*a, dc.STEPS)]),
        "P3": (rec_of("P3", "both"), ov.inputs(ov.B, device=dev),
               lambda a: ov.overlap(*a, ov.STEPS, "both"),
               lambda a: ov.overlap_plain(*a, ov.STEPS, "both")),
        "P4": (rec_of("P4", f"768 lanes, {pd.B} rows, tile "
                      f"{probes.tile_rows(pd.B)}"),
               pd.inputs(768, pd.B, device=dev),
               lambda a: [pd.pad(*a, 16 * pd.STEPS)],
               lambda a: [pd.pad_plain(*a, 16 * pd.STEPS)]),
        "P4 roll": (rec_of("P4", "roll+add"), (pd.roll_input(pd.B,
                                                             device=dev),),
                    lambda a: [pd.roll(*a, 64 * pd.ROLL_STEPS)],
                    lambda a: [pd.roll_plain(*a, 64 * pd.ROLL_STEPS)]),
        "P5": (rec_of("P5", "red"), vp.inputs(vp.B, device=dev),
               lambda a: [vp.vpuops(*a, vp.REPS, "red")],
               lambda a: [vp.vpuops_plain(*a, vp.REPS, "red")]),
    }
    probe_plain_ms = {}
    for key, (rec, a, run_k, run_p) in heads.items():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        got = run_k(a)
        ev[0].record()
        want = run_p(a)
        ev[1].record()
        torch.cuda.synchronize()
        probe_plain_ms[key] = ev[0].elapsed_time(ev[1])
        if not all(torch.equal(g, w)
                   for g, w in zip(got, want, strict=True)):
            fail(f"probe {key} {rec['case']} != plain at the full shape")
    phase("probes", "full shapes bit-identical to plain; plain ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in probe_plain_ms.items())
          + f" ({time.perf_counter() - t0:.1f} s in all)")

    # -- 10. threshold: bench.py's (3, 5)-threshold configuration ----------
    t0 = time.perf_counter()
    p_, q_ = SAFE_P1024, SAFE_Q1024
    gen = ThresholdKeyGenerator(KEY_BITS, 5, 3, random.Random(THR_SEED),
                                device=dev)
    # the verification keys: one B4 ladder mod n^2 (L = 256) on 5 rows
    tkeys, t_kg = run_path("threshold", lambda: gen.generate_from_primes(
        p_, (p_ - 1) // 2, q_, (q_ - 1) // 2), {"B4": 1})
    tpk = tkeys[0].public()
    if tpk.vi != tuple(pow(tpk.v, tpk.delta * k.share, tpk.n2)
                       for k in tkeys):
        fail("threshold verification keys != v^(delta * s_i) mod n^2")
    trng = random.Random(THR_SEED + 1)
    tms = [trng.randrange(tpk.n) for _ in range(BATCH)]
    tct = Encryptor(tpk, device=dev, rng=trng).encrypt(tms)
    warm = Ciphertext(c=tct.c[:WARM_ROWS])
    if combine(tpk, partial_decrypt_all(tkeys[:3], warm)) != tms[:WARM_ROWS]:
        fail("threshold warm-up did not decrypt")
    dk_t = tpk.device(dev)
    phase("threshold", f"keys (generate_from_primes, {KEY_BITS} bits, "
          f"l = 5, t = 3) in {t_kg:.3f} s, the 5 verification keys equal "
          f"pow; {BATCH} encryptions and a {WARM_ROWS}-row warm-up "
          f"({time.perf_counter() - t0:.1f} s)")

    def thr_ops():
        # one B1 ladder a server; combine: one B2 ladder over the 3
        # servers' stacked rows
        shares = timed("partial_decrypt_all",
                       lambda: partial_decrypt_all(tkeys[:3], tct), 3)
        return shares, timed("combine", lambda: combine(tpk, shares), 0, 1)

    (shares, tout), t_thr = run_path("threshold", thr_ops,
                                     {"B1": 3, "B2": 1})
    thr_line = op_line()
    if tout != tms:
        bad = sum(a != b for a, b in zip(tout, tms))
        fail(f"{bad} of {BATCH} threshold decryptions != their plaintext")
    for j in range(HOST_ROWS):
        parts = [PartialDecryption(s.id, decode_batch(s.c[j:j + 1])[0])
                 for s in shares]
        if combine_ints(tpk, parts) != tout[j]:
            fail("threshold combine != combine_ints on the host")

    def thr_steps():
        # combine step by step (its pieces, as combine runs them)
        ids = [s.id for s in shares]
        lam2 = [2 * compute_lambda(tpk, i, ids) for i in ids]
        stacked = torch.stack([s.c for s in shares])
        powed = timed("Lagrange ladder", lambda: thr_dec.lagrange_powers(
            tpk, stacked, [abs(v) for v in lam2]), 0, 1)
        sel = torch.tensor([v > 0 for v in lam2], device=dev)[:, None, None]
        pos, neg = timed("residue trees",
                         lambda: thr_dec._combine_products(dk_t, powed, sel))
        neg_inv = timed("modinv_batch", lambda: encode_batch(
            bhost.modinv_batch(decode_batch(neg), tpk.n2), 2 * dk_t.L,
            device=dev))
        return timed("tail", lambda: thr_dec._combine_tail(dk_t, tpk, pos,
                                                           neg_inv))

    m_steps, _ = run_path("threshold", thr_steps, {"B2": 1})
    if decode_batch(m_steps) != tms:
        fail("combine's steps != combine")
    phase("threshold", f"{BATCH} x {KEY_BITS}-bit (3, 5)-threshold "
          f"decryptions: {t_thr:.4f} s, {BATCH / t_thr:.1f} threshold dec/s "
          f"({card}); seconds: {thr_line}; combine's steps: {op_line()}; "
          f"all {BATCH} round-trip, {HOST_ROWS} equal combine_ints")

    # share-decryption proofs of servers 1-3 on the same ciphertexts; the
    # hashes (limb bytes, concatenation, SHA-256) timed apart
    hash_s = []
    challenges = thr_zkp._zkp_challenges

    def timed_challenges(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = challenges(*args)
        hash_s.append(time.perf_counter() - t)
        return out

    thr_zkp._zkp_challenges = timed_challenges
    zrng = random.Random(THR_SEED + 2)

    def zkp_ops():
        # a proof batch: one B1 (the partial decryption) and two B2 (the
        # commitments); a verification: four B2
        proofs = [timed(f"prove {k.id}",
                        lambda k=k: partial_decrypt_with_zkp(k, tct, zrng),
                        1, 2) for k in tkeys[:3]]
        oks = [timed(f"verify {ps[0].id}",
                     lambda ps=ps: verify_proofs(ps, device=dev), 0, 4)
               for ps in proofs]
        bad = [dataclasses.replace(proofs[0][0], e=proofs[0][0].e ^ 1)] \
            + proofs[0][1:HOST_ROWS]
        bad_ok = timed("verify tampered", lambda: verify_proofs(
            bad, device=dev), 0, 4)
        comb = timed("combine_with_zkp", lambda: combine_with_zkp(
            tpk, proofs, device=dev), 0, 13)
        return proofs, oks, bad_ok, comb

    (proofs, oks, bad_ok, zout), t_zkp = run_path(
        "threshold", zkp_ops, {"B1": 3, "B2": 35})
    thr_zkp._zkp_challenges = challenges
    zkp_line = op_line()
    if not all(all(o) for o in oks):
        fail("a share-decryption proof did not verify")
    if bad_ok != [False] + [True] * (HOST_ROWS - 1):
        fail(f"tampered proof batch verified as {bad_ok}")
    if zout != tms:
        fail("combine_with_zkp != the plaintexts")
    host_rows = [ps[j] for j in range(3) for ps in proofs][:HOST_ROWS]
    if not all(verify_proof(p) for p in host_rows):
        fail("a proof fails verify_proof on the host")
    if any(p.decryption != decode_batch(s.c[j:j + 1])[0]
           for s, ps in zip(shares, proofs) for j, p in enumerate(ps[:4])):
        fail("the proofs' partial decryptions != partial_decrypt_all's")
    phase("threshold", f"proofs of servers 1-3 on {BATCH}: seconds "
          f"{zkp_line}; SHA-256 challenges (bytes, concatenation, hash) "
          f"{sum(hash_s):.4f} s in {len(hash_s)} batches (each "
          + ", ".join(f"{v:.4f}" for v in hash_s) + "); every proof "
          f"verifies, the tampered one fails, {HOST_ROWS} verify on the "
          f"host, combine_with_zkp gives the plaintexts ({t_zkp:.2f} s; "
          f"{time.perf_counter() - t0:.1f} s in all)")

    # -- 11. ddleq: bench.py's `ddleq` configuration -----------------------
    # 2048-bit key (phase 4's), secpar 40, chunks of 128 nested
    # re-encryptions, a warm-up chunk, then a timed serial chunk with its
    # hashes and host steps timed apart, the checks, and the two-chunk
    # pipeline (bench.py's 256 proofs, seeds 0xDD1E0 + i)
    t0 = time.perf_counter()
    drng = random.Random(SEED + 11)
    dms = [drng.randrange(n) for _ in range(DD_CHUNK)]
    dct1 = nested_encrypt(pk, dms, drng, device=dev)
    dct2, da, db = hom.nested_randomize(pk, dct1, drng)
    proof = zd.prove(skey, dct1, dct2, da, db, DD_SECPAR, drng)
    if zd.verify(pk, dct1, dct2, proof) != [True] * DD_CHUNK:
        fail("a DDLEQ proof of the warm-up chunk did not verify")
    dct3 = nested_encrypt(pk, [drng.randrange(n) for _ in range(DD_CHUNK)],
                          drng, device=dev)
    sub8 = [Ciphertext(c=c.c[:HOST_ROWS], level=2) for c in (dct1, dct2)]
    phase("ddleq", f"{DD_CHUNK} nested encryptions re-randomized, a warm-up "
          f"chunk proven and verified (secpar {DD_SECPAR}: {DD_ROWS} rows) "
          f"({time.perf_counter() - t0:.1f} s)")

    host_s: dict = {}

    def time_attr(obj, name, key, sync=False):
        """Wrap obj.name so each call's seconds add to host_s[key]
        (between two synchronisations when ``sync``); returns an undo."""
        real = getattr(obj, name)

        def wrapped(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            host_s[key] = host_s.get(key, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, name, wrapped)
        return lambda: setattr(obj, name, real)

    from paillier_tpu_torch.core import decrypt as core_dec
    from paillier_tpu_torch.ops import random as ops_random
    undo = [time_attr(zd, "_challenge_bits", "hash", sync=True),
            time_attr(ops_random, "random_units_limbs", "random_units_limbs"),
            time_attr(bhost, "modinv_batch", "modinv_batch"),
            time_attr(core_dec, "Decryptor", "level-2 Decryptor")]
    srng = random.Random(SEED + 12)

    def dd_serial():
        pr = timed("prove", lambda: zd.prove(skey, dct1, dct2, da, db,
                                             DD_SECPAR, srng), 7, 8, 0, 1)
        return pr, timed("verify", lambda: zd.verify(pk, dct1, dct2, pr),
                         2, 1)

    (proof, ok), _ = run_path("ddleq", dd_serial, {"B1": 9, "B2": 9,
                                                   "B4": 1})
    for u in undo:
        u()
    t_prove, t_verify = op_s["prove"], op_s["verify"]
    dd_line = op_line()
    if ok != [True] * DD_CHUNK:
        fail(f"{ok.count(False)} of {DD_CHUNK} DDLEQ proofs did not verify")

    def dd_checks():
        # the split against full width on the first 8 proofs; one
        # verification of the chunk with proof 0's f tampered and the
        # last proof checked against an unrelated nested ciphertext
        crt = timed("prove 8 (split)", lambda: zd.prove(
            skey, *sub8, da[:HOST_ROWS], db[:HOST_ROWS], DD_SECPAR,
            random.Random(SEED + 13)), 7, 8, 0, 1)
        full = timed("prove 8 (full width)", lambda: zd.prove(
            skey, *sub8, da[:HOST_ROWS], db[:HOST_ROWS], DD_SECPAR,
            random.Random(SEED + 13), use_crt=False), 6, 5, 0, 1)
        f = proof.f.clone()
        f[0, 0, 0] ^= 1
        c2 = dct2.c.clone()
        c2[-1] = dct3.c[-1]
        return crt, full, timed("verify tampered / unrelated", lambda: (
            zd.verify(pk, dct1, Ciphertext(c=c2, level=2),
                      dataclasses.replace(proof, f=f))), 2, 1)

    (crt8, full8, bad_ok), _ = run_path(
        "ddleq", dd_checks, {"B1": 15, "B2": 14, "B4": 2})
    check_line = op_line()
    fields = ("x", "y", "alpha", "e", "f")
    if not all(torch.equal(getattr(crt8, f), getattr(full8, f))
               for f in fields):
        fail("DDLEQ proofs with the p^3/q^3 split != full-width proofs")
    if bad_ok != [False] + [True] * (DD_CHUNK - 2) + [False]:
        fail(f"a tampered proof and an unrelated ciphertext verified as "
             f"{bad_ok[:2]} ... {bad_ok[-2:]}")
    ints = DDLEQProof(*(getattr(proof, f)[:1, :HOST_ROWS] for f in fields)
                      ).to_ints()
    c1h, c2h = decode_batch(dct1.c[:1]), decode_batch(dct2.c[:1])
    n3 = pk.n3
    for j in range(HOST_ROWS):
        x_, y_, al, e_, f_ = (ints[f][0][j] for f in fields)
        base = c2h[0] if oracle_bit(c1h[0], c2h[0], x_, y_, al) else c1h[0]
        if pow(base, pow(e_, n, n2), n3) * pow(f_, n2, n3) % n3 != al:
            fail("a DDLEQ instance fails the host formula")
    phase("ddleq", f"serial chunk of {DD_CHUNK} proofs x {DD_SECPAR}: "
          f"prove {t_prove:.4f} s, verify {t_verify:.4f} s; seconds: "
          f"{dd_line}; inside them: " + ", ".join(
              f"{k} {v:.4f}" for k, v in host_s.items())
          + f"; checks: {check_line}; every proof verifies, the split "
          f"equals full width on {HOST_ROWS} proofs, the tampered proof "
          f"and the proof against an unrelated ciphertext fail and the "
          f"rest verify, {HOST_ROWS} instances pass the host formula")

    def dd_pipeline():
        jobs = ((dct1, dct2, da, db, random.Random(0xDD1E0 + i))
                for i in range(DD_CHUNKS))
        return list(zd.pipeline_prove_verify(skey, jobs, DD_SECPAR,
                                             verify_pk=pk))

    oks, t_dd = run_path("ddleq", dd_pipeline, {
        "B1": 9 * DD_CHUNKS, "B2": 9 * DD_CHUNKS, "B4": DD_CHUNKS})
    if oks != [[True] * DD_CHUNK] * DD_CHUNKS:
        fail("a pipelined DDLEQ proof did not verify")
    dd_rate = DD_CHUNK * DD_CHUNKS / t_dd
    phase("ddleq", f"pipeline of {DD_CHUNKS} chunks ({DD_CHUNK * DD_CHUNKS} "
          f"proofs, 2 workers): {t_dd:.4f} s, {dd_rate:.2f} DDLEQ "
          f"prove+verify/s ({card}); serial {DD_CHUNK / (t_prove + t_verify):.2f}"
          f" ({time.perf_counter() - t0:.1f} s in all)")
    phase("done", f"total {time.perf_counter() - t_start:.1f} s")

    # -- bounds: the least time the card could take for each timed call ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    HBM, INT8 = 3.35e12, 1.979e15          # B/s; int8 dense op/s (700 W)
    IMAD_CLOCK = 1.98e9                    # H100 SXM boost clock, Hz
    # 64 INT32 lanes per SM, a 32x32->64 multiply-add = 2 IMAD issues
    MAC32 = sms * 32 * IMAD_CLOCK

    def bound(t_ops, nbytes):
        t_bytes = nbytes / HBM
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def rns_bound(mults, rows, k, in_out_bytes):
        """mults Montgomery multiplies of two [2k] x [2k, 2k] int8
        extensions per row; bytes: operands in and out plus the two
        int8 matrices."""
        macs = mults * rows * 2 * (2 * k) ** 2
        return bound(2 * macs / INT8, in_out_bytes + 2 * (2 * k) ** 2)

    k1 = eng_n2.spec.k
    C1 = 2 * k1
    sched = sliding_window_schedule(pk.n, 6)
    b1_mults = 32 + 1 + int((sched[1:] >= -1).sum()) + \
        int((sched[1:] >= 0).sum()) + 1
    b1_bound = rns_bound(b1_mults, BATCH, k1, 3 * BATCH * C1 * 4)
    b2_mults = 1 + 14 + b2_nd * 5 + 1
    b2_bound = rns_bound(b2_mults, BATCH, k1,
                         BATCH * (2 * C1 * 4 + b2_nd * 4))
    b3s = b3_shapes[1]
    b3_bound = rns_bound(b3s["D"], BATCH, k1,
                         b3s["table"].numel() * 4
                         + BATCH * (3 * C1 * 4 + b3s["D"] * 4))
    nw = dk.L // 2
    b4_mults = 16 + 1 + 32 * 5
    b4_bound = bound(b4_mults * BATCH * (2 * nw * nw + nw) / MAC32,
                     BATCH * dk.L * 8 * 2 + 32 * 4 + 3 * dk.L * 8)

    # the threshold path's shapes (phase 3): B1 with the 4,100-bit
    # exponent on BATCH rows, B2 on the 3 x BATCH stacked rows with 4
    # digits, B4 at L = 256 on 5 rows with 1,025 digits
    thr_b1 = 32 + 1 + int((sched_thr[1:] >= -1).sum()) + \
        int((sched_thr[1:] >= 0).sum()) + 1
    nw4 = L4 // 2
    thr_bounds = {
        "B1": rns_bound(thr_b1, BATCH, k1, 2 * BATCH * C1 * 4),
        "B2": rns_bound(1 + 14 + 4 * 5 + 1, 3 * BATCH, k1,
                        3 * BATCH * (2 * C1 * 4 + 4 * 4)),
        "B4": bound((16 + 5 * nd5 + 1) * 5 * (2 * nw4 * nw4 + nw4) / MAC32,
                    5 * L4 * 8 * 2 + 5 * nd5 * 4 + 3 * L4 * 8)}
    phase("bounds", "threshold shapes (ms, share of bound): " + ", ".join(
        f"{kn} {thr_ms[kn]:.3f} against {b[0]:.4f} by {b[1]} "
        f"({100 * b[0] / thr_ms[kn]:.2f}%)" for kn, b in thr_bounds.items()))

    # DDLEQ's shapes (phase 3) on DD_ROWS rows: the prover's p^3 half at
    # k = 256 (B1 with the reduced n^2, B2 with 1,024 per-row digits) and
    # the verifier's k = 512 ladders (B1 e = n^2, B2 1,024 digits)
    def b1_mults(sc):
        return 32 + 1 + int((sc[1:] >= -1).sum()) + int((sc[1:] >= 0).sum()) \
            + 1

    nd_dd = dd_dig.shape[-1]
    dd_b2_mults = 1 + 14 + 5 * nd_dd + 1
    kh, kw = eng_p3.spec.k, eng_n3.spec.k
    dd_shapes = {   # name: (ms, bound)
        f"B1 k={kh}": (dd_b1_ms, rns_bound(b1_mults(dd_sched), DD_ROWS, kh,
                                           2 * DD_ROWS * 2 * kh * 4)),
        f"B2 k={kh}": (dd_b2_ms, rns_bound(dd_b2_mults, DD_ROWS, kh,
                                           DD_ROWS * (4 * kh * 4
                                                      + nd_dd * 4))),
        f"B1 k={kw}": (dd_wide["B1"], rns_bound(b1_mults(sched_n2), DD_ROWS,
                                                kw, 2 * DD_ROWS * 2 * kw * 4)),
        f"B2 k={kw}": (dd_wide["B2"], rns_bound(dd_b2_mults, DD_ROWS, kw,
                                                DD_ROWS * (4 * kw * 4
                                                           + nd_dd * 4))),
    }
    phase("bounds", f"ddleq shapes, {DD_ROWS} rows (ms, share of bound): "
          + ", ".join(f"{k} {ms:.3f} against {b[0]:.4f} by {b[1]} "
                      f"({100 * b[0] / ms:.2f}%)"
                      for k, (ms, b) in dd_shapes.items()))

    def entry(kname, name, source, replaces, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": stats[kname]["err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None, "times": stats[kname]["times"]}

    def probe_entry(key, name, source, replaces):
        rec = heads[key][0]
        keep = [{k: v for k, v in r.items() if k != "line"} for r in recs
                if (r["probe"], r["case"] in ("roll+add", "add-only"))
                == (key.split()[0], key == "P4 roll")]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": plaunch[key],
                "max_abs_err": perr[key], "ms": rec["ms"],
                "plain_ms": probe_plain_ms[key], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "times": keep}

    csrc = "paillier_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        entry("B1", "rns2_sliding", "paillier_tpu_torch/csrc/rns2_sliding.cu",
              "paillier_tpu/bigint/pallas_rns2.py:185", b1_ms, b1_plain_ms,
              b1_bound),
        entry("B2", "rns2_modexp", "paillier_tpu_torch/csrc/rns2_modexp.cu",
              "paillier_tpu/bigint/pallas_rns2.py:52", b2_ms, b2_plain_ms,
              b2_bound),
        entry("B3", "rns2_fixed_base",
              "paillier_tpu_torch/csrc/rns2_fixed_base.cu",
              "paillier_tpu/bigint/pallas_rns2.py:360", b3s["ms"],
              b3s["plain_ms"], b3_bound),
        entry("B4", "limb_modexp", "paillier_tpu_torch/csrc/limb_modexp.cu",
              "paillier_tpu/bigint/pallas_kernels.py:155", b4_ms, b4_plain_ms,
              b4_bound),
        probe_entry("P1", "probe_dotvar", csrc + "probe_dotvar.cu",
                    pr_dotvar.SCRIPT),
        probe_entry("P2", "probe_dotchain", csrc + "probe_dotchain.cu",
                    pr_dotchain.SCRIPT),
        probe_entry("P3", "probe_overlap", csrc + "probe_overlap.cu",
                    pr_overlap.SCRIPT),
        probe_entry("P4", "probe_pad", csrc + "probe_pad.cu", pr_pad.SCRIPT),
        probe_entry("P4 roll", "probe_roll", csrc + "probe_pad.cu",
                    pr_pad.SCRIPT_ROLL),
        probe_entry("P5", "probe_vpuops", csrc + "probe_vpuops.cu",
                    pr_vpuops.SCRIPT),
    ]}), flush=True)
    print(f"nvidia-smi: {smi_name_power()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
