#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paillier_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints lines tagged with its name; any failure exits
non-zero):
  1. device  -- a CUDA device is required; prints nvidia-smi's name and
                power limit.
  2. build   -- builds kernels B1 (csrc/rns2_sliding.cu), B2
                (csrc/rns2_modexp.cu), B3 (csrc/rns2_fixed_base.cu), B4
                (csrc/limb_modexp.cu), B4w (csrc/limb_modexp_wide.cu),
                the SHA-256 (csrc/sha256.cu) and the probes P1-P5
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
                (c^(p-1) mod p^2); 1024 rows at k = 512 (r^(n^2) mod n^3)
                and 64 rows at k = 704 (n^2 of phase 13's 4096-bit key,
                a 2048-bit exponent, fin), these two against plain on all
                rows on the top 512 bits of their exponents, timed at
                full depth and against pow; each k also the other way
                round (with fin where the main shape has none, and
                without where it has it) on 33 rows with a 256-bit
                exponent, against plain.  Each main shape prints its tile rows
                and us per Montgomery multiply, and the L2 bytes per
                multiply and read rate that its shape implies (blocks x
                both [2k, 2k] int8 matrices; worked out, not counted).
                B2: shared and per-row digits at k = 64; per-row 2048-bit
                exponents on 4096 rows at k = 320 (const_mult); 1024 rows
                at k = 512 with the 1024 digits of level-1 ciphertexts
                (nested_add; the last 128 digits against plain, all 1024
                timed and against pow); each main shape prints its tile
                rows and us per multiply.
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
                against plain, all against pow); B4 at L = 512 (n^2 of a
                4096-bit key) on 5 rows of one base with per-row 2,050-
                digit exponents delta * s_i: ThresholdKeyGenerator(4096)'s
                verification keys (on the kernel mont_kernel.variant
                picks: B4w) equal the register kernel called directly
                (timed) and pow (computed in 5 worker processes while
                phase 3 runs: a plain ladder at L = 512 is far too slow).
                At L = 256, 512 and 768 phase 3 calls the register kernel
                itself (mont_kernel.launch at its lane rule), whichever
                kernel mont_pow_b4 takes there; phase 15 holds B4w to it.
                B4 at L = 768 (n^3 of phase 13's 4096-bit key, 32 lanes
                of 12 words): 64 rows against plain over 32 digits and
                pow; the 2,048 digits of n^2 on the same rows timed, 4
                rows against pow (in the same worker processes), with
                lanes per row, us per product, the bound
                (ops/profiling.py's RooflineModel) and ptxas' registers
                and spills of the 12-word instantiation.
                DDLEQ's shapes on bench.py's chunk (128 proofs x secpar
                40 = 5,120 rows): B1 and B2 at k = 256 (the prover's
                p^3 half: y^(n^2 mod p^2(p-1)), 1,024 per-row digits)
                against plain on all rows (B1 on the top 512 bits of
                its exponent, B2 on its last 128 digits; both timed at
                full depth and against pow); the verifier's B1 (f^(n^2))
                and B2 (1,024 digits) at k = 512 timed on all rows, 4
                against pow (that shape, 1024 rows at k = 512, runs
                against plain above: B1 on the top 512 bits of n^2,
                B2 on the last 128 digits).
                Kernel and plain times are CUDA events.
  4. main    -- the first slice's path at full width: keygen(2048),
                Encryptor(pk, device="cuda") on 4096 plaintexts,
                Decryptor(sk, crt=True, device="cuda") on all of them:
                every plaintext round-trips, 16 ciphertexts equal
                (1 + m*n) * r^n mod n^2 on the host; then the driver entry
                point dryrun.entry() (encryption on the limb engine, one B4
                at L = 64) on the card: all 64 rows equal the host formula.
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
                (1 B1 + 1 B2 each: the two commitment ladders as one),
                verify_proofs of each (2 B2), a tampered proof that must
                fail, combine_with_zkp giving the plaintexts; the SHA-256
                challenges timed apart; then the batch path
                (partial_decrypt_with_zkp_batch of servers 1-4, one row
                of server 2's shares altered, combine_with_zkp_batch)
                held to the list path from the same generators bit for
                bit, to the plaintexts and to the dropped server, both
                timed; then the SHA-256 kernel on the first proof
                batch's bytes (4096 rows of a || b || c^4 || c_i^2,
                4,096 bytes) against its plain version and hashlib on
                every row, timed beside the plain version and its bound.
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
                card's name and power limit.  The SHA-256 kernel on
                the serial chunk's challenge bytes (c2 || x || y ||
                alpha, 2,048 bytes, as the prover hashed them) on all
                5,120 rows and on the first 1,280 (a rank's block on
                four cards) equals its plain version and hashlib on
                every row, so the proofs are those the plain hash
                gives; timed beside the plain version and its bound.
 12. parallel -- two gloo ranks spawned on the card (tests/torch_ranks.py's
                run_ranks; the ranks load the kernels phase 2 built):
                sharded_aggregate of phase 5's 65,536-row tile (32,768 a
                rank) equals phase 5's product; distributed_combine of
                phase 10's 4096 ciphertexts with servers 1-4 on a (2 x 1)
                mesh (each rank: partial_decrypt_all of its two servers,
                B1 2, and their Lagrange powers, B2 1) gives the
                plaintexts; prove + verify with mesh= of phase 11's 8
                proofs (its split check, the first proofs of the process)
                and then of one chunk of 128 x 40 (2,560 flat rows a
                rank), each from phase 11's seed, are bit-identical to
                phase 11's proofs (SHA-256 of the limbs) and every proof
                verifies.  Each rank times
                each step between synchronisations and counts its
                launches from 0 (set-up 0; the aggregate seam 0; prove
                B1 7, B2 8, B4 1, SHA 1; verify B1 2, B2 1, SHA 1);
                then the driver's
                dryrun_multichip(2) on the same ranks (its two lines
                printed, its launches held); any rank's failure
                or a count off by one fails the run.  Prints each step's
                seconds a rank, the aggregate seam (sharded_aggregate
                less a warm local tree) and the warm sharded chunk beside
                phase 11's serial chunk.  Then python -m
                paillier_tpu_torch.scaling_probe's rank body on the same
                two ranks and on one (this process, a gloo group of one):
                its JSON line at 1 and 2 ranks, labelled as ranks
                sharing one card, not a scaling figure.
 13. level2-4096 -- the limb route at full width: a 4096-bit key
                (keygen(4096, random.Random(4096), device_primes=False))
                at level 2, n^3 of 12,288 bits past the RNS engine, on 64
                rows: Encryptor(pk, 2) (8 rows equal (1+n)^m * r^(n^2)
                mod n^3, r^(n^2) from the worker processes), Decryptor(sk,
                2) round trip, nested_encrypt -> nested_add ->
                nested_decrypt gives x + y; seconds a step; B4 1 each,
                B1 1 in nested_encrypt and nested_decrypt (level 1).
 14. trace   -- ops/profiling.py's trace (torch.profiler, CPU and CUDA)
                around one phase-4 encrypt + CRT decrypt of 4096 and one
                serial phase-11 chunk (into build/trace/trace.json): the
                card's busy share in each window (the union of its kernel
                intervals over the window's span), the 5 kernels with
                most device time, and the count of B1-B4w and SHA-256
                kernel events,
                which must equal the launch counters (B1 12, B2 9, B4 1,
                SHA 2);
                the port's spans, which the trace carries: as many as
                profiling.take() holds, and no B1 kernel event starting
                before the B1 ``ladder`` span of its launch opened (the
                count of those, the median and largest lag); then, in a
                fresh spawned process, a phase-4 encrypt + CRT decrypt
                under a profiler of CUDA activity alone, as the
                benchmark's harness runs it (a marker on a synchronised
                card first): it records the
                spans (an encrypt and a decrypt root), B1 3, no B1 kernel
                before its span, and the spans' anchor (the offset
                between the host's perf_counter_ns and the device events'
                clock) inside the bracket of 20 markers that end the
                window (each kernel starts after its launch is issued and
                ends before synchronize() returns); the offset of the
                first marker, as the benchmark's harness measures it, is
                printed beside it.
 15. wide    -- kernel B4w (a block, or a cluster of blocks, a row):
                through mont_pow_b4 against its plain version over 32
                digits on 64 rows at L = 1,024 and 1,536, 16 rows of
                per-row moduli at 1,100 limbs and 2 rows at 5,824 limbs
                (the table in global memory, staged by cp.async), 2 rows
                of each against pow, each printing its warps and cluster
                blocks (mont_kernel.wide_shape); at B4's widths, called
                directly, against plain and the register kernel B4 over
                32 digits and then both timed on the full exponents,
                equal to each other and to pow: L = 256 and 512 on 5
                rows (the verification keys' shapes of phase 3) and
                L = 768 on phase 13's 64 rows; an 8192-bit
                key (keygen(8192, random.Random(8192))) on 16 rows:
                level-1 Encryptor, Decryptor(crt=True) (B1 at k = 704)
                and crt=False, level-2 Encryptor and Decryptor (B4w),
                round trips and 8 rows of each level equal to the host
                formula; threshold (partial_decrypt_all, combine) and the
                CRT decryption on the limb engine on 512 rows of phases
                10 and 4, with the RNS engine's width lowered to 2,000
                bits, equal to the RNS engine's; the verification
                keys mod n^2 of a random 8192-bit n (5 rows of 16,391-bit
                exponents, B4w) equal to pow.
Phases 4-15 each set the launch counters to 0 just before their
operations and read them just after; a phase, or an operation in it,
whose B1, B2, B3, B4, B4w and SHA-256 launches differ from the exact
count its entry points make fails (the prime search's B4 count is the number of Fermat
batches it reports).  In phases 10-15 each limb ladder is counted on
the kernel that mont_kernel.variant names for its width and rows on
this card (B4w from 256 limbs on up to 2 rows an SM, past 768 limbs
always, else B4): phase 10: keys 1 (L = 256, 5 rows: B4w), partial
decryption B1 3, combine B2 1, the proofs B1 3, B2 14 and SHA 8,
the batch path B1 4, B2 7, SHA 2 and the list path beside it B1 4,
B2 7, SHA 5;
phase 11: the serial chunk B1 9, B2 9, 1 limb (L = 128: B4), SHA 2,
the checks B1 15, B2 14, 2 limb, SHA 3, the pipeline B1 18, B2 18, 2
limb, SHA 4; phase 12: each rank's (a chunk's prove and verify SHA 1
each, dryrun_multichip(2) SHA 7), and none in this process; phase 13:
B1 2, 5 limb (L = 768, 64 rows: B4w); phase 14: B1 12, B2 9, 1 limb
(B4), SHA 2, then B1 3; phase 15:
the 8192-bit key B1 2, 4 limb (B4w), the forced limb branches 6 limb
(512 and 1,536 rows: B4), the verification keys 1 (B4w)),
and phase 9 fails unless every probe kernel launched.
Then lines of the threshold and DDLEQ shapes' bounds, one JSON line
describing the kernels, the card's name and power limit, and as the
last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

BATCH = 4096           # bench.py's headline batch
L2_BATCH = 1024        # level-2 batch
AGG_TILE = 1 << 16     # bench.py's aggregation chunk
KEY_BITS = 2048
SEED = 2048
WARM_ROWS = 64         # rows of the untimed first encrypt / decrypt
HOST_ROWS = 8          # rows checked against the host formula
PLAIN_DIGITS = 128     # depth of the plain comparisons of the widest
# ladders (base-16 digits; B1 at DDLEQ's k = 256: 4 bits a digit)
THR_E_BITS = 4100      # partial decryption's 2*delta*s_i at 2048 bits
DD_CHUNK = 128         # bench.py's ddleq configuration: proofs a chunk,
DD_SECPAR = 40         # instances a proof,
DD_CHUNKS = 2          # and chunks (256 proofs) in its pipeline
DD_ROWS = DD_CHUNK * DD_SECPAR
MARKERS = 20           # phase 14's markers bracketing the clocks' offset
# a phase-12 rank's launches (B1, B2, B3, B4, SHA-256) in
# dryrun_multichip(2): its share proofs hash 5 times, its DDLEQ twice
DRYRUN_LAUNCHES = [20, 19, 0, 2, 7]
L4_BITS = 4096         # the limb route's key: level 2 (n^3) past the RNS
L4_ROWS = 64           # engine, on kernel B4 at L = 768; rows a call
W8_BITS = 8192         # phase 15's key: both levels past the RNS engine
W8_ROWS = 16           # rows of its calls
W_THR_ROWS = 512       # rows of phase 15's forced limb branches
# B4w against plain (phase 15): (limbs, rows, per-row moduli); the second
# is the kernels line's shape, n^3 of an 8192-bit key
WIDE_SHAPES = ((1024, 64, False), (1536, 64, False), (1100, 16, True),
               (5824, 2, False))
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
            wm = re.search(r"limb_modexp_wide_kernelILi(\d+)EE", m.group(1))
            p = re.search(r"(?:probes|vpuops)\d+(\w+?_kernel)I((?:Li\d+E)+)E",
                          m.group(1))
            name = (f"<wide={t.group(1)},{t.group(2)},{t.group(3)}>" if t
                    else f"<rows={r.group(1)},wide={r.group(2)},{r.group(3)}>"
                    if r else f"<words={w.group(1)}>" if w
                    else f"<mode={wm.group(1)}>" if wm
                    else f" {p.group(1)}<"
                    + ",".join(re.findall(r"\d+", p.group(2))) + ">" if p
                    else m.group(1))
        elif "registers" in ln or "spill" in ln:
            out.append(f"{name} {ln.split(':', 1)[-1].strip()}")
    return out


def gate_window(p: dict) -> dict:
    """Phase 14's CUDA-only window, in a fresh process as the benchmark's
    harness runs one: the process's first profiler, a marker on a
    synchronised card, one encrypt + CRT decrypt of ``p``'s batch, then
    MARKERS markers that end the window.  Returns the results' check, the
    B1 launches, the span record, the device events (start, end, name in
    ns) and the markers' host times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paillier_tpu_torch import Decryptor, Encryptor
    from paillier_tpu_torch.bigint import sliding_kernel
    from paillier_tpu_torch.ops import profiling
    dev = torch.device("cuda:0")
    enc = Encryptor(p["sk"].public(), device=dev)
    dec = Decryptor(p["sk"], crt=True, device=dev)
    ms, rs = p["ms"], p["rs"]
    warm = dec.decrypt(enc.encrypt(ms, rs)) == ms
    bump = torch.ones(1, device=dev)
    b1 = sliding_kernel.rns2_pow_sliding_b1.launches
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda.synchronize()
    marker_ns = time.perf_counter_ns()
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()
    out = dec.decrypt(enc.encrypt(ms, rs))
    # markers that bracket the clocks' offset: a kernel starts after its
    # launch was issued and ends before synchronize() returns
    torch.cuda.synchronize()
    issued = []
    for _ in range(MARKERS):
        t_issue = time.perf_counter_ns()
        bump.add_(1)
        torch.cuda.synchronize()
        issued.append((t_issue, time.perf_counter_ns()))
    prof.__exit__(None, None, None)
    return {"ok": warm and out == ms,
            "b1": sliding_kernel.rns2_pow_sliding_b1.launches - b1,
            "rec": profiling.take(), "marker_ns": marker_ns,
            "issued": issued, "ev": sorted(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if "CUDA" in str(e.device_type()))}


def parallel_rank(rank: int, world: int, p: dict) -> dict:
    """Phase 12, one of two gloo ranks on the card: the two seams and a
    sharded DDLEQ chunk through the port's entry points.  Returns each
    step's seconds, its results (the proofs as SHA-256 digests of their
    limbs) and each seam's B1-B4 and SHA-256 kernel launches."""
    import hashlib

    import torch
    from paillier_tpu_torch import Ciphertext, homomorphic as hom
    from paillier_tpu_torch.bigint import (fixed_base_kernel, modexp_kernel,
                                           mont_kernel, sliding_kernel)
    from paillier_tpu_torch.core.keys import decode_batch
    from paillier_tpu_torch.dryrun import dryrun_multichip
    from paillier_tpu_torch.ops import sha256
    from paillier_tpu_torch.scaling_probe import probe_rank
    from paillier_tpu_torch.parallel import (make_mesh, shard_batch,
                                             sharded_aggregate)
    from paillier_tpu_torch.zk import ddleq as zd
    from torch_ranks import combine_steps
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported JAX")
    wrappers = (sliding_kernel.rns2_pow_sliding_b1, modexp_kernel.rns2_pow_b2,
                fixed_base_kernel.rns2_pow_fixed_base_b3,
                mont_kernel.mont_pow_b4, sha256.sha256_bytes)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out: dict = {"s": {}, "launches": {}}

    def step(name, fn):
        """fn() between two synchronisations, its kernel launches counted
        from 0."""
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["s"][name] = time.perf_counter() - t
        out["launches"][name] = [w.launches for w in wrappers]
        return res

    skey, pk, tkeys = p["skey"], p["pk"], p["tkeys"]
    tpk = tkeys[0].public()

    def setup():
        for mod in (sliding_kernel, modexp_kernel, mont_kernel, sha256):
            mod.load()
        for key, levels in ((pk, (1, 2)), (tpk, (1,))):
            for lv in levels:
                key.device(dev).engine(lv)
        zd.crt_plans(skey, dev)
        return (make_mesh(device_type="cuda"),
                make_mesh(world, servers=world, device_type="cuda"))

    mesh, mesh2 = step("set-up", setup)
    # the aggregate seam: this rank's half of phase 5's tile
    tile = torch.as_tensor(p["cx"], device=dev).repeat(p["tile_reps"], 1)
    local = Ciphertext(c=shard_batch(tile, mesh))
    step("local aggregate (first call)", lambda: hom.aggregate(pk, local))
    step("local aggregate", lambda: hom.aggregate(pk, local))
    agg = step("sharded_aggregate", lambda: sharded_aggregate(pk, local, mesh))
    out["agg"] = decode_batch(agg.c[None])[0]
    # the combine seam: this rank's two servers of the first four
    out["plain"] = combine_steps(
        tkeys, torch.as_tensor(p["tct"], device=dev), mesh2, step)
    # sharded DDLEQ: phase 11's 8-proof check from its seed (the first
    # proofs of this process), then the serial chunk from its seed
    ct1, ct2 = (Ciphertext(c=torch.as_tensor(c, device=dev), level=2)
                for c in (p["dct1"], p["dct2"]))
    out["ok"], out["digests"] = [], []
    for tag, rows, seed in ((f" ({HOST_ROWS} proofs, first)", HOST_ROWS,
                             p["seed8"]), ("", len(p["da"]), p["seed"])):
        c1, c2 = (Ciphertext(c=c.c[:rows], level=2) for c in (ct1, ct2))
        proof = step("prove" + tag, lambda: zd.prove(
            skey, c1, c2, p["da"][:rows], p["db"][:rows], p["secpar"],
            random.Random(seed), mesh=mesh))
        out["ok"].append(step("verify" + tag, lambda: zd.verify(
            pk, c1, c2, proof, mesh=mesh)))
        out["digests"].append({f: hashlib.sha256(
            getattr(proof, f).cpu().numpy().tobytes()).hexdigest()
            for f in ("x", "y", "alpha", "e", "f")})
    # the driver's dry run on the same two ranks (rank 0 prints its lines)
    out["dryrun"] = step("dryrun_multichip(2)",
                         lambda: dryrun_multichip(2, "cuda"))
    # and the scaling probe's rank body (its launches are not held)
    out["scaling"] = probe_rank(rank, world, "cuda")
    return out


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paillier_tpu_torch")):
        fail("paillier_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))

    import numpy as np
    import torch
    import torch.distributed as dist
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
    from paillier_tpu_torch.bigint.engine import LimbEngine
    from paillier_tpu_torch.core import keygen as kg_mod
    from paillier_tpu_torch.core.keys import decode_batch, encode_batch
    from paillier_tpu_torch.ops.random import random_units
    from paillier_tpu_torch.threshold import (
        PartialDecryption, ThresholdKeyGenerator, combine, combine_ints,
        combine_with_zkp, combine_with_zkp_batch, compute_lambda,
        partial_decrypt_all, partial_decrypt_with_zkp,
        partial_decrypt_with_zkp_batch, verify_proof, verify_proofs)
    from paillier_tpu_torch.threshold import decrypt as thr_dec
    from paillier_tpu_torch.threshold import zkp as thr_zkp
    from paillier_tpu_torch import probes
    from paillier_tpu_torch import dryrun as pt_dryrun
    from paillier_tpu_torch import scaling_probe
    from paillier_tpu_torch.ops import profiling
    from paillier_tpu_torch.ops import sha256 as sha_mod
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
    from torch_ranks import run_ranks
    b1 = sk_mod.rns2_pow_sliding_b1
    b1_plain = sk_mod.rns2_pow_sliding_plain
    b2 = mx_mod.rns2_pow_b2
    b2_plain = mx_mod.rns2_pow_plain
    b3 = fb_mod.rns2_pow_fixed_base_b3
    b3_plain = fb_mod.rns2_pow_fixed_base_plain
    b4 = mk_mod.mont_pow_b4
    b4_plain = mk_mod.mont_pow_digits_plain
    b4w = mk_mod.mont_pow_b4w
    sha_k = sha_mod.sha256_bytes
    sha_plain = sha_mod.sha256_bytes_plain
    wrappers = {"B1": b1, "B2": b2, "B3": b3, "B4": b4, "B4w": b4w,
                "SHA": sha_k}
    mods = {"B1": sk_mod, "B2": mx_mod, "B3": fb_mod, "B4": mk_mod,
            "SHA": sha_mod}
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
    loaders = [mod.load for mod in mods.values()] + [mk_mod.load_wide] + [
        mod.KERNEL.load for mod in probe_mods.values()]
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
    phase("build", f"kernels {', '.join(mods)}, B4w and probes "
          f"{', '.join(probe_mods)} built in {time.perf_counter() - t0:.2f} s")
    for name, mod in mods.items():
        for ln in ptxas_report(mod.build_log):
            phase("build", f"{name}{ln}")
    for ln in ptxas_report(mk_mod.build_log_wide):
        phase("build", f"B4w{ln}")
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
    stats = {kname: {"err": 0, "n": 0, "times": []} for kname in wrappers}

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

    def kernel_ms(kname, run_kernel, label):
        """The kernel once to warm, then once between two CUDA events (no
        plain run: its shape's comparison with plain ran at a lower
        depth, as ``label`` says); returns its output and milliseconds."""
        run_kernel()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = run_kernel()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        stats[kname]["times"].append({"shape": label, "ms": ms,
                                      "plain_ms": None})
        return got, ms

    def residues(eng, vals):
        return eng.from_limbs(encode_batch(vals, eng.converter.L, device=dev))

    # the verification keys of a 4096-bit (5, 3) key (B4 at L = 512,
    # below): their pow, seconds a row on one core, in 5 worker processes
    vrng = random.Random(0x4096)
    vk_mod = (vrng.getrandbits(2 * KEY_BITS) | (1 << (2 * KEY_BITS - 1))
              | 1) ** 2
    vk_v = vrng.randrange(2, vk_mod)
    vk_shares = [vrng.getrandbits(4 * KEY_BITS) for _ in range(5)]
    vk_exps = [120 * s_ for s_ in vk_shares]           # delta = 5! = 120
    vk_pool = ProcessPoolExecutor(5, mp_context=mp.get_context("spawn"))
    vk_pows = vk_pool.map(pow, [vk_v] * 5, vk_exps, [vk_mod] * 5)
    # the limb route's 4096-bit key (phase 13) and the host side of its
    # checks, in the same workers (a pow at 12,288 bits with an 8,192-bit
    # exponent takes seconds on one core): B4 at L = 768 on L4_ROWS bases
    # with e = n^2 (phase 3: 4 rows), and r^(n^2) mod n^3 of the first
    # HOST_ROWS encryptions of phase 13
    t0 = time.perf_counter()
    sk4, _ = keygen(L4_BITS, random.Random(L4_BITS), device_primes=False)
    l4rng = random.Random(L4_BITS + 1)
    x4s = [l4rng.randrange(sk4.n3) for _ in range(L4_ROWS)]
    m4s = [l4rng.randrange(sk4.n2) for _ in range(L4_ROWS)]
    r4s = random_units(sk4.n, L4_ROWS, l4rng)
    l4_pows = vk_pool.map(pow, x4s[:4] + r4s[:HOST_ROWS],
                          [sk4.n2] * (4 + HOST_ROWS),
                          [sk4.n3] * (4 + HOST_ROWS))
    phase("kernel", f"keygen({L4_BITS}) for the limb route in "
          f"{time.perf_counter() - t0:.2f} s")

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

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def b4_reg(ctx, x, d, window=4):
        """The register kernel B4 at its own lane rule, whichever kernel
        mont_kernel.variant would pick for the shape (counted as B4)."""
        x_, d_, _ = mk_mod._operands(ctx, x, d, window, "B4")
        return mk_mod.launch(ctx, x_, d_, window, mk_mod.lanes_per_row(
            -(-ctx.n_limbs // 2), x_.shape[0], sms))

    def b4_of(L, rows, n=1):
        """{kernel: n}: the kernel of B4 and B4w that mont_pow_b4 launches
        for rows of L limbs on this card (mont_kernel.variant), n times."""
        return {mk_mod.variant(L, rows, sms): n}

    def b4_want(L, rows, n=1):
        """b4_of as the keywords of timed()"""
        return {("b4_want" if k == "B4" else "b4w_want"): v
                for k, v in b4_of(L, rows, n).items()}

    def merged(*ds):
        out: dict = {}
        for d_ in ds:
            for k, v in d_.items():
                out[k] = out.get(k, 0) + v
        return out

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
    eng_n2 = dk.engine(1)
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
    eng_n3 = dk.engine(2)
    xs = [rng.randrange(1, pk.n3) for _ in range(L2_BATCH)]
    x = residues(eng_n3, xs)
    sched = sliding_window_schedule(pk.n2, 6)
    e_short = pk.n2 >> (pk.n2.bit_length() - 4 * PLAIN_DIGITS)
    short = sliding_window_schedule(e_short, 6)
    _, _, b1w_plain_ms = compare(
        "B1", lambda: b1(eng_n3.ctx, x, short, 6),
        lambda: b1_plain(eng_n3.ctx, x, short, 6),
        f"k={eng_n3.spec.k} rows={L2_BATCH} e={4 * PLAIN_DIGITS}-bit")
    got, b1w_ms = kernel_ms(
        "B1", lambda: b1(eng_n3.ctx, x, sched, 6),
        f"k={eng_n3.spec.k} rows={L2_BATCH} e=n^2 (plain at "
        f"{4 * PLAIN_DIGITS} bits)")
    check_pow(eng_n3, xs, [pk.n2] * 4, [1] * 4, got, 4, "B1 k=512")
    phase("kernel", f"B1 k={eng_n3.spec.k}, {L2_BATCH} rows, e=n^2 mod n^3 "
          f"({len(sched) - 1} steps): its top {4 * PLAIN_DIGITS} bits "
          f"bit-identical to plain on all rows (plain {b1w_plain_ms:.3f} "
          f"ms), all equal to pow; kernel {b1w_ms:.3f} ms; "
          f"{b1_tile(eng_n3, L2_BATCH, sched, b1w_ms)}")
    b1_other_fin(eng_n3, True)

    # k = 704: n^2 of the limb route's 4096-bit key (an 8192-bit
    # modulus), on that key's own level-1 engine, which phase 13 reuses
    eng_w = sk4.device(dev).engine(1)
    n8192 = eng_w.spec.N
    if eng_w.spec.k != 704 or n8192.bit_length() != 8192:
        fail(f"{n8192.bit_length()}-bit modulus gave k={eng_w.spec.k}, "
             f"expected 704")
    xs = [rng.randrange(n8192) for _ in range(64)]
    fs = [rng.randrange(n8192) for _ in range(64)]
    x, fin = residues(eng_w, xs), residues(eng_w, fs)
    e = rng.getrandbits(2048) | (1 << 2047)
    sched = sliding_window_schedule(e, 6)
    short = sliding_window_schedule(e >> (2048 - 4 * PLAIN_DIGITS), 6)
    _, _, plain_ms = compare(
        "B1", lambda: b1(eng_w.ctx, x, short, 6, fin=fin),
        lambda: b1_plain(eng_w.ctx, x, short, 6, fin=fin),
        f"k=704 rows=64 e={4 * PLAIN_DIGITS}-bit fin")
    got, ms = kernel_ms(
        "B1", lambda: b1(eng_w.ctx, x, sched, 6, fin=fin),
        f"k=704 rows=64 e=2048-bit fin (plain at {4 * PLAIN_DIGITS} bits)")
    check_pow(eng_w, xs, [e] * 4, fs, got, 4, "B1 k=704")
    phase("kernel", f"B1 k=704, 64 rows, 2048-bit e with fin "
          f"({len(sched) - 1} steps): its top {4 * PLAIN_DIGITS} bits "
          f"bit-identical to plain on all rows (plain {plain_ms:.3f} ms), "
          f"all equal to pow; kernel {ms:.3f} ms; "
          f"{b1_tile(eng_w, 64, sched, ms)}")
    b1_other_fin(eng_w, False)
    del x, fin

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
    _, _, b2w_plain_ms = compare(
        "B2", lambda: b2(eng_n3.ctx, x, dig[:, -PLAIN_DIGITS:], 4),
        lambda: b2_plain(eng_n3.ctx, x, dig[:, -PLAIN_DIGITS:], 4),
        f"k={eng_n3.spec.k} rows={L2_BATCH} per-row {PLAIN_DIGITS} digits")
    got, b2w_ms = kernel_ms(
        "B2", lambda: b2(eng_n3.ctx, x, dig, 4),
        f"k={eng_n3.spec.k} rows={L2_BATCH} per-row {dig.shape[-1]} digits "
        f"(plain at {PLAIN_DIGITS})")
    check_pow(eng_n3, xs, es, [1] * 4, got, 4, "B2 k=512")
    phase("kernel", f"B2 k={eng_n3.spec.k}, {L2_BATCH} rows, per-row "
          f"{dig.shape[-1]} digits of level-1 ciphertexts: the last "
          f"{PLAIN_DIGITS} bit-identical to plain (plain "
          f"{b2w_plain_ms:.3f} ms), all equal to pow; kernel "
          f"{b2w_ms:.3f} ms; "
          f"{b2_tile(eng_n3, L2_BATCH, dig.shape[-1], b2w_ms)}; "
          f"comparisons B1 {stats['B1']['n']}, "
          f"B2 {stats['B2']['n']}, max |diff| "
          f"{max(stats['B1']['err'], stats['B2']['err'])} "
          f"({time.perf_counter() - t0:.1f} s)")
    del x, got

    # B1 and B2 at DDLEQ's shapes (bench.py's ddleq chunk: 128 proofs x
    # secpar 40 = DD_ROWS rows): the prover's p^3 half at k = 256 (B1:
    # y^(n^2 mod p^2(p-1)), its top 4 * PLAIN_DIGITS bits; B2: 1,024
    # per-row digits of x^n, the last PLAIN_DIGITS of them), against plain
    # on all rows, on the prover's own engine; the verifier's k = 512
    # ladders (B1: f^(n^2); B2: 1,024 digits of e^n) timed on all rows, 4
    # rows against pow (that shape runs against plain at L2_BATCH rows
    # above, at the same cut depths)
    t0 = time.perf_counter()
    eng_p3 = zd.crt_plans(skey, dev).eng_p
    p3 = eng_p3.spec.N
    dd_e = pk.n2 % (skey.p * skey.p * (skey.p - 1))
    dd_sched = sliding_window_schedule(dd_e, 6)
    xs = [rng.randrange(1, p3) for _ in range(DD_ROWS)]
    x = residues(eng_p3, xs)
    e_short = dd_e >> (dd_e.bit_length() - 4 * PLAIN_DIGITS)
    short = sliding_window_schedule(e_short, 6)
    _, _, dd_b1_plain_ms = compare(
        "B1", lambda: b1(eng_p3.ctx, x, short, 6),
        lambda: b1_plain(eng_p3.ctx, x, short, 6),
        f"k={eng_p3.spec.k} rows={DD_ROWS} e={4 * PLAIN_DIGITS}-bit")
    got, dd_b1_ms = kernel_ms(
        "B1", lambda: b1(eng_p3.ctx, x, dd_sched, 6),
        f"k={eng_p3.spec.k} rows={DD_ROWS} e={dd_e.bit_length()}-bit "
        f"(plain at {4 * PLAIN_DIGITS} bits)")
    check_pow(eng_p3, xs, [dd_e] * 4, [1] * 4, got, 4, "B1 k=256")
    phase("kernel", f"B1 k={eng_p3.spec.k} (p^3), {DD_ROWS} rows, "
          f"{dd_e.bit_length()}-bit e ({len(dd_sched) - 1} steps): its top "
          f"{4 * PLAIN_DIGITS} bits bit-identical to plain on all rows "
          f"(plain {dd_b1_plain_ms:.3f} ms), all equal to pow; kernel "
          f"{dd_b1_ms:.3f} ms; "
          f"{b1_tile(eng_p3, DD_ROWS, dd_sched, dd_b1_ms)}")
    es = [rng.randrange(pk.n2) for _ in range(DD_ROWS)]
    dd_dig = limbs_to_digits(limbs(es, 2 * dk.L), 4)
    _, _, dd_b2_plain_ms = compare(
        "B2", lambda: b2(eng_p3.ctx, x, dd_dig[:, -PLAIN_DIGITS:], 4),
        lambda: b2_plain(eng_p3.ctx, x, dd_dig[:, -PLAIN_DIGITS:], 4),
        f"k={eng_p3.spec.k} rows={DD_ROWS} per-row {PLAIN_DIGITS} digits")
    got, dd_b2_ms = kernel_ms(
        "B2", lambda: b2(eng_p3.ctx, x, dd_dig, 4),
        f"k={eng_p3.spec.k} rows={DD_ROWS} per-row {dd_dig.shape[-1]} "
        f"digits (plain at {PLAIN_DIGITS})")
    check_pow(eng_p3, xs, es, [1] * 4, got, 4, "B2 k=256")
    phase("kernel", f"B2 k={eng_p3.spec.k} (p^3), {DD_ROWS} rows, per-row "
          f"{dd_dig.shape[-1]} digits: the last {PLAIN_DIGITS} bit-identical "
          f"to plain (plain {dd_b2_plain_ms:.3f} ms), all equal to pow; "
          f"kernel {dd_b2_ms:.3f} ms; "
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
        table = dk.fixed_base(level, 4)
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
    # all against pow.  Here and at L = 512 and 768 the register kernel
    # itself (b4_reg): mont_pow_b4 takes B4w at these shapes where
    # mont_kernel.variant says so, and phase 15 holds B4w to both
    ctx_n2 = make_mont_ctx(pk.n2, device=dev)
    L4 = ctx_n2.n_limbs
    xs5 = [rng.randrange(pk.n2) for _ in range(5)]
    es5 = [rng.getrandbits(THR_E_BITS) | (1 << (THR_E_BITS - 1))
           for _ in range(5)]
    nd5 = n_digits_for_bits(THR_E_BITS, 4)
    dig5 = torch.as_tensor(np.stack([exp_digits(e, 4, nd5) for e in es5]),
                           device=dev)
    xl5 = limbs(xs5, L4)
    got, _, _ = compare("B4", lambda: b4_reg(ctx_n2, xl5, dig5[:, -32:]),
                        lambda: b4_plain(ctx_n2, xl5, dig5[:, -32:], 4),
                        f"L={L4} rows=5 per-row, 32 digits")
    check_limbs(got, xs5, [e % (1 << 128) for e in es5], [pk.n2] * 5, 5,
                "B4 L=256, 32 digits")
    b4_reg(ctx_n2, xl5, dig5)                                      # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = b4_reg(ctx_n2, xl5, dig5)
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
    # B4 at L = 512 (n^2 of a 4096-bit key): the verification keys of a
    # 4096-bit (5, 3) key through ThresholdKeyGenerator(4096), one base
    # and per-row ~8,200-bit exponents delta * s_i, equal to the kernel
    # called directly (timed) and to pow (started in phase 3's first
    # lines in worker processes: a plain ladder at L = 512 takes minutes)
    vk_gen = ThresholdKeyGenerator(2 * KEY_BITS, 5, 3, device=dev)
    vk512 = vk_gen._verification_keys(vk_v, vk_shares, 120, vk_mod)
    ctx_w = make_mont_ctx(vk_mod, device=dev)
    Lw = ctx_w.n_limbs
    ndw = n_digits_for_bits(max(e.bit_length() for e in vk_exps), 4)
    digw = torch.as_tensor(np.stack([exp_digits(e, 4, ndw) for e in vk_exps]),
                           device=dev)
    xlw = limbs([vk_v] * 5, Lw)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = b4_reg(ctx_w, xlw, digw)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    if bhost.limbs_to_ints(got.cpu().numpy()) != vk512:
        fail("B4 L=512: the generator's verification keys != the kernel's")
    if vk512 != list(vk_pows):
        fail("B4 L=512: verification keys != Python pow")
    vk_pool.shutdown()
    thr_ms["B4 L=512"] = ms
    stats["B4"]["times"].append({"shape": f"L={Lw} rows=5 per-row {ndw} "
                                 f"digits (no plain run)", "ms": ms,
                                 "plain_ms": None})
    phase("kernel", f"B4 L={Lw}, 5 rows, per-row {ndw} digits (the "
          f"verification keys of a {2 * KEY_BITS}-bit (5, 3) key): "
          f"ThresholdKeyGenerator({2 * KEY_BITS}) equals the kernel and "
          f"pow; {ms:.3f} ms; {b4_shape(Lw, 5, ndw, ms)}")
    # B4 at L = 768 (n^3 of the 4096-bit key; 32 lanes of 12 words): the
    # L4_ROWS bases against plain over 32 digits; the full exponent n^2
    # (level-2 encryption's ladder) on the same rows, timed, 4 rows equal
    # to pow (computed in the worker processes)
    ctx_w3 = sk4.device(dev).engine(2).ctx
    L3 = ctx_w3.n_limbs
    xl3 = limbs(x4s, L3)
    e3 = rng.getrandbits(128) | (1 << 127)
    d3s = torch.as_tensor(exp_digits(e3, 4, 32), device=dev)
    got, b4w_ms, b4w_plain_ms = compare(
        "B4", lambda: b4_reg(ctx_w3, xl3, d3s),
        lambda: b4_plain(ctx_w3, xl3, d3s, 4),
        f"L={L3} rows={L4_ROWS} shared 32 digits")
    check_limbs(got, x4s, [e3] * 4, [sk4.n3] * 4, 4, "B4 L=768, 32 digits")
    nd3 = n_digits_for_bits(sk4.n2.bit_length(), 4)
    d3 = torch.as_tensor(exp_digits(sk4.n2, 4, nd3), device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    got = b4_reg(ctx_w3, xl3, d3)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    l4_pows = list(l4_pows)
    if bhost.limbs_to_ints(got[:4].cpu().numpy()) != l4_pows[:4]:
        fail("B4 L=768: x^(n^2) mod n^3 != Python pow")
    stats["B4"]["times"].append({"shape": f"L={L3} rows={L4_ROWS} shared "
                                 f"{nd3} digits (no plain run)", "ms": ms,
                                 "plain_ms": None})
    roof3 = profiling.RooflineModel(
        16 * L3, sk4.n2.bit_length(), 0, 4, sliding=False, rows=L4_ROWS,
        chip=profiling.detect_chip())
    w12 = [ln for ln in ptxas_report(mk_mod.build_log) if "words=12" in ln]
    phase("kernel", f"B4 L={L3}, {L4_ROWS} rows: 32 digits bit-identical to "
          f"plain (kernel {b4w_ms:.3f} ms, plain {b4w_plain_ms:.3f} ms) and "
          f"to pow; {nd3} digits (n^2 of a {L4_BITS}-bit key): {ms:.3f} ms, "
          f"4 rows equal pow; {b4_shape(L3, L4_ROWS, nd3, ms)}; bound "
          f"{roof3.bound_s() * 1e3:.4f} ms by {roof3.bound_by} "
          f"({100 * roof3.bound_s() * 1e3 / ms:.2f}%); ptxas "
          + ("; ".join(w12) or "(cached build: no log)"))
    del got, xl

    launches = {kname: 0 for kname in wrappers}
    op_s: dict = {}

    def counts():
        return {kname: w.launches for kname, w in wrappers.items()}

    def timed(name, fn, b1_want=0, b2_want=0, b3_want=0, b4_want=0,
              b4w_want=0, sha_want=0):
        """fn() between two synchronisations; its seconds go to op_s.
        Fails unless fn launched B1, B2, B3, B4, B4w and the SHA-256
        exactly as often as its entry point does."""
        before = counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        op_s[name] = time.perf_counter() - t
        got = tuple(v - before[k] for k, v in counts().items())
        want = (b1_want, b2_want, b3_want, b4_want, b4w_want, sha_want)
        if got != want:
            fail(f"{name} launched (B1, B2, B3, B4, B4w, SHA) {got}, "
                 f"expected {want}: an operation bypassed its kernel")
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

    # dryrun.entry(): regular encryption on the limb engine (one B4
    # ladder at L = 64) on the card equals (1 + m*n) * r^n mod n^2
    fn_e, args_e = pt_dryrun.entry(dev)
    _, pk_e = keygen(512, random.Random(0xF1A6), device=dev)
    out_e, t_e = run_path("main", lambda: fn_e(*args_e), {"B4": 1})
    n_e, n2_e = pk_e.n, pk_e.n2
    if decode_batch(out_e) != [
            (1 + m * n_e) * pow(r, n_e, n2_e) % n2_e
            for m, r in zip(decode_batch(args_e[0]), decode_batch(args_e[1]))]:
        fail("dryrun.entry(): ciphertexts != (1 + m*n) * r^n mod n^2")
    phase("main", f"dryrun.entry(): {tuple(out_e.shape)} on {out_e.device} "
          f"in {t_e * 1e3:.3f} ms, all {out_e.shape[0]} equal the host "
          f"formula")

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

    # the SHA-256 kernel at the challenges' shapes (phases 10 and 11)
    SHA_OPS = 2168   # 32-bit operations a 64-byte block: 48 schedule
    # steps of 13, 64 rounds of 24, the state's 8 additions

    def sha_check(label, buf, ln):
        """The SHA-256 kernel on buf [B, W] (lengths ln) against the plain
        version on the card and hashlib on every row, bit for bit, or
        fail; its time (CUDA events, the mean of 20 launches after one),
        the plain version's (one call) and the bound: the larger of the
        int64 bytes in and digests out at 3.35 TB/s and the rows' blocks'
        32-bit operations on the SMs' 64 INT32 lanes at 1.98 GHz."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        got = sha_k(buf, ln)
        ev[0].record()
        for _ in range(20):
            sha_k(buf, ln)
        ev[1].record()
        want = sha_plain(buf, ln)
        ev[2].record()
        torch.cuda.synchronize()
        stats["SHA"]["n"] += 1
        if not torch.equal(got, want):
            fail(f"the SHA-256 kernel != plain ({label})")
        rows = buf.to(torch.uint8).cpu().numpy()
        host = [int.from_bytes(hashlib.sha256(rows[i, :n].tobytes())
                               .digest(), "big")
                for i, n in enumerate(ln.tolist())]
        if sha_mod.digest_to_ints(got) != host:
            fail(f"the SHA-256 kernel != hashlib ({label})")
        B, W = buf.shape
        blocks = int(((ln + 9 + 63) // 64).sum())
        t_ops = blocks * SHA_OPS / (sms * 64 * 1.98e9)
        t_bytes = (B * W * 8 + B * 8 + B * 64) / 3.35e12
        rec = {"shape": label, "ms": ev[0].elapsed_time(ev[1]) / 20,
               "plain_ms": ev[1].elapsed_time(ev[2]),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        stats["SHA"]["times"].append(rec)
        return (f"SHA-256 kernel, {label} ({blocks} blocks): equal to plain "
                f"and hashlib on every row; {rec['ms'] * 1e3:.2f} us, plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms'] * 1e3:.2f} "
                f"us by {rec['bound_by']} "
                f"({100 * rec['bound_ms'] / rec['ms']:.2f}%)")

    # -- 10. threshold: bench.py's (3, 5)-threshold configuration ----------
    t0 = time.perf_counter()
    p_, q_ = SAFE_P1024, SAFE_Q1024
    gen = ThresholdKeyGenerator(KEY_BITS, 5, 3, random.Random(THR_SEED),
                                device=dev)
    # the verification keys: one ladder mod n^2 (L = 256) on 5 rows, on
    # the kernel that mont_kernel.variant picks
    tkeys, t_kg = run_path("threshold", lambda: gen.generate_from_primes(
        p_, (p_ - 1) // 2, q_, (q_ - 1) // 2), b4_of(L4, 5))
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
    zkp_args = []                # the first batch's (a, b, c^4, c_i^2)
    challenges = thr_zkp._zkp_challenges

    def timed_challenges(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = challenges(*args)
        hash_s.append(time.perf_counter() - t)
        if not zkp_args:
            zkp_args.extend(args)
        return out

    thr_zkp._zkp_challenges = timed_challenges
    zrng = random.Random(THR_SEED + 2)

    def zkp_ops():
        # a proof batch: one B1 (the partial decryption), one B2 (the two
        # commitments' rows stacked) and one SHA-256; a verification: two
        # B2 (the z ladders, then the e ladders, of both bases stacked)
        # and one SHA-256, for one server or several
        proofs = [timed(f"prove {k.id}",
                        lambda k=k: partial_decrypt_with_zkp(k, tct, zrng),
                        1, 1, sha_want=1) for k in tkeys[:3]]
        oks = [timed(f"verify {ps[0].id}",
                     lambda ps=ps: verify_proofs(ps, device=dev), 0, 2,
                     sha_want=1)
               for ps in proofs]
        bad = [dataclasses.replace(proofs[0][0], e=proofs[0][0].e ^ 1)] \
            + proofs[0][1:HOST_ROWS]
        bad_ok = timed("verify tampered", lambda: verify_proofs(
            bad, device=dev), 0, 2, sha_want=1)
        comb = timed("combine_with_zkp", lambda: combine_with_zkp(
            tpk, proofs, device=dev), 0, 3, sha_want=1)
        return proofs, oks, bad_ok, comb

    (proofs, oks, bad_ok, zout), t_zkp = run_path(
        "threshold", zkp_ops, {"B1": 3, "B2": 14, "SHA": 8})
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
    # the batch path: servers 1-4 prove together, the low bit of one row
    # of server 2's shares flipped after proving, the combiner verifies
    # all 4 x BATCH proofs, drops server 2 and combines the other three;
    # then the list path from the same generators with the same fault
    faulty, bad_row = 2, 1234 % BATCH

    def zrngs():
        return [random.Random(THR_SEED + 3 + k.id) for k in tkeys[:4]]

    def zkp_batch_ops():
        batches = timed("prove servers 1-4", lambda:
                        partial_decrypt_with_zkp_batch(tkeys[:4], tct,
                                                       zrngs()), 4, 4,
                        sha_want=1)
        batches[faulty - 1].ci[bad_row, 0] ^= 1
        return batches, timed("combine_with_zkp_batch", lambda:
                              combine_with_zkp_batch(tpk, batches), 0, 3,
                              sha_want=1)

    (zbatches, zres), t_zb = run_path("threshold", zkp_batch_ops,
                                      {"B1": 4, "B2": 7, "SHA": 2})
    zb_line = op_line()

    def zkp_list_ops():
        lists = [timed(f"prove {k.id}", lambda k=k, r=r:
                       partial_decrypt_with_zkp(k, tct, r), 1, 1,
                       sha_want=1) for k, r in zip(tkeys[:4], zrngs())]
        row = lists[faulty - 1][bad_row]
        lists[faulty - 1][bad_row] = dataclasses.replace(
            row, decryption=row.decryption ^ 1)
        return lists, timed("combine_with_zkp", lambda: combine_with_zkp(
            tpk, lists, device=dev), 0, 3, sha_want=1)

    (zlists, zlout), t_zl = run_path("threshold", zkp_list_ops,
                                     {"B1": 4, "B2": 7, "SHA": 5})
    zl_line = op_line()
    for b, ps in zip(zbatches, zlists):
        if (decode_batch(b.ci), decode_batch(b.e), decode_batch(b.z)) != (
                [p.decryption for p in ps], [p.e for p in ps],
                [p.z for p in ps]):
            fail(f"server {b.id}'s batch proofs != the list path's")
    if zres.plaintexts != tms or zlout != tms:
        fail("combine_with_zkp_batch / combine_with_zkp != the plaintexts")
    if zres.dropped != [faulty] or zres.kept != [1, 3, 4]:
        fail(f"combine_with_zkp_batch dropped {zres.dropped}, kept "
             f"{zres.kept}; expected [{faulty}], [1, 3, 4]")
    want_ok = [[j != bad_row or k.id != faulty for j in range(BATCH)]
               for k in tkeys[:4]]
    if [v.tolist() for v in zres.verdicts] != want_ok:
        fail("combine_with_zkp_batch's verdicts != every row but the "
             "altered one")
    phase("threshold", f"batch proofs of servers 1-4 on {BATCH}, server "
          f"{faulty}'s row {bad_row} altered: {t_zb:.3f} s ({zb_line}); the "
          f"list path {t_zl:.3f} s ({zl_line}); the proofs equal bit for "
          f"bit, both give the plaintexts, server {faulty} dropped, its "
          f"altered row alone rejected")
    # the kernel on the first proof batch's challenge bytes
    zparts = [sha_mod.limbs_to_be_bytes(v) for v in zkp_args]
    zbuf, zln = sha_mod.concat_be(zparts, sum(p[0].shape[-1]
                                              for p in zparts))
    phase("threshold", sha_check(f"threshold proofs' a || b || c^4 || "
                                 f"c_i^2, {zbuf.shape[0]} rows x "
                                 f"{zbuf.shape[1]} bytes", zbuf, zln))
    del zkp_args, zparts, zbuf, zln, zbatches, zres, zlists, zlout

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
                                             DD_SECPAR, srng), 7, 8, 0,
                   sha_want=1, **b4_want(dk.L, DD_CHUNK))
        return pr, timed("verify", lambda: zd.verify(pk, dct1, dct2, pr),
                         2, 1, sha_want=1)

    (proof, ok), _ = run_path("ddleq", dd_serial, merged(
        {"B1": 9, "B2": 9, "SHA": 2}, b4_of(dk.L, DD_CHUNK)))
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
            random.Random(SEED + 13)), 7, 8, 0, sha_want=1,
            **b4_want(dk.L, HOST_ROWS))
        full = timed("prove 8 (full width)", lambda: zd.prove(
            skey, *sub8, da[:HOST_ROWS], db[:HOST_ROWS], DD_SECPAR,
            random.Random(SEED + 13), use_crt=False), 6, 5, 0, sha_want=1,
            **b4_want(dk.L, HOST_ROWS))
        f = proof.f.clone()
        f[0, 0, 0] ^= 1
        c2 = dct2.c.clone()
        c2[-1] = dct3.c[-1]
        return crt, full, timed("verify tampered / unrelated", lambda: (
            zd.verify(pk, dct1, Ciphertext(c=c2, level=2),
                      dataclasses.replace(proof, f=f))), 2, 1, sha_want=1)

    (crt8, full8, bad_ok), _ = run_path(
        "ddleq", dd_checks, merged({"B1": 15, "B2": 14, "SHA": 3},
                                   b4_of(dk.L, HOST_ROWS, 2)))
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
    # the kernel on the serial chunk's challenge bytes, c2 || x || y ||
    # alpha as the prover hashed them: its digests equal the plain
    # version's, so the chunk's proofs are bit for bit those the plain
    # hash gives; all 5,120 rows, and the first 1,280 (a rank's block of
    # the flat axis on four cards)
    flat = [getattr(proof, f).reshape(DD_ROWS, -1) for f in ("x", "y",
                                                             "alpha")]
    dparts = [sha_mod.limbs_to_be_bytes(v) for v in [
        dct2.c.reshape(DD_CHUNK, -1).repeat_interleave(DD_SECPAR, dim=0)]
        + flat]
    dbuf, dln = sha_mod.concat_be(dparts, sum(p[0].shape[-1]
                                              for p in dparts))
    for rows in (DD_ROWS // 4, DD_ROWS):
        phase("ddleq", sha_check(f"DDLEQ's c2 || x || y || alpha, {rows} "
                                 f"rows x {dbuf.shape[1]} bytes",
                                 dbuf[:rows], dln[:rows]))
    del flat, dparts, dbuf, dln

    def dd_pipeline():
        jobs = ((dct1, dct2, da, db, random.Random(0xDD1E0 + i))
                for i in range(DD_CHUNKS))
        return list(zd.pipeline_prove_verify(skey, jobs, DD_SECPAR,
                                             verify_pk=pk))

    oks, t_dd = run_path("ddleq", dd_pipeline, merged(
        {"B1": 9 * DD_CHUNKS, "B2": 9 * DD_CHUNKS, "SHA": 2 * DD_CHUNKS},
        b4_of(dk.L, DD_CHUNK, DD_CHUNKS)))
    if oks != [[True] * DD_CHUNK] * DD_CHUNKS:
        fail("a pipelined DDLEQ proof did not verify")
    dd_rate = DD_CHUNK * DD_CHUNKS / t_dd
    phase("ddleq", f"pipeline of {DD_CHUNKS} chunks ({DD_CHUNK * DD_CHUNKS} "
          f"proofs, 2 workers): {t_dd:.4f} s, {dd_rate:.2f} DDLEQ "
          f"prove+verify/s ({card}); serial {DD_CHUNK / (t_prove + t_verify):.2f}"
          f" ({time.perf_counter() - t0:.1f} s in all)")
    # -- 12. parallel: two gloo ranks on the card -------------------------
    # sharded_aggregate over phase 5's tile, distributed_combine of phase
    # 10's ciphertexts with 4 servers on a (2 x 1) mesh, and a sharded
    # DDLEQ chunk from the serial chunk's seed; each rank returns its
    # results, seconds and launches
    t0 = time.perf_counter()
    payload = dict(
        skey=dataclasses.replace(skey), pk=dataclasses.replace(pk),
        tkeys=[dataclasses.replace(k) for k in tkeys[:4]],
        cx=cx.c.cpu().numpy(), tile_reps=AGG_TILE // BATCH,
        tct=tct.c.cpu().numpy(), dct1=dct1.c.cpu().numpy(),
        dct2=dct2.c.cpu().numpy(), da=da, db=db, secpar=DD_SECPAR,
        seed=SEED + 12, seed8=SEED + 13)

    def spawn():
        with tempfile.TemporaryDirectory() as tmp:
            return run_ranks(parallel_rank, 2, payload, init_dir=tmp,
                             timeout=240)

    try:
        ranks, t_par = run_path("parallel", spawn, {})
    except (RuntimeError, TimeoutError) as exc:
        fail(f"phase 12: {exc}")
    # (B1, B2, B3, B4, SHA-256) a rank: a DDLEQ chunk hashes once in
    # prove and once in verify
    none = [0, 0, 0, 0, 0]
    want_launch = {"set-up": none, "local aggregate (first call)": none,
                   "local aggregate": none, "sharded_aggregate": none,
                   "partial_decrypt_all": [2, 0, 0, 0, 0],
                   "lagrange_powers": [0, 1, 0, 0, 0],
                   "distributed_combine": none,
                   f"prove ({HOST_ROWS} proofs, first)": [7, 8, 0, 1, 1],
                   f"verify ({HOST_ROWS} proofs, first)": [2, 1, 0, 0, 1],
                   "prove": [7, 8, 0, 1, 1], "verify": [2, 1, 0, 0, 1],
                   "dryrun_multichip(2)": DRYRUN_LAUNCHES}
    digests = [{f: hashlib.sha256(getattr(pr, f).cpu().numpy().tobytes())
                .hexdigest() for f in fields} for pr in (crt8, proof)]
    for r, out in enumerate(ranks):
        if out["launches"] != want_launch:
            fail(f"parallel rank {r} launched (B1, B2, B3, B4, SHA) "
                 f"{out['launches']}, expected {want_launch}")
        if out["agg"] != agg_host:
            fail(f"parallel rank {r}: sharded_aggregate != aggregate")
        if out["plain"] != tms:
            fail(f"parallel rank {r}: distributed_combine != the plaintexts")
        if out["digests"] != digests:
            fail(f"parallel rank {r}: a sharded DDLEQ proof != phase 11's "
                 f"proof from the same seed")
        if out["ok"] != [[True] * HOST_ROWS, [True] * DD_CHUNK]:
            fail(f"parallel rank {r}: a sharded DDLEQ proof did not verify")
        if not out["dryrun"][-1].startswith("dryrun_multichip(2): OK"):
            fail(f"parallel rank {r}: dryrun_multichip(2) said "
                 f"{out['dryrun']}")
        for name, counts_ in out["launches"].items():
            for kname, v in zip(("B1", "B2", "B3", "B4", "SHA"), counts_):
                launches[kname] += v
    for name in want_launch:
        phase("parallel", f"{name}: " + ", ".join(
            f"rank {r} {out['s'][name]:.4f} s" for r, out in enumerate(ranks)))
    seam = [out["s"]["sharded_aggregate"] - out["s"]["local aggregate"]
            for out in ranks]
    chunk = [out["s"]["prove"] + out["s"]["verify"] for out in ranks]
    phase("parallel", f"seams: sharded_aggregate - local tree "
          + ", ".join(f"{v:.4f}" for v in seam) + " s; sharded DDLEQ chunk "
          "(prove + verify, warm) " + ", ".join(f"{v:.4f}" for v in chunk)
          + f" s a rank against the serial chunk's "
          f"{t_prove + t_verify:.4f} s ({card})")
    phase("parallel", f"2 gloo ranks on one card ({card}): "
          f"sharded_aggregate of {AGG_TILE} ({AGG_TILE // 2} a rank) equals "
          f"phase 5's aggregate; distributed_combine of {BATCH} on a (2 x 1) "
          f"mesh, 2 servers a rank, gives the plaintexts; a sharded DDLEQ "
          f"chunk ({DD_ROWS // 2} flat rows a rank) is bit-identical to "
          f"phase 11's serial chunk and verifies; every rank's launches "
          f"exact; {t_par:.2f} s with the spawn "
          f"({time.perf_counter() - t0:.1f} s in all)")
    for line in ranks[0]["dryrun"]:
        phase("parallel", f"rank 0: {line}")
    # the scaling probe's rank body on 1 rank (this process, a gloo group
    # of one) and on the two ranks above: the seams' overhead at 2 ranks
    # sharing one card, not a scaling figure
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            one = scaling_probe.probe_rank(0, 1, "cuda")
        finally:
            dist.destroy_process_group()
    for outs in ([one], [r["scaling"] for r in ranks]):
        phase("parallel", f"scaling probe, {len(outs)} rank(s) sharing one "
              f"card ({card}; not a scaling figure): "
              f"{json.dumps(scaling_probe.record(outs))}")
    phase("parallel", f"scaling probe ({time.perf_counter() - t0:.1f} s for "
          f"the rank of one)")

    # -- 13. level2-4096: the limb route at full width ---------------------
    # the 4096-bit key at level 2 (n^3: 12,288 bits, past the RNS engine):
    # Encryptor / Decryptor and the nested functions on kernel B4 at
    # L = 768, level 1 on B1 at k = 704.  Every step takes the secret key
    # (a public key too): its one DeviceKey holds the level-1 engine that
    # phase 3 built (≈ 5 s of host set-up at k = 704)
    t0 = time.perf_counter()
    dk4 = sk4.device(dev)
    if not isinstance(dk4.engine(2), LimbEngine) or isinstance(
            dk4.engine(1), LimbEngine):
        fail(f"a {L4_BITS}-bit key: level 2 must take the limb engine and "
             f"level 1 the RNS engine")
    enc4 = Encryptor(sk4, 2, device=dev, rng=random.Random(SEED + 14))
    dec4 = Decryptor(sk4, 2, device=dev)
    n4 = sk4.n
    q4rng = random.Random(SEED + 15)
    xs4 = [q4rng.randrange(n4) for _ in range(L4_ROWS)]
    ys4 = [q4rng.randrange(n4) for _ in range(L4_ROWS)]
    yct4 = Encryptor(sk4, device=dev, rng=q4rng).encrypt(ys4)
    dec4.decrypt(enc4.encrypt(m4s[:1], r4s[:1]))     # the host plans, warm
    torch.cuda.synchronize()
    phase("level2-4096", f"Encryptor(pk, 2) / Decryptor(sk, 2) of a "
          f"{L4_BITS}-bit key built on the limb route and warmed on 1 row, "
          f"{L4_ROWS} level-1 encryptions "
          f"({time.perf_counter() - t0:.2f} s)")

    def l4_ops():
        # encrypt, decrypt and nested_add: one limb ladder each (mod n^3,
        # L = 768: B4 or B4w by mont_kernel.variant); nested_encrypt and
        # nested_decrypt: one B1 ladder (level 1, mod n^2 at k = 704) and
        # one limb ladder
        w3 = b4_want(L3, L4_ROWS)
        c2 = timed("encrypt", lambda: enc4.encrypt(m4s, r4s), **w3)
        back = timed("decrypt", lambda: dec4.decrypt(c2), **w3)
        nx = timed("nested_encrypt", lambda: nested_encrypt(
            sk4, xs4, q4rng, device=dev), 1, **w3)
        na = timed("nested_add", lambda: hom.nested_add(sk4, nx, yct4),
                   **w3)
        return c2, back, timed("nested_decrypt", lambda: nested_decrypt(
            sk4, na, device=dev), 1, **w3)

    (c4, back4, add4), t_l4 = run_path(
        "level2-4096", l4_ops, merged({"B1": 2}, b4_of(L3, L4_ROWS, 5)))
    l4_line = op_line()
    n4_2, n4_3 = sk4.n2, sk4.n3
    if decode_batch(c4.c[:HOST_ROWS]) != [
            (1 + m * n4 + m * (m - 1) // 2 * n4_2) * rn % n4_3
            for m, rn in zip(m4s[:HOST_ROWS], l4_pows[4:])]:
        fail(f"{L4_BITS}-bit level-2 ciphertexts != (1+n)^m * r^(n^2) "
             f"mod n^3")
    if back4 != m4s:
        fail(f"{L4_BITS}-bit Decryptor(sk, 2) did not round-trip")
    if add4 != [(a + b) % n4 for a, b in zip(xs4, ys4)]:
        fail(f"{L4_BITS}-bit nested_add did not decrypt to x + y")
    phase("level2-4096", f"seconds ({L4_ROWS} rows, {card}): {l4_line}; "
          f"all round-trip, {HOST_ROWS} ciphertexts equal the host formula, "
          f"nested_add decrypts to x + y "
          f"({time.perf_counter() - t0:.1f} s in all)")

    # -- 14. trace: the card's busy share under torch.profiler -------------
    def span_lags(name, opened, started, per_us, want, names):
        """The k-th B1 kernel start after the k-th B1 ladder span opened
        (times in units of 1 / per_us us): fail on a kernel that starts
        first, or on other than ``want`` of each."""
        if len(opened) != want or len(started) != want:
            fail(f"{name}: {len(opened)} B1 ladder spans, {len(started)} B1 "
                 f"kernel events, expected {want}")
        lags = sorted((k - s) / per_us for k, s in zip(started, opened))
        early = sum(lag < 0 for lag in lags)
        phase("trace", f"{name}: spans {names}; B1 kernels starting before "
              f"their ladder span opened: {early} of {len(lags)}; lag "
              f"median {lags[len(lags) // 2]:.1f} us, largest "
              f"{lags[-1]:.1f} us")
        if early:
            fail(f"{name}: {early} B1 kernels start before their span")

    t0 = time.perf_counter()
    trace_dir = os.path.join(here, "build", "trace")
    windows = ("phase-4 encrypt + CRT decrypt", "phase-11 serial chunk")
    for w in wrappers.values():
        w.launches = 0
    rec_fn = torch.profiler.record_function
    with profiling.trace(trace_dir):
        with rec_fn("window: " + windows[0]):
            tr_out = dec.decrypt(enc.encrypt(ms, rs))
            torch.cuda.synchronize()
        with rec_fn("window: " + windows[1]):
            tr_pr = zd.prove(skey, dct1, dct2, da, db, DD_SECPAR,
                             random.Random(SEED + 12))
            tr_ok = zd.verify(pk, dct1, dct2, tr_pr)
            torch.cuda.synchronize()
    tr_counts = counts()
    for kname in tr_counts:
        launches[kname] += tr_counts[kname]
    if tr_out != ms or tr_ok != [True] * DD_CHUNK:
        fail("a traced window's results are wrong")
    tr_want = merged({"B1": 12, "B2": 9, "B3": 0, "B4": 0, "B4w": 0,
                      "SHA": 2}, b4_of(dk.L, DD_CHUNK))
    if tr_counts != tr_want:
        fail(f"the traced windows launched {tr_counts}, expected "
             f"{tr_want}")
    t_parse = time.perf_counter()
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"][len("window: "):]: (e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("window: ")
             and e.get("cat") == "user_annotation"}
    kern = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel"]
    if not kern:
        phase("trace", f"device busy share: not measured (torch.profiler "
              f"recorded no CUDA kernel among {len(events)} events)")
    else:
        for name in windows:
            a, b = spans[name]
            iv = sorted((max(a, e["ts"]), min(b, e["ts"] + e["dur"]))
                        for e in kern
                        if e["ts"] < b and e["ts"] + e["dur"] > a)
            busy, end = 0.0, a
            for lo, hi in iv:
                if hi > end:
                    busy += hi - max(lo, end)
                    end = hi
            phase("trace", f"{name}: device busy {100 * busy / (b - a):.1f}% "
                  f"of {(b - a) / 1e3:.1f} ms ({card}; under the profiler)")
        per: dict = {}
        for e in kern:
            short = e["name"].replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            per[short] = per.get(short, 0.0) + e["dur"]
        top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
        phase("trace", "top kernels by device time: " + "; ".join(
            f"{k[:70]} {v / 1e3:.2f} ms" for k, v in top))
        ev_counts = {kname: sum(sym in e["name"] for e in kern)
                     for kname, sym in (("B1", "rns2_sliding_kernel"),
                                        ("B2", "rns2_modexp_kernel"),
                                        ("B3", "rns2_fixed_base_kernel"),
                                        ("B4", "limb_modexp_kernel"),
                                        ("B4w", "limb_modexp_wide_kernel"),
                                        ("SHA", "sha256_kernel"))}
        if ev_counts != tr_counts:
            fail(f"the trace holds kernel events {ev_counts}, the launch "
                 f"counters say {tr_counts}")
        mb = os.path.getsize(os.path.join(trace_dir, "trace.json")) / 1e6
        phase("trace", f"kernel events B1-SHA {ev_counts} equal the launch "
              f"counters; {len(kern)} kernels, {len(events)} events, "
              f"{mb:.1f} MB, parsed in {time.perf_counter() - t_parse:.1f} s "
              f"({time.perf_counter() - t0:.1f} s in all)")
        # the port's spans, on the trace's clock
        held = profiling.take()["spans"]
        mine = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "paillier_span"]
        if len(mine) != len(held):
            fail(f"the trace holds {len(mine)} spans, take() {len(held)}")
        opened = sorted(e["ts"] for e in mine if e["name"] == "ladder"
                        and e["args"].get("kernel") == "B1")
        started = sorted(e["ts"] for e in kern
                         if "rns2_sliding_kernel" in e["name"])
        span_lags("trace (CPU + CUDA)", opened, started, 1.0,
                  tr_counts["B1"], {
            n: sum(e["name"] == n for e in mine)
            for n in sorted({e["name"] for e in mine})})
    del events, kern

    # the gate: a profiler of CUDA activity alone, in a fresh process, as
    # the harness starts it (a long process's later sessions lose their
    # first device events and drift from its host clock)
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        gate = ex.submit(gate_window, dict(
            sk=dataclasses.replace(skey), ms=ms, rs=rs)).result(timeout=300)
    rec, dev_ev, issued = gate["rec"], gate["ev"], gate["issued"]
    launches["B1"] += gate["b1"]
    if not gate["ok"] or gate["b1"] != 3:
        fail(f"the CUDA-only window's results are wrong or it launched B1 "
             f"{gate['b1']} times, expected 3")
    roots = [s["name"] for s in rec["spans"] if s["parent"] < 0]
    if roots != ["encrypt", "decrypt"] or rec["anchor_ns"] is None:
        fail(f"a CUDA-only profiler recorded the roots {roots}: the span "
             f"gate is off")
    offset = dev_ev[0][0] - gate["marker_ns"]      # benchmark/traces.py's
    anchor = rec["anchor_ns"]
    marks = dev_ev[-MARKERS:]
    lo = max(end - back for (_, end, _), (_, back) in zip(marks, issued))
    hi = min(start - t_issue
             for (start, _, _), (t_issue, _) in zip(marks, issued))
    span_lags("CUDA-only window", sorted(
        s["start_ns"] + anchor for s in rec["spans"]
        if s["name"] == "ladder" and s["attrs"].get("kernel") == "B1"),
        sorted(t for t, _, name in dev_ev if "rns2_sliding_kernel" in name),
        1e3, 3, {n: sum(s["name"] == n for s in rec["spans"])
                 for n in sorted({s["name"] for s in rec["spans"]})})
    phase("trace", f"clock: spans' anchor {anchor} ns; {MARKERS} markers "
          f"bracket the offset in [{lo}, {hi}] ns ({(hi - lo) / 1e3:.1f} "
          f"us wide): anchor - low {(anchor - lo) / 1e3:.1f} us, high - "
          f"anchor {(hi - anchor) / 1e3:.1f} us; one marker as "
          f"benchmark/traces.py measures it: offset {offset} ns, offset - "
          f"anchor {(offset - anchor) / 1e3:.1f} us (the window's first "
          f"device event, {dev_ev[0][2][:60]!r}, {len(dev_ev)} events) "
          f"({card})")
    if not lo <= anchor <= hi:
        fail("the spans' anchor lies outside the markers' bracket: the "
             "spans are not on the device events' clock")

    # -- 15. wide: kernel B4w and the key widths past 768 limbs ------------
    # B4w against its plain version over 32 digits (64 rows at L = 1,024
    # and 1,536, per-row moduli at 1,100 limbs, 2 rows at 5,824 limbs with
    # the table in global memory) and against the register kernel B4 at
    # L = 768; an 8192-bit key at levels 1 and 2 on 16 rows; threshold and
    # the CRT decryption on the limb engine with the 2048-bit keys of phases
    # 10 and 4, forced by lowering the RNS engine's width; the
    # verification keys of an 8192-bit modulus
    t15 = time.perf_counter()

    def ev_ms(fn):
        """fn() once to warm, then once between two CUDA events."""
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    from paillier_tpu_torch import native
    from paillier_tpu_torch.bigint import rns2 as rns2_mod
    have_gmp = native.available()
    w_pool = (ThreadPoolExecutor(2) if have_gmp else ProcessPoolExecutor(
        6, mp_context=mp.get_context("spawn")))

    def host_pows(bases, exps, mod):
        """[b^e mod mod] for the rows (exps: one int shared, or a list),
        started in the background: by GMP in a thread (it releases the
        GIL) where the native helper loads, else in worker processes;
        returns a function that waits for the list."""
        exps = [exps] * len(bases) if isinstance(exps, int) else exps
        if have_gmp:
            return w_pool.submit(lambda: [native.powm(b, e, mod) for b, e
                                          in zip(bases, exps)]).result
        it = w_pool.map(pow, bases, exps, [mod] * len(bases))
        return lambda: list(it)

    # the 8192-bit key's prime search runs in GMP, which releases the GIL,
    # in a thread while the card runs the kernel comparisons below (the
    # Python-bound set-up does not: it slowed the plain ladders tenfold)
    def timed_keygen():
        t = time.perf_counter()
        keys = keygen(W8_BITS, random.Random(W8_BITS), device=dev)
        return keys, time.perf_counter() - t

    kg_pool = ThreadPoolExecutor(1)
    kg8 = kg_pool.submit(timed_keygen)
    wrng = random.Random(0x15)
    # the verification keys' modulus: n^2 of a random 8192-bit n
    vk_n = wrng.getrandbits(W8_BITS) | 1 << (W8_BITS - 1) | 1
    vk_n2 = vk_n * vk_n
    vk8_v = wrng.randrange(2, vk_n2)
    vk8_shares = [wrng.getrandbits(2 * W8_BITS) for _ in range(5)]
    vk8_pows = host_pows([vk8_v] * 5, [120 * s_ for s_ in vk8_shares],
                         vk_n2)
    wide_shapes = []
    for Lw_, rows_w, per_mod in WIDE_SHAPES:
        bits_w = 16 * Lw_
        mods_w = [wrng.getrandbits(bits_w) | 1 << (bits_w - 1) | 1
                  for _ in range(rows_w if per_mod else 1)]
        ctx_w_ = (stack_mont_ctx(mods_w, Lw_, device=dev) if per_mod
                  else make_mont_ctx(mods_w[0], device=dev))
        row_mods = [mods_w[i % len(mods_w)] for i in range(rows_w)]
        xs_w = [wrng.randrange(m_) for m_ in row_mods]
        x_w = limbs(xs_w, Lw_)
        e_w = wrng.getrandbits(128) | 1 << 127
        d_w = torch.as_tensor(exp_digits(e_w, 4, 32), device=dev)
        nw_ = mk_mod.wide_words(Lw_)
        mode_ = mk_mod.wide_mode(nw_, 4)
        wshape = mk_mod.wide_shape(nw_, rows_w, sms)
        label = (f"L={Lw_} rows={rows_w} "
                 + ("per-row moduli" if per_mod else "shared")
                 + f" 32 digits, mode {mode_}, {wshape[0]} warps x "
                 f"{wshape[1]} blocks")
        # the two shapes of 8192-bit keys timed warm, the others on their
        # first call (their host work, such as the padded context, in it);
        # through mont_pow_b4, which takes B4w at every one of them
        warm = not per_mod and mode_ == 0
        if mk_mod.variant(Lw_, rows_w, sms) != "B4w":
            fail(f"mont_pow_b4 at L={Lw_} would not take B4w")
        got, ms_w, plain_w = compare(
            "B4w", lambda: b4(ctx_w_, x_w, d_w, 4),
            lambda: b4_plain(ctx_w_, x_w, d_w, 4), label, warm=warm)
        if not warm:
            label += " (first call)"
            stats["B4w"]["times"].append({"shape": label, "ms": ms_w,
                                          "plain_ms": plain_w})
        check_limbs(got, xs_w, [e_w] * rows_w, row_mods, 2, f"B4w {label}")
        wide_shapes.append(dict(L=Lw_, rows=rows_w, ms=ms_w, nd=32,
                                plain_ms=plain_w, label=label,
                                warps=wshape[0], cluster=wshape[1]))
        phase("wide", f"B4w L={Lw_} ({nw_} words, mode {mode_}, "
              f"{wshape[0]} warps a block, {wshape[1]} blocks a row), "
              f"{rows_w} rows"
              + (", per-row moduli" if per_mod else "")
              + f", 32 digits: bit-identical to plain, 2 rows equal pow; "
              f"kernel {ms_w:.3f} ms ({ms_w * 1e3 / 177:.2f} us a product), "
              f"plain {plain_w:.3f} ms")
    del got, x_w

    # B4's widths where mont_kernel.variant may take B4w: the threshold
    # verification keys' shapes of phase 3 (5 rows, L = 256 with 1,025
    # per-row digits; L = 512, a 4096-bit key's, with 2,050) and phase
    # 13's (64 rows at L = 768, the 2,048 digits of n^2): B4w (called
    # directly) against plain and the register kernel B4 over 32 digits,
    # bit-identical, then both on the full exponents, timed, equal to
    # each other and to pow
    at_b4 = []
    for Lb, ctx_b, xb, dfull, want_full, label in (
            (L4, ctx_n2, xl5, dig5, None, "the threshold verification keys"),
            (Lw, ctx_w, xlw, digw, vk512, f"a {2 * KEY_BITS}-bit key's "
                                          f"verification keys"),
            (L3, ctx_w3, limbs(x4s, L3), d3, l4_pows[:4],
             f"n^2 of phase 13's {L4_BITS}-bit key")):
        rows_b = xb.shape[0]
        d32 = dfull[..., -32:]
        got, ms32, plain32 = compare(
            "B4w", lambda: b4w(ctx_b, xb, d32, 4),
            lambda: b4_plain(ctx_b, xb, d32, 4),
            f"L={Lb} rows={rows_b} 32 digits")
        if not torch.equal(got, b4_reg(ctx_b, xb, d32)):
            fail(f"B4w != the register kernel B4 at L = {Lb}")
        full_w, ms_w = ev_ms(lambda: b4w(ctx_b, xb, dfull, 4))
        full_r, ms_r = ev_ms(lambda: b4_reg(ctx_b, xb, dfull))
        if not torch.equal(full_w, full_r):
            fail(f"B4w != B4 at L = {Lb} on the full exponent")
        if want_full is None:
            check_limbs(full_w, xs5, es5, [pk.n2] * 5, 5, f"B4w L={Lb}")
        elif bhost.limbs_to_ints(full_w[:len(want_full)].cpu().numpy()) \
                != list(want_full):
            fail(f"B4w at L = {Lb} != pow")
        nd_b = dfull.shape[-1]
        ws_b = mk_mod.wide_shape(mk_mod.wide_words(Lb), rows_b, sms)
        pick = mk_mod.variant(Lb, rows_b, sms)
        stats["B4w"]["times"].append({
            "shape": f"L={Lb} rows={rows_b} {nd_b} digits, {ws_b[0]} "
                     f"warps x {ws_b[1]} blocks (register B4: {ms_r:.3f} "
                     f"ms; mont_pow_b4 takes {pick})", "ms": ms_w,
            "plain_ms": None})
        at_b4.append(dict(L=Lb, rows=rows_b, nd=nd_b, ms=ms_w, b4_ms=ms_r,
                          label=f"L={Lb} rows={rows_b} {nd_b} digits"))
        phase("wide", f"L={Lb}, {rows_b} rows ({label}): B4w ({ws_b[0]} "
              f"warps x {ws_b[1]} blocks) bit-identical to plain and to B4 "
              f"over 32 digits (B4w {ms32:.3f} ms, plain {plain32:.3f} ms); "
              f"{nd_b} digits: B4w {ms_w:.3f} ms, B4 {ms_r:.3f} ms, equal, "
              f"and to pow; mont_pow_b4 takes {pick} ({card})")
    del got, full_w, full_r

    # an 8192-bit key: both levels past the RNS engine (n^2: 1,024 limbs,
    # n^3: 1,536, B4w), its CRT halves p^2 / q^2 on B1 at k = 704
    (sk8, pk8), t_kg8 = kg8.result()
    kg_pool.shutdown()
    dk8 = pk8.device(dev)
    if not all(isinstance(dk8.engine(lv), LimbEngine) for lv in (1, 2)):
        fail(f"a {W8_BITS}-bit key must take the limb engine at levels 1 "
             f"and 2")
    r8 = random.Random(8193)
    m8 = {lv: [r8.randrange(pk8.n ** lv) for _ in range(W8_ROWS)]
          for lv in (1, 2)}
    rr8 = {lv: random_units(pk8.n, W8_ROWS, r8) for lv in (1, 2)}
    rn8 = {lv: host_pows(rr8[lv][:HOST_ROWS], pk8.n ** lv, pk8.n ** (lv + 1))
           for lv in (1, 2)}
    t0 = time.perf_counter()
    enc8 = {lv: Encryptor(pk8, lv, device=dev, rng=random.Random(lv))
            for lv in (1, 2)}
    dec8 = {lv: Decryptor(sk8, lv, device=dev) for lv in (1, 2)}
    crt8 = Decryptor(sk8, 1, crt=True, device=dev)
    # the Toeplitz plans that the first encrypt / decrypt calls would
    # build (G^m, the L-function divisions, the level-2 recovery), so that
    # the timed calls below are the card's ladders and their glue
    L8, n8 = dk8.L, pk8.n
    for lv in (1, 2):
        dk8.div_n_plan(lv * L8)
    dk8.engine(1).one_plus_mul(encode_batch([0], L8, device=dev), n8)
    dk8.const_mul_plan(n8, 2 * L8, 3 * L8)
    dk8.const_mul_plan(pk8.n2, L8, 3 * L8)
    dk8.fold_plan(n8, 2 * L8)
    dk8.fold_plan(pk8.n2, 3 * L8)
    dk8.inv2_n_plan()
    dk8.inv2fac_n2_plan()
    dk8.barrett_plan(n8)
    dk8.barrett_plan(pk8.n2)
    t_set8 = time.perf_counter() - t0

    def w8_ops():
        # levels 1 and 2: one limb ladder (B4w at these widths) for each
        # encrypt and plain decrypt; CRT decryption two B1 ladders at
        # k = 704
        w1, w2 = b4_want(L8 * 2, W8_ROWS), b4_want(L8 * 3, W8_ROWS)
        c1 = timed("encrypt L1", lambda: enc8[1].encrypt(m8[1], rr8[1]),
                   **w1)
        b1c = timed("CRT decrypt L1", lambda: crt8.decrypt(c1), 2)
        b1p = timed("decrypt L1", lambda: dec8[1].decrypt(c1), **w1)
        c2 = timed("encrypt L2", lambda: enc8[2].encrypt(m8[2], rr8[2]),
                   **w2)
        b2p = timed("decrypt L2", lambda: dec8[2].decrypt(c2), **w2)
        return (c1, c2), (b1c, b1p, b2p)

    ((c81, c82), (b81c, b81p, b82p)), t_w8 = run_path(
        "wide", w8_ops, merged({"B1": 2}, b4_of(L8 * 2, W8_ROWS, 2),
                               b4_of(L8 * 3, W8_ROWS, 2)))
    w8_line = op_line()
    if not b81c == b81p == m8[1] or b82p != m8[2]:
        fail(f"the {W8_BITS}-bit key did not round-trip")
    for lv, c8 in ((1, c81), (2, c82)):
        mod8 = n8 ** (lv + 1)
        gm8 = [(1 + m_ * n8 + (lv - 1) * (m_ * (m_ - 1) // 2) * n8 * n8)
               % mod8 for m_ in m8[lv][:HOST_ROWS]]
        if decode_batch(c8.c[:HOST_ROWS]) != [
                g * r_ % mod8 for g, r_ in zip(gm8, rn8[lv]())]:
            fail(f"{W8_BITS}-bit level-{lv} ciphertexts != (1+n)^m "
                 f"r^(n^{lv}) mod n^{lv + 1}")
    phase("wide", f"{W8_BITS}-bit key: keygen {t_kg8:.2f} s (in a thread "
          f"beside the kernel checks above; GMP "
          f"{'loaded' if have_gmp else 'missing'}), Encryptor / Decryptor "
          f"at levels 1 and 2, Decryptor(crt=True) and their host plans "
          f"built in {t_set8:.2f} s; {W8_ROWS} rows ({card}), seconds: "
          f"{w8_line}; all round-trip, {HOST_ROWS} of each level equal the "
          f"host formula")

    # threshold and the CRT halves on the limb engine: the RNS engine's
    # width lowered below p^2 of the 2048-bit keys (so n^2 is past it
    # too), and fresh copies of the keys, whose engines are built under it
    sub = Ciphertext(c=tct.c[:W_THR_ROWS])
    rns_sh = [thr_dec.PartialDecryptionBatch(id=s_.id, c=s_.c[:W_THR_ROWS])
              for s_ in shares]
    rns_crt = dec.decrypt_array(Ciphertext(c=ct.c[:W_THR_ROWS]))
    saved_bits = rns2_mod.MAX_MODULUS_BITS
    rns2_mod.MAX_MODULUS_BITS = KEY_BITS - 48
    try:
        ltkeys = [dataclasses.replace(k) for k in tkeys[:3]]
        ltpk = dataclasses.replace(tpk)
        if not isinstance(ltpk.device(dev).engine(1), LimbEngine):
            fail("the lowered width left n^2 on the RNS engine")
        dec_l = Decryptor(skey, crt=True, device=dev)

        def limb_ops():
            # one limb ladder a server (L = 256); combine: one over the
            # 3 x 512 stacked rows, limb trees; the limb CRT: two (p^2,
            # q^2 at L = 128); B4 or B4w by mont_kernel.variant
            sh = timed("partial_decrypt_all", lambda: partial_decrypt_all(
                ltkeys, sub), **b4_want(L4, W_THR_ROWS, 3))
            out_ = timed("combine", lambda: combine(ltpk, sh),
                         **b4_want(L4, 3 * W_THR_ROWS))
            crt_ = timed("limb CRT decrypt", lambda: dec_l.decrypt_array(
                Ciphertext(c=ct.c[:W_THR_ROWS])),
                **b4_want(dk.L, W_THR_ROWS, 2))
            return sh, out_, crt_

        (lsh, lout, lcrt), _ = run_path("wide", limb_ops, merged(
            b4_of(L4, W_THR_ROWS, 3), b4_of(L4, 3 * W_THR_ROWS),
            b4_of(dk.L, W_THR_ROWS, 2)))
    finally:
        rns2_mod.MAX_MODULUS_BITS = saved_bits
    limb_line = op_line()
    if any(not torch.equal(a.c, b.c) for a, b in zip(lsh, rns_sh)):
        fail("partial_decrypt_all on the limb engine != on the RNS engine")
    if lout != tms[:W_THR_ROWS]:
        fail("combine on the limb engine != the RNS engine's plaintexts")
    if not torch.equal(lcrt, rns_crt):
        fail("CRT decryption on limb halves != on RNS halves")
    phase("wide", f"{W_THR_ROWS} rows with the RNS engine's width lowered "
          f"to {KEY_BITS - 48} bits: partial_decrypt_all, combine and the "
          f"CRT decryption on the limb engine equal the RNS engine's; "
          f"seconds: {limb_line}")

    # the verification keys of an 8192-bit (5, 3) key's shape: 5 rows of
    # one base, per-row 16,391-bit exponents, mod n^2 at 1,024 limbs
    vk8, _ = run_path("wide", lambda: ThresholdKeyGenerator(
        W8_BITS, 5, 3, device=dev)._verification_keys(
            vk8_v, vk8_shares, 120, vk_n2), b4_of(W8_BITS // 8, 5))
    if vk8 != vk8_pows():
        fail(f"{W8_BITS}-bit verification keys (B4w) != pow")
    w_pool.shutdown()
    phase("wide", f"_verification_keys mod n^2 of a {W8_BITS}-bit n (L = "
          f"{W8_BITS // 8}), 5 rows of "
          f"{max(120 * s_ for s_ in vk8_shares).bit_length()}-bit exponents: "
          f"equal pow; phase "
          f"{time.perf_counter() - t15:.1f} s in all")

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
    # digits, B4 at L = 256 on 5 rows with 1,025 digits and at L = 512
    # with 2,050
    thr_b1 = 32 + 1 + int((sched_thr[1:] >= -1).sum()) + \
        int((sched_thr[1:] >= 0).sum()) + 1
    nw4 = L4 // 2
    thr_bounds = {
        "B1": rns_bound(thr_b1, BATCH, k1, 2 * BATCH * C1 * 4),
        "B2": rns_bound(1 + 14 + 4 * 5 + 1, 3 * BATCH, k1,
                        3 * BATCH * (2 * C1 * 4 + 4 * 4)),
        "B4": bound((16 + 5 * nd5 + 1) * 5 * (2 * nw4 * nw4 + nw4) / MAC32,
                    5 * L4 * 8 * 2 + 5 * nd5 * 4 + 3 * L4 * 8),
        "B4 L=512": bound((16 + 5 * ndw + 1) * 5
                          * (2 * (Lw // 2) ** 2 + Lw // 2) / MAC32,
                          5 * Lw * 8 * 2 + 5 * ndw * 4 + 3 * Lw * 8)}
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

    # B4w's shapes (phase 15): 16 + 5 nd + 1 products a row (the table's
    # 16, 5 a digit, the exit; 177 at 32 digits), 2 nw^2 + nw
    # multiply-adds each at the modulus' own nw = L / 2 (padding is not
    # work: the kernel's own 2.5 nw^2 a product at the padded nw is not
    # the function's)
    def b4w_bound(sh):
        nw_ = -(-sh["L"] // 2)
        return bound((16 + 5 * sh["nd"] + 1) * sh["rows"]
                     * (2 * nw_ * nw_ + nw_) / MAC32,
                     sh["rows"] * sh["L"] * 8 * 2 + sh["nd"] * 4
                     + 3 * sh["L"] * 8)

    phase("bounds", "B4w shapes (ms, share of bound): " + ", ".join(
        f"{sh['label']} {sh['ms']:.3f} against {b4w_bound(sh)[0]:.4f} by "
        f"{b4w_bound(sh)[1]} ({100 * b4w_bound(sh)[0] / sh['ms']:.2f}%)"
        for sh in wide_shapes))
    phase("bounds", "B4's widths, B4w / B4 (ms, share of bound): "
          + ", ".join(
              f"{sh['label']} {sh['ms']:.3f} / {sh['b4_ms']:.3f} against "
              f"{b4w_bound(sh)[0]:.4f} by {b4w_bound(sh)[1]} "
              f"({100 * b4w_bound(sh)[0] / sh['ms']:.2f}% / "
              f"{100 * b4w_bound(sh)[0] / sh['b4_ms']:.2f}%)"
              for sh in at_b4))
    b4w_main = wide_shapes[1]
    # the SHA-256 at a DDLEQ chunk's block of one rank on four cards
    sha_main = stats["SHA"]["times"][1]

    def entry(kname, name, source, replaces, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": stats[kname]["err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None, **extra, "times": stats[kname]["times"]}

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
        entry("B4w", "limb_modexp_wide",
              "paillier_tpu_torch/csrc/limb_modexp_wide.cu",
              "paillier_tpu/bigint/pallas_kernels.py:155", b4w_main["ms"],
              b4w_main["plain_ms"], b4w_bound(b4w_main),
              shape=b4w_main["label"], warps=b4w_main["warps"],
              cluster=b4w_main["cluster"]),
        entry("SHA", "sha256", "paillier_tpu_torch/csrc/sha256.cu",
              "none: paillier_tpu/ops/sha256.py:94 is jnp", sha_main["ms"],
              sha_main["plain_ms"],
              (sha_main["bound_ms"], sha_main["bound_by"]),
              shape=sha_main["shape"]),
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
