"""(t, l)-threshold decryption of batches under one shared key.

The key comes from the configuration's two fixed safe primes through the
program's ``ThresholdKeyGenerator.generate_from_primes``, the dealer's
draws (verification base, polynomial) from the seed.  Set-up encrypts
``pool_batches`` batches of ``batch`` plaintexts (uniform below n, r
from the seed); a request takes the next batch, runs
``partial_decrypt_all`` of the first ``decrypting_servers`` servers and
``combine``s their shares; an op is one plaintext recovered.

Judged: every plaintext against the one encrypted, and the partial
decryptions of ``check_rows`` rows a request (drawn from the seed), of
every server, against the reference's shares.
"""

from __future__ import annotations

import json
import math
from fractions import Fraction

from benchmark import inputs, refpool, roofline
from benchmark.harness import BENCH
from benchmark.reference import paillier as ref
from benchmark.reference import threshold as rth


class Request:
    def __init__(self, batch, ms, rs):
        self.batch, self.ms, self.rs = batch, ms, rs


def primes(cfg: dict) -> tuple[int, int]:
    data = json.loads((BENCH / cfg["primes_file"]).read_text())
    entry = data[cfg["primes_key"]] if cfg.get("primes_key") else data
    return int(entry["p"], 16), int(entry["q"], 16)


def lagrange2(ids: list, delta: int) -> list[int]:
    """|2 lambda_i| of each server of ``ids`` (the combine's weights;
    exact here: delta = l! clears every denominator)."""
    out = []
    for i in ids:
        lam = Fraction(delta)
        for j in ids:
            if j != i:
                lam *= Fraction(-j, i - j)
        out.append(abs(2 * int(lam)))
    return out


class Op:
    def __init__(self, cell, seed, device, spans, fault=None):
        import torch
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import LEVEL_ONE, Ciphertext
        from paillier_tpu_torch.threshold import (ThresholdKeyGenerator,
                                                  combine,
                                                  partial_decrypt_all)
        self.Ciphertext, self.combine = Ciphertext, combine
        self.partial_decrypt_all = partial_decrypt_all
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed, self.fault = spans, seed, fault
        p, q = primes(cfg)
        self.key = ref.Key(p, q)
        n = self.n = p * q
        l, t = cfg["servers"], cfg["threshold"]
        self.l = l
        self.shares = rth.shares(p, q, l, t, inputs.stream(seed, "dealer"))
        tsks = ThresholdKeyGenerator(
            n.bit_length(), l, t, inputs.stream(seed, "dealer"),
            device=device).generate_from_primes(p, (p - 1) // 2, q,
                                                (q - 1) // 2)
        self.servers = tsks[:tr["decrypting_servers"]]
        self.n_servers = len(self.servers)
        self.tpk = tsks[0].public()
        self.limbs = 2 * (n.bit_length() // 16)
        B = tr["batch"]
        g = inputs.stream(seed, "requests")
        enc = Encryptor(self.tpk, LEVEL_ONE, device=device)
        self.requests, pool = [], []
        for j in range(tr["pool_batches"]):
            ms = [g.randrange(n) for _ in range(B)]
            rs = [inputs.unit(n, g) for _ in range(B)]
            pool.append(enc.encrypt(ms, rs).c)
            self.requests.append(Request(j, ms, rs))
        self.pool = torch.stack(pool)
        self.ops_per_request = B
        self.check_rows = tr["check_rows"]
        ids = [s.id for s in self.servers]
        delta = math.factorial(l)
        n2_bits = (n * n).bit_length()
        self._work = [{"kernel": "B1", "mod_bits": n2_bits,
                       "row_mults": B * roofline.least_mults(
                           2 * delta * self.shares[i - 1])} for i in ids]
        self._work.append({"kernel": "B2", "mod_bits": n2_bits,
                           "row_mults": B * sum(
                               roofline.least_mults(e)
                               for e in lagrange2(ids, delta))})
        self.call(self.requests[0])                 # warm: builds, plans

    def call(self, req):
        ct = self.Ciphertext(c=self.pool[req.batch])
        with self.spans("partial"):
            shares = self.partial_decrypt_all(self.servers, ct)
        if self.fault == "answer_altered":
            shares[0].c[0, 0] ^= 1
        if self.fault == "half_batch":
            for s in shares:
                s.c = s.c[: s.c.shape[0] // 2]
        with self.spans("combine"):
            pts = self.combine(self.tpk, shares)
        return shares, pts

    def keep(self, i, req, out):
        shares, pts = out
        g = inputs.stream(self.seed, f"check/{i}")
        rows = [g.randrange(len(req.ms)) for _ in range(self.check_rows)]
        got = None
        if all(s.c.shape[0] == len(req.ms) for s in shares):
            got = [inputs.from_limbs(s.c[rows]) for s in shares]
        pt_bad = (abs(len(pts) - len(req.ms))
                  + sum(a != b for a, b in zip(pts, req.ms)))
        return {"req": req, "rows": rows, "shares": got,
                "pt_bad": pt_bad}, pt_bad == 0 and got is not None

    def work(self, req):
        return self._work

    def free(self):
        self.pool = self.servers = self.tpk = None

    def check(self, window, control=False):
        key, n2 = self.key, self.n ** 2
        ids = list(range(1, self.n_servers + 1))
        cts, tasks, where = {}, [], []
        pt_wrong = 0
        for i, rec in enumerate(window.records):
            if rec is None:
                continue
            req = rec["req"]
            pt_wrong += len(req.ms) if control else rec["pt_bad"]
            for j, row in enumerate(rec["rows"]):
                cts.setdefault((req.batch, row), (key, req.ms[row],
                                                  req.rs[row]))
                where.append((i, j, (req.batch, row)))
        order = list(cts)
        c_of = dict(zip(order, refpool.run(ref.encrypt,
                                           [cts[k] for k in order])))
        for i, j, k in where:
            for s in ids:
                tasks.append((key, c_of[k], self.l, self.shares[s - 1]))
        want = refpool.run(rth.partial, tasks)
        bad, share_wrong, w = set(), 0, iter(want)
        for i, j, k in where:
            rec = window.records[i]
            for s in ids:
                exp = next(w)
                got = (ref.lazy(exp, n2, 16 * self.limbs) if control else
                       rec["shares"][s - 1][j] if rec["shares"] else None)
                if got != exp:
                    share_wrong += 1
                    bad.add(i)
        return {"share_wrong": (share_wrong, 0),
                "pt_wrong": (pt_wrong, 0)}, bad
