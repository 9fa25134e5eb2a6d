"""Weighted tallies over a device-resident pool of level-1 ciphertexts.

Set-up encrypts ``base`` plaintexts (uniform below n) with randomness
r_i = u^(i+1) mod n for a unit u from the seed, then fills the rest of a
``pool``-row pool block by block with homomorphic adds of the base and
the base shifted by a seeded offset, so pool row j*base + i holds
m_i + m_(i+s_j) under r = u^(i+1) u^((i+s_j mod base)+1).  A request
takes a seeded block of ``block`` rows, raises each to a ``weight_bits``
weight (``homomorphic.const_mult`` with per-element weights), multiplies
the block together (``homomorphic.aggregate``) and ``add``s the result
into a running tally; an op is one weighted addition.

Because every r is a power of u, the reference gets each weighted sum
exactly without the pool: Enc(sum w_i m_i; u^(sum w_i k_i)), one
exponentiation a request.  Judged: every request's weighted sum and
every value of the running tally, bit for bit.
"""

from __future__ import annotations

from benchmark import inputs, refpool, roofline
from benchmark.reference import paillier as ref


class Request:
    def __init__(self, start, weights):
        self.start, self.weights = start, weights
        self.mults = None


class Op:
    def __init__(self, cell, seed, device, spans, fault=None):
        import torch
        from paillier_tpu_torch.core import homomorphic as hom
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import LEVEL_ONE, Ciphertext
        self.torch, self.hom, self.Ciphertext = torch, hom, Ciphertext
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed, self.fault = spans, seed, fault
        bits = cfg["key_bits"]
        sk = inputs.secret_key(bits, seed)
        self.key = ref.Key(sk.p, sk.q)
        n = self.n = sk.n
        self.pk = sk.public()
        self.limbs = 2 * (bits // 16)
        base, pool, self.block = tr["base"], tr["pool"], tr["block"]
        g = inputs.stream(seed, "pool")
        self.u = inputs.unit(n, g)
        self.m0 = [g.randrange(n) for _ in range(base)]
        self.shifts = [0] + [g.randrange(1, base)
                             for _ in range(pool // base - 1)]
        rs, r = [], 1
        for _ in range(base):
            r = r * self.u % n
            rs.append(r)
        enc = Encryptor(self.pk, LEVEL_ONE, device=device)
        step = tr["encrypt_batch"]
        b = torch.cat([enc.encrypt(self.m0[i:i + step], rs[i:i + step]).c
                       for i in range(0, base, step)])
        self.pool = torch.empty((pool, self.limbs), dtype=torch.int64,
                                device=device)
        self.pool[:base] = b
        for j, s in enumerate(self.shifts[1:], start=1):
            shifted = Ciphertext(c=torch.roll(b, -s, dims=0))
            self.pool[j * base:(j + 1) * base] = hom.add(
                self.pk, Ciphertext(c=b), shifted).c
        del b
        self.base = base
        g = inputs.stream(seed, "requests")
        self.requests = [
            Request(g.randrange(pool - self.block + 1),
                    [g.getrandbits(tr["weight_bits"])
                     for _ in range(self.block)])
            for _ in range(tr["distinct_requests"])]
        self.ops_per_request = self.block
        one = torch.zeros(self.limbs, dtype=torch.int64, device=device)
        one[0] = 1
        self._one = one
        self.tally = Ciphertext(c=one.clone(), level=LEVEL_ONE)
        self.call(self.requests[0])                 # warm: builds, plans
        self.tally = Ciphertext(c=one.clone(), level=LEVEL_ONE)

    def call(self, req):
        hom, blk = self.hom, self.Ciphertext(
            c=self.pool[req.start:req.start + self.block])
        w = req.weights
        if self.fault == "half_batch":
            blk = self.Ciphertext(c=blk.c[: self.block // 2])
            w = w[: self.block // 2]
        with self.spans("const_mult"):
            cm = hom.const_mult(self.pk, blk, w)
        with self.spans("aggregate"):
            agg = hom.aggregate(self.pk, cm)
        if self.fault == "answer_altered":
            agg.c[0] ^= 1
        with self.spans("add"):
            tally = hom.add(self.pk, self.tally, agg)
        if self.fault != "state_unchanged":
            self.tally = tally
        return agg.c.cpu(), self.tally.c.cpu()

    def keep(self, i, req, out):
        agg, tally = out
        return {"req": req, "sum": inputs.from_limbs(agg[None])[0],
                "tally": inputs.from_limbs(tally[None])[0]}, True

    def work(self, req):
        if req.mults is None:
            req.mults = int(roofline.least_mults_rows(req.weights).sum())
        return [{"kernel": "B2", "mod_bits": (self.n ** 2).bit_length(),
                 "row_mults": req.mults}]

    def free(self):
        self.pool = self.tally = self._one = None

    def _row(self, g: int) -> tuple[int, int]:
        """(m, k) of pool row g: its plaintext and r = u^k."""
        j, i = divmod(g, self.base)
        if j == 0:
            return self.m0[i], i + 1
        i2 = (i + self.shifts[j]) % self.base
        return self.m0[i] + self.m0[i2], i + 1 + i2 + 1

    def _sums(self, req) -> tuple[int, int]:
        """(sum w_i m_i mod n, sum w_i k_i) of a request's block."""
        M = E = 0
        for w, g in zip(req.weights, range(req.start,
                                           req.start + self.block)):
            m, k = self._row(g)
            M += w * m
            E += w * k
        return M % self.n, E

    def check(self, window, control=False):
        key, n, n2 = self.key, self.n, self.n ** 2
        sums: dict = {}
        tasks, M_tot, E_tot = [], 0, 0
        for rec in window.records:
            if rec is None:
                continue
            req = rec["req"]
            if id(req) not in sums:
                sums[id(req)] = self._sums(req)
            M, E = sums[id(req)]
            M_tot, E_tot = (M_tot + M) % n, E_tot + E
            tasks.append((key, M, pow(self.u, E, n)))
            tasks.append((key, M_tot, pow(self.u, E_tot, n)))
        want = refpool.run(ref.encrypt, tasks)
        bad, sum_wrong, tally_wrong = set(), 0, 0
        k = 0
        for i, rec in enumerate(window.records):
            if rec is None:
                continue
            ws, wt = want[k], want[k + 1]
            k += 2
            gs, gt = rec["sum"], rec["tally"]
            if control:
                gs, gt = (ref.lazy(ws, n2, 16 * self.limbs),
                          ref.lazy(wt, n2, 16 * self.limbs))
            if gs != ws:
                sum_wrong += 1
                bad.add(i)
            if gt != wt:
                tally_wrong += 1
                bad.add(i)
        return {"sum_wrong": (sum_wrong, 0),
                "tally_wrong": (tally_wrong, 0)}, bad
