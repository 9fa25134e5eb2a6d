"""Batched encryption then CRT decryption under one 2048-bit key.

A request: ``Encryptor(pk, 1).encrypt(ms, rs)`` of ``batch`` plaintexts
uniform below n with randomness r from the seed, then
``Decryptor(sk, 1, crt=True).decrypt`` of the result; an op is one
encryption or one decryption.  The mix's ``distinct_requests`` inputs
are made in set-up and sent in turn.

Judged: every plaintext against the one encrypted, and
``check_rows`` ciphertexts a request (rows drawn from the seed) against
the reference's encryption.
"""

from __future__ import annotations

from benchmark import inputs, refpool, roofline
from benchmark.reference import paillier as ref


class Request:
    def __init__(self, ms, rs):
        self.ms, self.rs = ms, rs


class Op:
    def __init__(self, cell, seed, device, spans, fault=None):
        from paillier_tpu_torch.core.decrypt import Decryptor
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import LEVEL_ONE
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed = spans, seed
        bits = cfg["key_bits"]
        sk = inputs.secret_key(bits, seed)
        p, q, n = sk.p, sk.q, sk.n
        self.key = ref.Key(p, q)
        self.n, self.limbs = n, 2 * (bits // 16)
        self.enc = Encryptor(sk.public(), LEVEL_ONE, device=device)
        self.dec = Decryptor(sk, LEVEL_ONE, crt=True, device=device)
        B = tr["batch"]
        g = inputs.stream(seed, "requests")
        self.requests = [
            Request([g.randrange(n) for _ in range(B)],
                    [inputs.unit(n, g) for _ in range(B)])
            for _ in range(tr["distinct_requests"])]
        self.ops_per_request = 2 * B
        self.check_rows = tr["check_rows"]
        self._work = [
            {"kernel": "B1", "mod_bits": m.bit_length(),
             "row_mults": B * roofline.least_mults(e)}
            for m, e in ((n * n, n), (p * p, p - 1), (q * q, q - 1))]
        self.fault = fault
        self.call(self.requests[0])                 # warm: builds, plans

    def call(self, req):
        with self.spans("encrypt"):
            ct = self.enc.encrypt(req.ms, req.rs)
        if self.fault == "answer_altered":
            ct.c[0, 0] ^= 1
        if self.fault == "half_batch":
            ct.c = ct.c[: ct.c.shape[0] // 2]
        with self.spans("decrypt"):
            pts = self.dec.decrypt(ct)
        return ct, pts

    def keep(self, i, req, out):
        ct, pts = out
        g = inputs.stream(self.seed, f"check/{i}")
        rows = [g.randrange(len(req.ms)) for _ in range(self.check_rows)]
        got = ct.c[rows] if ct.c.shape[0] == len(req.ms) else None
        c_rows = inputs.from_limbs(got) if got is not None else None
        pt_bad = (abs(len(pts) - len(req.ms))
                  + sum(a != b for a, b in zip(pts, req.ms)))
        return {"req": req, "rows": rows, "c": c_rows,
                "pt_bad": pt_bad}, pt_bad == 0 and c_rows is not None

    def work(self, req):
        return self._work

    def free(self):
        self.enc = self.dec = None

    def check(self, window, control=False):
        """{name: (value, limit)} and the indices of failed requests."""
        key, n2 = self.key, self.n * self.n
        tasks, where = [], []
        pt_wrong = 0
        for i, rec in enumerate(window.records):
            if rec is None:
                continue
            req = rec["req"]
            pt_wrong += len(req.ms) if control else rec["pt_bad"]
            for j, row in enumerate(rec["rows"]):
                tasks.append((key, req.ms[row], req.rs[row]))
                where.append((i, j))
        want = refpool.run(ref.encrypt, tasks)
        bad, ct_wrong = set(), 0
        for (i, j), w in zip(where, want):
            rec = window.records[i]
            got = (ref.lazy(w, n2, 16 * self.limbs) if control
                   else (rec["c"][j] if rec["c"] is not None else None))
            if got != w:
                ct_wrong += 1
                bad.add(i)
        return {"ct_wrong": (ct_wrong, 0), "pt_wrong": (pt_wrong, 0)}, bad
