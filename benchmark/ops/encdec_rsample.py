"""Batched encryption with the program's own randomness, then CRT
decryption, under one 2048-bit key.

As ``encdec``, except that r is drawn by the program:
``Encryptor(pk, 1).encrypt(ms)``, its sampler reading the Encryptor's
``rng``, which the op sets before each request to a generator seeded for
that request (``inputs.stream(seed, "r/<k>")``, k counting the requests
sent, the warm one apart).  An op is one encryption or one decryption.

Judged: every plaintext against the one encrypted, and ``check_rows``
ciphertexts a request (rows drawn from the seed) against the
reference's encryption with r replayed from the same generator
(``benchmark.reference.rsample``).
"""

from __future__ import annotations

from benchmark import inputs, refpool, roofline
from benchmark.reference import paillier as ref
from benchmark.reference import rsample as rref


class Request:
    def __init__(self, ms):
        self.ms = ms


class Op:
    def __init__(self, cell, seed, device, spans, fault=None):
        from paillier_tpu_torch.core.decrypt import Decryptor
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import LEVEL_ONE
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed, self.fault = spans, seed, fault
        bits = cfg["key_bits"]
        sk = inputs.secret_key(bits, seed)
        p, q, n = sk.p, sk.q, sk.n
        self.key = ref.Key(p, q)
        self.n, self.limbs = n, 2 * (bits // 16)
        self.enc = Encryptor(sk.public(), LEVEL_ONE, device=device)
        self.dec = Decryptor(sk, LEVEL_ONE, crt=True, device=device)
        B = tr["batch"]
        g = inputs.stream(seed, "requests")
        self.requests = [Request([g.randrange(n) for _ in range(B)])
                         for _ in range(tr["distinct_requests"])]
        self.ops_per_request = 2 * B
        self.check_rows = tr["check_rows"]
        self._work = [
            {"kernel": "B1", "mod_bits": m.bit_length(),
             "row_mults": B * roofline.least_mults(e)}
            for m, e in ((n * n, n), (p * p, p - 1), (q * q, q - 1))]
        self.sent = -1                              # the warm request
        self.call(self.requests[0])                 # warm: builds, plans
        self.sent = 0

    def _tag(self, k: int) -> str:
        return f"r/{k}" if k >= 0 else "r/warm"

    def call(self, req):
        k = self.sent
        if self.fault != "rng_not_reseeded" or k < 0:
            self.enc.rng = inputs.stream(self.seed, self._tag(k))
        self.sent += 1
        with self.spans("encrypt"):
            ct = self.enc.encrypt(req.ms)
        if self.fault == "answer_altered":
            ct.c[0, 0] ^= 1
        if self.fault == "half_batch":
            ct.c = ct.c[: ct.c.shape[0] // 2]
        with self.spans("decrypt"):
            pts = self.dec.decrypt(ct)
        return k, ct, pts

    def keep(self, i, req, out):
        k, ct, pts = out
        g = inputs.stream(self.seed, f"check/{i}")
        rows = [g.randrange(len(req.ms)) for _ in range(self.check_rows)]
        got = ct.c[rows] if ct.c.shape[0] == len(req.ms) else None
        c_rows = inputs.from_limbs(got) if got is not None else None
        pt_bad = (abs(len(pts) - len(req.ms))
                  + sum(a != b for a, b in zip(pts, req.ms)))
        return {"req": req, "k": k, "rows": rows, "c": c_rows,
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
            seed = f"{self.seed}/{self._tag(rec['k'])}"
            tasks.append((key, seed, len(req.ms), rec["rows"],
                          [req.ms[j] for j in rec["rows"]]))
            where.append(i)
        want = refpool.run(rref.encrypt_rows, tasks)
        bad, ct_wrong = set(), 0
        for i, ws in zip(where, want):
            rec = window.records[i]
            for j, w in enumerate(ws):
                got = (ref.lazy(w, n2, 16 * self.limbs) if control
                       else (rec["c"][j] if rec["c"] is not None else None))
                if got != w:
                    ct_wrong += 1
                    bad.add(i)
        return {"ct_wrong": (ct_wrong, 0), "pt_wrong": (pt_wrong, 0)}, bad
