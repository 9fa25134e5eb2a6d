"""Verifiable (t, l)-threshold decryption with one faulty server.

The key as ``threshold``'s: the configuration's two fixed safe primes
through ``ThresholdKeyGenerator.generate_from_primes``, the dealer's
draws from the seed, and a pool of ``pool_batches`` batches encrypted in
set-up.  A request takes the next batch: servers 1 to
``responding_servers`` prove their partial decryptions of it
(``partial_decrypt_with_zkp_batch``, server s drawing its r from a
generator seeded for the request and the server,
``inputs.stream(seed, "zkp/<k>/<s>")``, k counting the requests sent,
the warm one apart); then one server drawn from the seed has one seeded
row of its shares altered after proving (the low bit of its partial
decryption flipped), and ``combine_with_zkp_batch`` verifies every
proof, drops that server and combines the others.  An op is one
plaintext recovered.

Judged, with limit 0 each (``benchmark.reference.threshold_zkp``):
``pt_wrong``, every plaintext against the one encrypted, and at the
checked rows against the reference's combination of the servers its
verifier keeps; ``share_wrong``, the partial decryptions of
``check_rows`` rows (drawn from the seed) and the altered row, of every
server; ``proof_wrong``, e and z of those rows of every server against
the reference's proofs from the replayed r; ``verdict_wrong``, the
program's verdicts on those rows against the reference verifier's, the
altered row's being false; ``dropped_wrong``, the servers dropped by the
program and by the reference against the faulty one alone.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from benchmark import inputs, refpool, roofline
from benchmark.ops.threshold import lagrange2, primes
from benchmark.reference import paillier as ref
from benchmark.reference import threshold as rth
from benchmark.reference import threshold_zkp as rz


class Request:
    def __init__(self, batch, ms, rs):
        self.batch, self.ms, self.rs = batch, ms, rs


def _windows() -> tuple:
    """The greedy scan of :func:`least_mults_many` as tables over a 16-bit
    chunk, most significant bit first, for every window w = 1..8 at once:
    from state s (bits of the current window still to pass) and a chunk,
    the next state and the windows started; each [8, 8, 65536]."""
    chunk = np.arange(1 << 16, dtype=np.int64)
    nxt = np.zeros((8, 8, 1 << 16), dtype=np.int8)
    started = np.zeros((8, 8, 1 << 16), dtype=np.int8)
    for w in range(1, 9):
        for s0 in range(w):
            s = np.full(chunk.shape, s0, dtype=np.int64)
            n = np.zeros(chunk.shape, dtype=np.int64)
            for bit in range(15, -1, -1):
                on = (s == 0) & ((chunk >> bit) & 1 == 1)
                n += on
                s = np.where(on, w - 1, np.maximum(s - 1, 0))
            nxt[w - 1, s0], started[w - 1, s0] = s, n
    return nxt, started


_TABLES: list = []


def least_mults_many(exps: list) -> np.ndarray:
    """``roofline.least_mults`` of each exponent of ``exps``, vectorised
    over the rows.  A window of the left-to-right sliding ladder starts at
    the first 1 bit at or after the previous start plus w, so the windows
    are counted by one scan of the exponent's 16-bit chunks; the leading
    window's length is that of the top min(w, bits) bits cut back to
    their last 1."""
    if not _TABLES:
        _TABLES.extend(_windows())
    nxt, started = _TABLES
    nb = np.array([e.bit_length() for e in exps], dtype=np.int64)
    width = max(1, (int(nb.max()) + 15) // 16) if len(exps) else 1
    raw = np.frombuffer(b"".join(e.to_bytes(2 * width, "big") for e in exps),
                        dtype=">u2").reshape(len(exps), width).astype(
                            np.int64)
    ws = np.arange(8)[:, None]
    s = np.zeros((8, len(exps)), dtype=np.int64)
    count = np.zeros((8, len(exps)), dtype=np.int64)
    for col in range(width):
        chunk = raw[None, :, col]
        count += started[ws, s, chunk]
        s = nxt[ws, s, chunk].astype(np.int64)
    lead = np.zeros((8, len(exps)), dtype=np.int64)
    for j, (e, b) in enumerate(zip(exps, nb.tolist())):
        for w in range(1, 9):
            top = e >> max(b - w, 0)
            lead[w - 1, j] = (min(w, b) - ((top & -top).bit_length() - 1)
                              if top else 0)
    table = np.array([(1 << (w - 1)) if w > 1 else 0
                      for w in range(1, 9)])[:, None]
    mults = 1 + table + (nb[None, :] - lead) + 1 + (count - 1)
    return np.where(nb == 0, 0, mults.min(axis=0))


class Op:
    def __init__(self, cell, seed, device, spans, fault=None):
        import torch
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import LEVEL_ONE, Ciphertext
        from paillier_tpu_torch.threshold import (
            CombinedWithZKP, ThresholdKeyGenerator, combine,
            combine_with_zkp_batch, partial_decrypt_with_zkp_batch)
        self.torch = torch
        self.Ciphertext, self.CombinedWithZKP = Ciphertext, CombinedWithZKP
        self.combine = combine
        self.prove = partial_decrypt_with_zkp_batch
        self.combine_zkp = combine_with_zkp_batch
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed, self.fault = spans, seed, fault
        p, q = primes(cfg)
        self.key = ref.Key(p, q)
        n = self.n = p * q
        l, t = cfg["servers"], cfg["threshold"]
        self.l, self.t = l, t
        self.shares = rth.shares(p, q, l, t, inputs.stream(seed, "dealer"))
        self.v, self.vis = rz.verification_keys(
            self.key, l, self.shares, inputs.stream(seed, "dealer"))
        tsks = ThresholdKeyGenerator(
            n.bit_length(), l, t, inputs.stream(seed, "dealer"),
            device=device).generate_from_primes(p, (p - 1) // 2, q,
                                                (q - 1) // 2)
        self.servers = tsks[:tr["responding_servers"]]
        self.ids = [s.id for s in self.servers]
        self.tpk = tsks[0].public()
        self.limbs = 2 * (n.bit_length() // 16)
        B = self.B = tr["batch"]
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
        self.delta = math.factorial(l)
        self.n2_bits = (n * n).bit_length()
        self._traced: dict = {}         # window index -> (k, faulty, e)
        self._worked = 0
        self.sent = -1                              # the warm request
        self.call(self.requests[0])
        self.sent = 0

    def _tag(self, k: int) -> str:
        return str(k) if k >= 0 else "warm"

    def call(self, req):
        k = self.sent
        self.sent += 1
        g = inputs.stream(self.seed, f"fault/{self._tag(k)}")
        faulty, row = g.choice(self.ids), g.randrange(self.B)
        ct = self.Ciphertext(c=self.pool[req.batch])
        rngs = [inputs.stream(self.seed, f"zkp/{self._tag(k)}/{s.id}")
                for s in self.servers]
        with self.spans("zkp_prove"):
            batches = self.prove(self.servers, ct, rngs)
        batches[self.ids.index(faulty)].ci[row, 0] ^= 1
        if self.fault == "half_batch":
            half = self.B // 2
            batches = [dataclasses.replace(
                b, c=b.c[:half], ci=b.ci[:half], e=b.e[:half], z=b.z[:half])
                for b in batches]
        with self.spans("zkp_combine"):
            res = self.combine_zkp(self.tpk, batches)
        if self.fault == "answer_altered":
            res.plaintexts[0] ^= 1
        if self.fault == "faulty_kept":
            res = self.CombinedWithZKP(
                plaintexts=self.combine(self.tpk,
                                        [b.partials() for b in batches]),
                kept=list(self.ids), dropped=[], verdicts=res.verdicts)
        if self.fault == "honest_dropped":
            honest = next(i for i in self.ids if i != faulty)
            res.dropped = sorted(res.dropped + [honest])
            res.kept = [i for i in res.kept if i != honest]
        return {"k": k, "faulty": faulty, "row": row, "batches": batches,
                "res": res}

    def keep(self, i, req, out):
        batches, res = out["batches"], out["res"]
        g = inputs.stream(self.seed, f"check/{i}")
        rows = [g.randrange(len(req.ms)) for _ in range(self.check_rows)]
        look = rows + [out["row"]]
        pts = res.plaintexts
        got = None
        if all(b.ci.shape[0] == len(req.ms) for b in batches):
            torch = self.torch
            rows = torch.stack([torch.cat([b.ci[look], b.e[look], b.z[look]],
                                          dim=1) for b in batches]).cpu()
            oks = torch.stack([v[look] for v in res.verdicts]).tolist()
            w1, w2 = batches[0].ci.shape[1], batches[0].e.shape[1]
            got = {}
            for b, x, ok in zip(batches, rows, oks):
                ci, e, z = (inputs.from_limbs(y) for y in (
                    x[:, :w1], x[:, w1:w1 + w2], x[:, w1 + w2:]))
                got[b.id] = (list(zip(ci, e, z)), ok)
        pt_bad = (abs(len(pts) - len(req.ms))
                  + sum(a != b for a, b in zip(pts, req.ms)))
        if self.spans.enabled and got is not None:     # for work()
            self._traced[i] = (out["k"], out["faulty"],
                               {b.id: b.e.cpu() for b in batches})
        return {"req": req, "k": out["k"], "faulty": out["faulty"],
                "row": out["row"], "look": look, "got": got,
                "pts": [pts[r] if r < len(pts) else None for r in look],
                "dropped": list(res.dropped),
                "pt_bad": pt_bad}, pt_bad == 0 and got is not None

    def work(self, req):
        """The ladders of the window's next request: B1 a server, the
        provers' two commitment ladders and the verifier's four a server
        on B2 with their per-row exponents (r, z, e), and the combine's
        Lagrange ladder over the servers kept."""
        i = self._worked
        self._worked += 1
        if i not in self._traced:
            return []
        k, faulty, es = self._traced.pop(i)
        es = {s: inputs.from_limbs(e) for s, e in es.items()}
        n2, B = self.n * self.n, self.B
        item = dict(mod_bits=self.n2_bits)
        out = []
        for s in self.servers:
            ds = self.delta * self.shares[s.id - 1]
            rs = rz.draws(n2, f"{self.seed}/zkp/{self._tag(k)}/{s.id}", B)
            zs = [r + e * ds for r, e in zip(rs, es[s.id])]
            out.append(dict(item, kernel="B1", row_mults=B * roofline
                            .least_mults(2 * ds)))
            out.append(dict(item, kernel="B2", row_mults=int(
                2 * least_mults_many(rs).sum()
                + 2 * least_mults_many(zs).sum()
                + 2 * least_mults_many(es[s.id]).sum())))
        kept = [j for j in self.ids if j != faulty]
        out.append(dict(item, kernel="B2", row_mults=B * sum(
            roofline.least_mults(e) for e in lagrange2(kept, self.delta))))
        return out

    def free(self):
        self.pool = self.servers = self.tpk = None

    def check(self, window, control=False):
        key = self.key
        tasks, where = [], []
        pt_wrong = 0
        for i, rec in enumerate(window.records):
            if rec is None:
                continue
            req = rec["req"]
            pt_wrong += len(req.ms) if control else rec["pt_bad"]
            look = rec["look"]
            for s in self.ids:
                got = rec["got"][s][0] if rec["got"] else [None] * len(look)
                tasks.append((key, self.v, self.vis[s - 1], self.l,
                              self.shares[s - 1],
                              f"{self.seed}/zkp/{self._tag(rec['k'])}/{s}",
                              look, [req.ms[j] for j in look],
                              [req.rs[j] for j in look], got))
                where.append((i, s))
        results = dict(zip(where, refpool.run(rz.check_server, tasks)))
        bad = set()
        totals = dict.fromkeys(("pt_wrong", "share_wrong", "proof_wrong",
                                "verdict_wrong", "dropped_wrong"), 0)
        totals["pt_wrong"] = pt_wrong
        for i, rec in enumerate(window.records):
            if rec is None:
                continue
            wrong = self._judge(rec, [results[(i, s)] for s in self.ids],
                                control)
            for name, v in wrong.items():
                totals[name] += v
            if any(wrong.values()):
                bad.add(i)
        return {k: (v, 0) for k, v in totals.items()}, bad

    def _judge(self, rec, results, control) -> dict:
        """The counts of one request: the program's answers at the checked
        rows against the reference's (``results``: a server's proofs and
        verdicts, from ``rz.check_server``)."""
        n2 = self.n ** 2
        req, look, faulty = rec["req"], rec["look"], rec["faulty"]
        out = dict.fromkeys(("pt_wrong", "share_wrong", "proof_wrong",
                             "verdict_wrong", "dropped_wrong"), 0)
        ref_dropped = set()
        kept = [dict() for _ in look]
        for s, (want, ref_ok) in zip(self.ids, results):
            got, ok = rec["got"][s] if rec["got"] else (None, None)
            for j, row in enumerate(look):
                w_ci, w_e, w_z = want[j]
                if s == faulty and row == rec["row"]:
                    w_ci ^= 1                         # the planted fault
                    out["verdict_wrong"] += ref_ok[j]  # must not verify
                if control:
                    g = (ref.lazy(w_ci, n2, 16 * self.limbs), w_e, w_z)
                else:
                    g = got[j] if got is not None else (None,) * 3
                out["share_wrong"] += g[0] != w_ci
                out["proof_wrong"] += (g[1] != w_e) + (g[2] != w_z)
                out["verdict_wrong"] += ok is None or ok[j] != ref_ok[j]
                if ref_ok[j]:
                    kept[j][s] = w_ci
                else:
                    ref_dropped.add(s)
        out["dropped_wrong"] = (len(set(rec["dropped"]) ^ {faulty})
                                + len(ref_dropped ^ {faulty}))
        for j, row in enumerate(look):
            m = (rz.combine(self.key, self.l, kept[j])
                 if len(kept[j]) >= self.t else None)
            out["pt_wrong"] += (m != req.ms[row]) + (
                not control and rec["pts"][j] != m)
        return out
