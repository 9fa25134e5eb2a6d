"""DDLEQ proofs of nested re-encryption, sharded across the ranks.

One rank a card (``paillier_tpu_torch.parallel.launch.run_ranks``, NCCL;
gloo ranks on the CPU in the tests), the flat stages of each chunk
sharded over a one-axis mesh (``prove`` / ``verify`` with ``mesh=``).
Set-up makes ``pool_chunks`` chunks of ``chunk`` statements from the
seed: ct1 = Enc_2(Enc_1(m; r1); r2), ct2 = ct1^(a^n mod n^2) b^(n^2)
(``nested_randomize``), and a copy of ct2 with one seeded row replaced by
the next row's, which that row's proof must fail against.  A request
proves the next chunk with fresh prover randomness, then verifies the
proofs against that copy; an op is one proof proven and verified.  Rank
0 times the requests and tells the others when the window ends.

Judged: the prover's draws x and y of every instance (a fingerprint of
their limbs against the reference's draws), ``check_instances``
instances a request (drawn from the seed) against the reference's
proof, every rank's proof against rank 0's (fingerprints), and every
rank's verdicts: true for each proof, false for the one against the
altered row, as the reference verifier finds it.
"""

from __future__ import annotations

import tempfile

import numpy as np

from benchmark import harness, inputs, refpool
from benchmark.reference import ddleq as rdd
from benchmark.reference import paillier as ref

# the ranks run under paillier_tpu_torch.parallel.launch.run_ranks
RANKED = True
FIELDS = ("x", "y", "alpha", "e", "f")


def pool_inputs(seed: int, n: int, chunk: int, chunks: int) -> list:
    """Per chunk: (ms, r1, r2, a, b, swapped row)."""
    g = inputs.stream(seed, "pool")
    out = []
    for _ in range(chunks):
        ms = [g.randrange(n) for _ in range(chunk)]
        r1, r2, a, b = ([inputs.unit(n, g) for _ in range(chunk)]
                        for _ in range(4))
        out.append((ms, r1, r2, a, b, g.randrange(chunk)))
    return out


def weights(seed: int, size: int) -> np.ndarray:
    """The fingerprint's weights: int64 below 2^20 (a weighted sum of
    16-bit limbs stays far below 2^63)."""
    return np.random.default_rng(
        np.frombuffer(f"{seed}/fingerprint".encode(), np.uint8)
    ).integers(0, 1 << 20, size=size, dtype=np.int64)


def fingerprint(limbs: np.ndarray, w: np.ndarray) -> int:
    flat = limbs.reshape(-1)
    return int((flat * w[:flat.size]).sum())


class Op:
    """One rank's set-up and calls."""

    def __init__(self, cell, seed, device, spans, fault=None, mesh=None):
        import torch
        from paillier_tpu_torch.core import homomorphic as hom
        from paillier_tpu_torch.core.encrypt import Encryptor
        from paillier_tpu_torch.core.keys import (LEVEL_ONE, LEVEL_TWO,
                                                  Ciphertext)
        from paillier_tpu_torch.zk import ddleq as zd
        self.torch, self.zd, self.Ciphertext = torch, zd, Ciphertext
        cfg, tr = cell.config, cell.traffic
        self.spans, self.seed, self.fault, self.mesh = spans, seed, fault, mesh
        bits = cfg["key_bits"]
        self.sk = inputs.secret_key(bits, seed)
        n = self.sk.n
        self.pk = self.sk.public()
        self.secpar, C = cfg["secpar"], tr["chunk"]
        e1 = Encryptor(self.pk, LEVEL_ONE, device=device)
        e2 = Encryptor(self.pk, LEVEL_TWO, device=device)
        self.requests = []
        for ms, r1, r2, a, b, sw in pool_inputs(seed, n, C,
                                                tr["pool_chunks"]):
            ct1 = e2.encrypt(e1.encrypt(ms, r1).c, r2)
            ct2, _, _ = hom.nested_randomize(self.pk, ct1,
                                             rs=list(zip(a, b)))
            alt = ct2.c.clone()
            alt[sw] = ct2.c[(sw + 1) % C]
            self.requests.append((ct1, ct2, Ciphertext(c=alt, level=LEVEL_TWO),
                                  a, b, sw))
        self.ops_per_request = C
        self.check_instances = tr["check_instances"]
        L = bits // 16
        self.w = torch.as_tensor(weights(seed, C * self.secpar * 3 * L),
                                 device=device)
        if fault == "exchange_left_out":
            def local(t, group):
                import torch.distributed as dist
                return t.unsqueeze(0).expand(
                    (dist.get_world_size(group),) + tuple(t.shape)).clone()
            zd._all_gather = local
        self.rank0 = True
        self.sent = -1                              # the warm request
        self.call(self.requests[0])
        self.sent = 0

    def call(self, req):
        ct1, ct2, alt, a, b, _ = req
        rng = inputs.stream(self.seed, f"prover/{self.sent}")
        self.sent += 1
        if self.fault == "half_batch":
            h = ct1.c.shape[0] // 2
            ct1, ct2, alt = (self.Ciphertext(c=c.c[:h], level=2)
                             for c in (ct1, ct2, alt))
            a, b = a[:h], b[:h]
        with self.spans("prove"):
            proof = self.zd.prove(self.sk, ct1, ct2, a, b, self.secpar, rng,
                                  mesh=self.mesh)
        if self.fault == "answer_altered":
            proof.f[0, 0, 0] ^= 1
        with self.spans("verify"):
            verdicts = self.zd.verify(self.pk, ct1, alt, proof,
                                      mesh=self.mesh)
        return proof, verdicts

    def keep(self, i, req, out):
        proof, verdicts = out
        fps = [int((getattr(proof, f).reshape(-1)
                    * self.w[:getattr(proof, f).numel()]).sum())
               for f in FIELDS]
        rec = {"chunk": i % len(self.requests), "fps": fps,
               "verdicts": verdicts}
        sw = req[5]
        C = self.ops_per_request
        ok = verdicts == [j != sw for j in range(C)]
        if self.rank0:
            g = inputs.stream(self.seed, f"check/{i}")
            picks = [(g.randrange(C), g.randrange(self.secpar))
                     for _ in range(self.check_instances)]
            shape = proof.x.shape
            if shape[0] == C:
                rec["picks"] = [(bb, s, [inputs.from_limbs(
                    getattr(proof, f)[bb, s][None])[0] for f in FIELDS])
                    for bb, s in picks]
                cols = [inputs.from_limbs(getattr(proof, f)[sw])
                        for f in FIELDS]
                rec["swapped"] = list(zip(*cols))
            else:
                rec["picks"], rec["swapped"] = None, None
        return rec, ok

    def free(self):
        self.requests = self.sk = self.w = None


# -- the ranks --------------------------------------------------------------

def rank_body(rank: int, world: int, params: dict) -> dict:
    """One rank of a run: set-up, the window (rank 0 decides when it
    ends), and what the main process needs to judge and report."""
    import torch
    import torch.distributed as dist
    from paillier_tpu_torch.parallel import make_mesh
    from benchmark.traces import Tracer
    cell = harness.Cell(**params["cell"])
    dev = (torch.device("cpu") if params["device"] == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    spans = harness.Spans(params["trace"], dev)
    mesh = make_mesh(device_type=dev.type)
    op = Op(cell, params["seed"], dev, spans, params.get("fault"), mesh)
    dist.barrier()
    spans.items.clear()                       # the warm request's spans
    tracer = Tracer(dev) if params["trace"] and dev.type == "cuda" else None
    if tracer:
        tracer.start()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    op.rank0 = rank == 0

    def agree(done):
        flag.fill_(1 if done else 0)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    win = harness.measure(op, params["seconds"], spans, agree=agree)
    trace = tracer.stop(spans) if tracer else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {"rank": rank, "records": win.records, "failed": win.failed,
           "errors": win.errors, "latencies": win.latencies,
           "window_s": win.seconds, "start_wall": win.start_wall,
           "spans": spans.durations(), "peak": peak,
           "busy_s": trace.busy_s() if trace else None,
           "trace_window_s": trace.window_s if trace else None,
           "trace": trace if rank == 0 else None,
           "forbidden": harness.forbidden_modules(),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")}
    op.free()
    return out


def run_ranks(cell, seed, seconds, trace, device, fault, world):
    """Start ``world`` ranks (NCCL one a card, or gloo on the CPU) and
    return their results in rank order."""
    from paillier_tpu_torch.parallel.launch import run_ranks as spawn
    params = {"cell": cell.__dict__, "seed": seed, "seconds": seconds,
              "trace": trace, "device": device, "fault": fault}
    with tempfile.TemporaryDirectory(prefix="bench-rdv-") as tmp:
        return spawn(rank_body, world, params, init_dir=tmp,
                     timeout=seconds + 300,
                     backend="gloo" if device == "cpu" else "nccl")


# -- the reference's judgement (main process) -------------------------------

def _statement(key, ms, r1, r2, a, b, j):
    ct1 = rdd.nested_encrypt(key, ms[j], r1[j], r2[j])
    return ct1, rdd.randomize(key, ct1, a[j], b[j])


def _instance(key, ct1, ct2, a, b, s, x, y):
    return rdd.instance(key, ct1, ct2, a, b, s, x, y)


def check(cell, seed, results, control=False):
    """{name: (value, limit)} and the failed requests' indices, from the
    ranks' records."""
    cfg, tr = cell.config, cell.traffic
    p, q = inputs.key_primes(cfg["key_bits"], seed)
    key = ref.Key(p, q)
    n, S, C = p * q, cfg["secpar"], tr["chunk"]
    L = cfg["key_bits"] // 16
    pool = pool_inputs(seed, n, C, tr["pool_chunks"])
    w = weights(seed, C * S * 3 * L)
    recs0 = results[0]["records"]
    bad: set = set()
    # every rank holds rank 0's proof and verdicts
    rank_disagree = 0
    for i, rec in enumerate(recs0):
        for r in results[1:]:
            other = r["records"][i] if i < len(r["records"]) else None
            if rec is None or other is None or other["fps"] != rec["fps"] \
                    or other["verdicts"] != rec["verdicts"]:
                rank_disagree += 1
                bad.add(i)
                break
    # x and y of every instance: the prover's draws
    proof_wrong = 0
    draws: dict = {}
    for i, rec in enumerate(recs0):
        if rec is None:
            continue
        rng = inputs.stream(seed, f"prover/{i}")
        for f in ("x", "y"):
            vals = rdd.draw_units(n, C * S, rng)
            draws[i, f] = vals
            if control:
                vals = [ref.lazy(v, n, 16 * L) for v in vals]
            if fingerprint(inputs.to_limbs(vals, L), w) != \
                    rec["fps"][FIELDS.index(f)]:
                proof_wrong += 1
                bad.add(i)
    # the statements the sampled and the altered proofs need
    need = set()
    for rec in recs0:
        if rec is None or rec.get("picks") is None:
            continue
        ch = pool[rec["chunk"]]
        need |= {(rec["chunk"], bb) for bb, _, _ in rec["picks"]}
        need |= {(rec["chunk"], ch[5]), (rec["chunk"], (ch[5] + 1) % C)}
    order = sorted(need)
    stm = dict(zip(order, refpool.run(_statement, [
        (key,) + tuple(pool[c][:5]) + (j,) for c, j in order])))
    tasks, where = [], []
    for i, rec in enumerate(recs0):
        if rec is None or rec.get("picks") is None:
            continue
        ms, r1, r2, a, b, sw = pool[rec["chunk"]]
        for k, (bb, s, got) in enumerate(rec["picks"]):
            ct1, ct2 = stm[(rec["chunk"], bb)]
            x, y = draws[i, "x"][bb * S + s], draws[i, "y"][bb * S + s]
            tasks.append((key, ct1, ct2, a[bb], b[bb], r2[bb], x, y))
            where.append((i, k))
    want = refpool.run(_instance, tasks)
    for (i, k), inst in zip(where, want):
        got = recs0[i]["picks"][k][2]
        if control:
            got = [ref.lazy(v, m, 16 * w_) for v, m, w_ in
                   zip(inst, (n, n, n ** 3, n * n, n ** 3),
                       (L, L, 3 * L, 2 * L, 3 * L))]
        if list(got) != list(inst):
            proof_wrong += 1
            bad.add(i)
    for i, rec in enumerate(recs0):
        if rec is not None and rec.get("picks") is None:
            proof_wrong += 1
            bad.add(i)
    # verdicts: true for each proof, the reference's verdict for the one
    # proven against the altered row
    vtasks, vwhere = [], []
    for i, rec in enumerate(recs0):
        if rec is None or rec.get("swapped") is None:
            continue
        sw = pool[rec["chunk"]][5]
        ct1 = stm[(rec["chunk"], sw)][0]
        alt = stm[(rec["chunk"], (sw + 1) % C)][1]
        vtasks.append((key, ct1, alt, rec["swapped"]))
        vwhere.append(i)
    vwant = dict(zip(vwhere, refpool.run(rdd.verify, vtasks)))
    verdict_wrong = 0
    for r in results:
        for i, rec in enumerate(r["records"]):
            if rec is None:
                verdict_wrong += C
                bad.add(i)
                continue
            sw = pool[rec["chunk"]][5]
            want_v = [True] * C
            want_v[sw] = vwant.get(i, False)
            got_v = [False] * C if control else rec["verdicts"]
            wrong = sum(g != v for g, v in zip(got_v, want_v)) + abs(
                len(got_v) - C)
            if wrong:
                verdict_wrong += wrong
                bad.add(i)
    return {"proof_wrong": (proof_wrong, 0),
            "rank_disagree": (rank_disagree, 0),
            "verdict_wrong": (verdict_wrong, 0)}, bad
