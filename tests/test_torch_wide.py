"""Every key width the JAX package takes: kernel B4w
(``paillier_tpu_torch/csrc/limb_modexp_wide.cu``, the limb Montgomery
ladder past kernel B4's 768 limbs) and the limb branches that the wide
keys run, against the JAX package on the CPU.

* B4w's launch rules as pure functions (the variant by width, rows and
  SMs, the padded words, the shared-memory bytes of a row, the switch of
  the table and then the operands to global memory, the warps, cluster
  size and column pairs of a launch, the Hensel-lifted n' of a padded
  R), and its three-product Montgomery multiply, normalisation,
  carry-lookahead and ladder emulated thread by thread on its
  shared-memory layout (clusters of blocks included), against Python
  integers, the JAX package's ``pallas_kernels._mont_mul`` and the plain
  version.
* Threshold decryption on the limb engine of n^2 (``partial_decrypt_all``
  and ``combine``'s product trees) at 64- and 128-bit threshold keys,
  with ``rns2.MAX_MODULUS_BITS`` lowered so that the factory gives n^2
  the limb engine: equal to the port's own RNS engine at both widths and
  to the JAX package's functions (which take their limb branches on the
  CPU backend) at 64 bits.
* ``Decryptor(crt=True)`` with the limit lowered below p^2, so that its
  halves take the limb engine, against its halves on the RNS engine at
  256- and 512-bit keys and against the JAX package's
  ``crt_decrypt_kernel`` at 256 bits.

The JAX package compiles each of its functions at each width (≈ 12 s a
threshold width, 12-15 s a CRT width on this suite's CPU), so it runs
at one width of each.
* DDLEQ's CRT plans past 5,774-bit keys: both packages raise (p^3 past
  8,661 bits), the port in ``crt_plans``'s guard.
* Full width: an 8192-bit key (fixed 4096-bit primes) builds its
  Encryptor and Decryptor at levels 1 and 2, crt=True and False, and
  its level-2 ladder (L = 1,536) equals pow on one row over 4 digits.

On the CPU every ladder is the kernels' plain version (the tensors lie on
the CPU); B4w itself runs in tests/test_torch_kernels.py on the card.
Tolerance: exact (limbs as uint32, values as ints).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paillier_tpu_torch as pt
from paillier_tpu.core import decrypt as jdec
from paillier_tpu.core import keys as jkeys
from paillier_tpu.threshold import decrypt as jtdec
from paillier_tpu.threshold import keys as jtkeys
from paillier_tpu.zk import ddleq as jzd
from paillier_tpu_torch.bigint import host, rns2
from paillier_tpu_torch.bigint import mont_kernel as mk
from paillier_tpu_torch.bigint import montgomery as tmont
from paillier_tpu_torch.bigint.engine import LimbEngine, product_tree
from paillier_tpu_torch.core import decrypt as tdec
from paillier_tpu_torch.core.keys import decode_batch, encode_batch
from paillier_tpu_torch.ops import random as prand
from paillier_tpu_torch.threshold import decrypt as ttdec
from paillier_tpu_torch.threshold import keygen as tkg
from paillier_tpu_torch.zk import ddleq as tzd

torch.set_num_threads(2)
CPU = "cpu"
M32 = (1 << 32) - 1
LANES = 32

# two 4096-bit primes = 3 mod 4 (host.random_prime, random.Random(81920)):
# an 8192-bit key without the ~20 s prime search
P4096 = int(
    "e20173fc5ad6e1aa7f33c2a2217b15522fd9d3ddb48416bb4dd71b95d105fc12"
    "60fa807e1c5d8868104287f771cc1e223306d8e950c206541488ed825475dada"
    "1716eafebe616988feed076963f6128c7b77dc7aebfdffe156ce76fafcb261a3"
    "a4926367e7b4edc0c66f420a0862f9557a4f94eb64b17a8d01c0a4419f6a1930"
    "01ebaec00b409c062e6bb80c32757442e021fffb3bd1ca5d11be38f32b2c61f2"
    "0018097433897730604c0e1fdac7b99ec62fd2dacb34c3fba077826508a13449"
    "cf286a0e055ec91aee9d50075552b8882eebb9ab127f16db53133f204f1f24a2"
    "a54146becac3c5ce8fb15c40759fbabd6582f6ee6da64104ed3bbc7b2f82b6bc"
    "5882f79f8f6b7a69d1efca349d44f997ee84c0d5f09772656981b341f646fa8d"
    "19faac227de84a5e41885ba76bca73bd5b237f4d6a54c9f65969a3ac905bacd4"
    "7d19cff5b508a20fe6eb956c181a26b16e0aea1309792c42ee8145bded2a60c4"
    "5c981df527e13245164a257033bf27b48548bc027833742e369b4c32e7bb6ade"
    "e71d6389bf80f9b1c1538fd71004c7cb134ff544973d6d3243736fc590b6e940"
    "f2b173441cd054a5511eda89c5f672fccb5b249a610be24559aef7a9a8a8a425"
    "4875fc97232de2386fc4aca0562e703b54791058354f09c3ce9d090c435abe4b"
    "d1fd6ed453de9ca65d907b095d1ba4da63f4c29b393fe8092ee93dee79129bbf", 16)
Q4096 = int(
    "d3a01996bb150bedb28f2bc3fafbde5aac7f0e0a1b6ce2b4fc644c72f425cfec"
    "1b2df839970f0c7b5defe73e1417f091f773266f4494fdb9ac3e363d597100a5"
    "ae0ba13053098ea791de5e97cf63a5cfbf0037439f18c18fa3ddec6e9509c9a5"
    "9446935f4aa2d02d9feb7805df7cefbdb50237f5981c8a11896d98f754545c57"
    "0745f580c3dc548594b215d107e994a08d1b9d9396cf7049f8f4b4eea0caf9d2"
    "358997391d544d77dee7eebeb0040a35ecc767357c1599c4bffbab9640668fe1"
    "c9c8425512985ca0f5f49f303cde577d1801bc6e37d234ab10400859a4fadac3"
    "eece93766a2b796325432d2a9440ec90f68c292b5c9581b73f6d9fbef07e25dd"
    "a2d3c03ce819f491acbf5e32c6a31c50e27945282b833c7783ec0ac7f544661b"
    "0e00f11a50bc31de0eac8f974565824ee1a2e790e525fd7f88c18204c4722434"
    "17d6533baf559ee4e4d4296b30cc64e1bd426ca0b144cddf0b92b07784a45329"
    "774e1b8953c9336a523f8699884d5a81a9b3d260ece6094238e6a2efc0a38d74"
    "3261e3190b221aace912880a339a834e530b085ed2e337ca958e4f9409a3a197"
    "e4e6b8e52e0151377a51b772f82423557d23bd6ac661b7c856a69ab33d33a04c"
    "e28d79b098f0f1a87d3141b9e7e5336da5034da4608cece9104b6560c462546e"
    "4baf7f8de4356252de4865b73078dfd5db4c25f599137a3d15934c6dbcccf0bb", 16)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _limbs(vals, width):
    return encode_batch(vals, width, device=CPU)


# ---------------------------------------------------------------------------
# B4w's launch rules
# ---------------------------------------------------------------------------

def test_b4w_variant_and_padded_words():
    """A CUDA call of mont_pow_b4 launches B4w past 768 limbs (n^3 of a
    4096-bit key) whatever the batch, and below them from 256 limbs on
    where the batch has at most two rows an SM; B4 elsewhere (a batch
    that fills the card: rows None).  B4w pads a row to a multiple of
    32 words."""
    assert mk.REGISTER_MAX_LIMBS == 768
    assert [mk.variant(L) for L in (16, 512, 768, 769, 1024, 1536, 10 ** 5)
            ] == ["B4"] * 3 + ["B4w"] * 4
    v = mk.variant
    assert [v(L, 5, 132) for L in (128, 255, 256, 512, 768, 769)] == [
        "B4", "B4", "B4w", "B4w", "B4w", "B4w"]
    assert [v(768, rows, 132) for rows in (64, 264, 265, 4096)] == [
        "B4w", "B4w", "B4", "B4"]
    assert [v(128, rows, 132) for rows in (1, 64, 4096)] == ["B4"] * 3
    assert [v(1024, rows, 132) for rows in (1, 4096, 10 ** 6)] == ["B4w"] * 3
    assert [mk.wide_words(L) for L in (769, 1024, 1100, 1536, 1537)] == [
        416, 512, 576, 768, 800]


def test_b4w_shared_memory_rows_and_global_table():
    """A row's block holds in shared memory its operands, product and
    column words (14 nw + 224 words), the 2^w-entry table (mode 0) and
    the segment flags; the table moves to global memory past 1,888 words
    at window 4 (60,416-bit moduli, mode 1) and the rest past 4,064
    (mode 2, one block a row).  The launch shape: the most cluster
    blocks the card holds at once (from 768 words of a row on), and
    the warps that give each thread one column pair."""
    ops = 14 * 512 + 224
    seg = 3 * (512 // 16 + 8)
    assert mk.wide_row_bytes(512, 4, 0) == 4 * (ops + 16 * 512 + seg)
    assert mk.wide_row_bytes(512, 4, 1) == 4 * (ops + seg)
    assert mk.wide_row_bytes(512, 4, 2) == 4 * seg
    assert mk.wide_scratch_words(512, 4, 1) == 16 * 512
    assert mk.wide_scratch_words(512, 4, 2) == ops + 16 * 512
    modes = {(nw, w): mk.wide_mode(nw, w) for nw, w in (
        (416, 4), (768, 4), (1888, 4), (1920, 4), (2912, 4), (4064, 4),
        (4096, 4), (192, 8), (224, 8), (4064, 1), (4096, 1))}
    assert modes == {(416, 4): 0, (768, 4): 0, (1888, 4): 0, (1920, 4): 1,
                     (2912, 4): 1, (4064, 4): 1, (4096, 4): 2, (192, 8): 0,
                     (224, 8): 1, (4064, 1): 1, (4096, 1): 2}
    assert mk.wide_row_bytes(1888, 4, 0) <= mk.SMEM_MAX < \
        mk.wide_row_bytes(1920, 4, 0)
    shape = mk.wide_shape
    for nw, rows in ((512, 64), (768, 16), (576, 16), (2912, 2), (128, 5),
                     (384, 1024), (14560, 1)):
        warps, cluster = shape(nw, rows, 132)
        assert cluster in mk.WIDE_CLUSTERS
        assert 1 <= warps <= mk.WIDE_MAX_WARPS
        assert rows * cluster <= 132 or cluster == 1
        assert 32 * warps * cluster >= min(nw, 32 * mk.WIDE_MAX_WARPS)
        if mk.wide_mode(nw, 4) == 2 or nw < mk.WIDE_CLUSTER_FROM:
            assert cluster == 1
    assert [shape(768, rows, 132) for rows in (16, 64, 1024)] == [
        (8, 4), (12, 2), (24, 1)]
    assert [shape(nw, 64, 132) for nw in (128, 384, 512)] == [
        (8, 1), (12, 1), (16, 1)]
    assert shape(2912, 2, 132) == (12, 8)
    assert shape(14560, 1, 132) == (32, 1)


def test_b4w_hensel_nprime_and_padded_context():
    """B4w's n' = -n^-1 mod 2^(32 nw) for the padded R, lifted from the
    context's -n^-1 mod 2^(16 L) (x (2 + n x) doubles the bits that
    hold), equals pow's inverse; the padded context (n with zero limbs,
    R^2 mod n for the padded R) too, shared and per row."""
    rng = random.Random(0x4E5)
    for bits, target in ((16, 32), (16 * 769, 32 * 416),
                         (16 * 1100, 32 * 576), (64, 4096)):
        n = rng.getrandbits(bits) | 1 | 1 << (bits - 1)
        x = (-pow(n, -1, 1 << bits)) % (1 << bits)
        assert mk.hensel_nprime(n, x, bits, target) == \
            (-pow(n, -1, 1 << target)) % (1 << target)
    moduli = [rng.getrandbits(16 * 37) | 1 | 1 << (16 * 37 - 1)
              for _ in range(3)]
    nw = mk.wide_words(37)
    R = 1 << (32 * nw)
    for ctx, mods in ((tmont.make_mont_ctx(moduli[0], device=CPU),
                       moduli[:1]),
                      (tmont.stack_mont_ctx(moduli, 37, device=CPU), moduli)):
        n, nprime, r2 = (host.limbs_to_ints(f.reshape(-1, 2 * nw).numpy()
                                            .astype(np.uint32))
                         for f in mk._wide_ctx(ctx, nw))
        assert n == mods
        assert nprime == [(-pow(m, -1, R)) % R for m in mods]
        assert r2 == [R * R % m for m in mods]


# ---------------------------------------------------------------------------
# B4w's arithmetic, thread by thread, on its shared-memory layout
# ---------------------------------------------------------------------------

PAD = mk.WIDE_PAD


class _B4wRow:
    """limb_modexp_wide.cu's arithmetic on one row, thread by thread: the
    row's G = 32 w c threads (c blocks of a cluster, each with its own
    copy of every shared array, and global arrays that all see).  The
    phases between two barriers run one after the other, and every write
    of a phase lands at the barrier that closes it, so a value passed
    between threads without a barrier between would read stale and show
    as a wrong result.  product() (the column pairs, one at a time, and
    the chunk of each warp's switch), normalise() (the segments'
    ballots, warp 0's resolve in each block, the final words), cond_sub()
    and mont_mul()
    follow the kernel line by line; the kernel's bounds (three-word
    sums, indices within the operand, a word's 0/1 carry) are
    asserted."""

    def __init__(self, nw, warps, cluster):
        assert nw % LANES == 0
        self.nw, self.T, self.c = nw, LANES * warps, cluster
        self.G = self.T * cluster
        self.blocks = [{} for _ in range(cluster)]
        self.glob = {}
        self.pending = []
        ns = nw // 16 + 8
        for name, size in (("n", nw), ("np", nw), ("acc", nw), ("x", nw),
                           ("y", nw), ("m", nw), ("t", 2 * nw + 32),
                           ("sg", ns), ("sp", ns), ("sc", ns)):
            self.alloc(name, size)
        for name in ("c0", "c1", "c2"):   # positions -PAD .. 2 nw + PAD
            self.alloc(name, 2 * nw + 2 * PAD)

    def alloc(self, name, size, glob=False):
        if glob:
            self.glob[name] = [0] * size
        else:
            for blk in self.blocks:
                blk[name] = [0] * size

    @staticmethod
    def _at(ref, i):
        """an operand (a name, or (name, offset): a table entry) and its
        word i -> (array, index)"""
        name, off = (ref, 0) if isinstance(ref, str) else ref
        return name, i + off + (PAD if name in ("c0", "c1", "c2") else 0)

    def get(self, rank, ref, i):
        name, j = self._at(ref, i)
        if name in self.glob:
            return self.glob[name][j]
        return self.blocks[rank][name][j]

    def put_all(self, ref, i, v):
        """put_all: every block's copy (or the global array, once)"""
        assert 0 <= v <= M32
        self.pending.append((None, *self._at(ref, i), v))

    def put_local(self, rank, ref, i, v):
        assert 0 <= v <= M32
        self.pending.append((rank, *self._at(ref, i), v))

    def sync(self):
        for rank, name, i, v in self.pending:
            if name in self.glob:
                self.glob[name][i] = v
            for r, blk in enumerate(self.blocks):
                if name in blk and (rank is None or rank == r):
                    blk[name][i] = v
        self.pending = []

    def threads(self):
        for g in range(self.G):
            yield g, g // self.T, g % LANES, (g % self.T) // LANES

    def store(self, name, v, width=None):
        for i in range(width or self.nw):
            self.put_all(name, i, (v >> (32 * i)) & M32)
        self.sync()

    def load(self, name, rank=0, width=None):
        return sum(self.get(rank, name, i) << (32 * i)
                   for i in range(width or self.nw))

    # -- the kernel's functions ---------------------------------------
    def product(self, a, b, init, low):
        nw, G = self.nw, self.G
        for g, rank, lane, _ in self.threads():
            A = lambda i: self.get(rank, a, i)  # noqa: E731

            def B(i):
                assert 0 <= i < nw
                return self.get(rank, b, i)

            for k0 in range(g - lane, nw, G):        # one pair at a time
                k = k0 + lane
                acc = self.get(rank, init, k) if init else 0
                lo = None
                for q in range(k0 // LANES + 1 if low else nw // LANES):
                    i0 = q * LANES
                    for u in range(LANES):
                        if i0 != k0:
                            off = nw if i0 > k0 else 0
                        else:                         # the switch chunk
                            off = nw if u > lane else 0
                        acc += A(i0 + u) * B(k - i0 - u + off)
                        if i0 == k0 and u == lane:
                            lo = acc
                            acc = (self.get(rank, init, k + nw) if init
                                   else 0)
                pairs = [(k, lo)] + ([] if low else [(k + nw, acc)])
                for pos, v in pairs:
                    assert v < 1 << 96
                    for w, name in enumerate(("c0", "c1", "c2")):
                        self.put_all(name, pos, (v >> (32 * w)) & M32)

    def resolve(self, ns):
        for rank in range(self.c):
            carry = 0
            for b0 in range(0, ns, LANES):
                gs, ps = [], []
                for lane in range(LANES):
                    j = b0 + lane
                    gm = self.get(rank, "sg", j) if j < ns else 0
                    pm = self.get(rank, "sp", j) if j < ns else 0
                    gs.append(((gm | pm) + gm) >> 32 & 1)
                    ps.append(pm == M32)
                cin, _ = _lookahead(gs, ps, carry)
                for lane in range(LANES):
                    if b0 + lane < ns:
                        self.put_local(rank, "sc", b0 + lane, cin[lane])
                # out of segment ns - 1: the carry into the next bit
                G, P = _ballot(gs), _ballot(ps)
                c = ((G | P) + G + carry) ^ (G | P) ^ G
                carry = c >> min(LANES, ns - b0) & 1
            self.put_local(rank, "sc", ns, carry)
        self.sync()                                   # __syncthreads

    def seg_bit(self, rank, s, lane):
        gm, pm = self.get(rank, "sg", s), self.get(rank, "sp", s)
        c = ((gm | pm) + gm + self.get(rank, "sc", s)) ^ (gm | pm) ^ gm
        return c >> lane & 1

    def warps(self, P):
        """(rank, warp base position) of every warp's 32-position segment
        of 0 .. P - 1: position p is thread p mod G's"""
        for rank in range(self.c):
            for w in range(self.T // LANES):
                wb = rank * self.T + w * LANES
                for pb in range(wb, P, self.G):
                    yield rank, pb

    def normalise(self, P, out, keep):
        for rank, pb in self.warps(P):
            c = lambda name, p: self.get(rank, name, p)  # noqa: E731
            gen, prop = [], []
            for lane in range(LANES):
                p = pb + lane
                if p >= P:
                    gen.append(0)
                    prop.append(0)
                    continue
                xp = c("c0", p) + c("c1", p - 1) + c("c2", p - 2)
                xq = c("c0", p - 1) + c("c1", p - 2) + c("c2", p - 3)
                y = (xp & M32) + (xq >> 32)
                assert y < (1 << 32) + 3
                gen.append(y >> 32 != 0)
                prop.append(y & M32 == M32)
                self.put_local(rank, out, p, y & M32)
            self.put_all("sg", pb // LANES, _ballot(gen))
            self.put_all("sp", pb // LANES, _ballot(prop))
        self.sync()
        self.resolve(-(-P // LANES))
        for rank, pb in self.warps(P):
            for lane in range(LANES):
                p = pb + lane
                if keep <= p < P:
                    w = self.get(rank, out, p) + self.seg_bit(
                        rank, pb // LANES, lane)
                    self.put_all(out, p, w & M32)
        self.sync()

    def cond_sub(self, out, out2):
        nw = self.nw
        for rank, pb in self.warps(nw):
            u = [self.get(rank, "t", nw + pb + lane) for lane in range(LANES)]
            v = [self.get(rank, "n", pb + lane) for lane in range(LANES)]
            self.put_all("sg", pb // LANES, _ballot(
                [x < y for x, y in zip(u, v)]))
            self.put_all("sp", pb // LANES, _ballot(
                [x == y for x, y in zip(u, v)]))
        self.sync()
        ns = nw // LANES
        self.resolve(ns)
        for rank, pb in self.warps(nw):
            sub = (self.get(rank, "t", 2 * nw) != 0
                   or self.get(rank, "sc", ns) == 0)
            for lane in range(LANES):
                p = pb + lane
                u = self.get(rank, "t", nw + p)
                w = ((u - self.get(rank, "n", p) - self.seg_bit(
                    rank, pb // LANES, lane)) % (1 << 32) if sub else u)
                self.put_all(out, p, w)
                if out2 is not None:
                    self.put_all(out2, p, w)   # shared: all; global: once
        self.sync()

    def mont_mul(self, a, b, out, out2=None):
        nw = self.nw
        for pas in range(3):
            pa = (a, "t", "m")[pas]
            pb = (b, "np", "n")[pas]
            self.product(pa, pb, "t" if pas == 2 else None, pas == 1)
            self.sync()
            self.normalise(nw if pas == 1 else 2 * nw + 1,
                           "m" if pas == 1 else "t", nw if pas == 2 else 0)
        self.cond_sub(out, out2)


def _ballot(bits):
    return sum(1 << i for i, b in enumerate(bits) if b)


def _lookahead(gen, prop, cin=0):
    """Carries into each of 32 positions, and out of the last, from the
    positions' generate / propagate bits (never both) and a carry-in:
    the kernel's ((G | P) + G + cin) ^ (G | P) ^ G."""
    G, P = _ballot(gen), _ballot(prop)
    c = ((G | P) + G + cin) ^ (G | P) ^ G
    return [(c >> i) & 1 for i in range(LANES)], (c >> LANES) & 1


def _row(nw, warps, cluster, n):
    row = _B4wRow(nw, warps, cluster)
    R = 1 << (32 * nw)
    row.store("n", n)
    row.store("np", (-pow(n, -1, R)) % R)
    return row


_JAX_MONT = {}


def _jax_mont_mul(a, b, n, nw):
    """pallas_kernels._mont_mul at R = 2^(32 nw) (2 nw 16-bit limbs), on
    rows of (a, b): the TPU kernel's product."""
    from paillier_tpu.bigint import pallas_kernels as jpk
    L = 2 * nw
    fn = _JAX_MONT.setdefault(L, jax.jit(jpk._mont_mul))
    R = 1 << (16 * L)

    def lj(vals):
        return jnp.asarray(host.ints_to_limbs(vals, L).astype(np.uint32))

    out = fn(lj(a), lj(b), lj([n] * len(a)),
             lj([(-pow(n, -1, R)) % R] * len(a)))
    return host.limbs_to_ints(np.asarray(out))


@pytest.mark.parametrize("nw,warps,cluster", [
    (64, 1, 1), (64, 2, 1), (96, 2, 1), (96, 4, 1), (160, 4, 1),
    (96, 1, 2), (128, 1, 4), (64, 2, 2)])
def test_b4w_block_arithmetic(nw, warps, cluster):
    """B4w's Montgomery product (products A, B, C, normalisation, the
    conditional subtract) emulated thread by thread at 1, 2 and 4 warps,
    at nw = 96 and 160, which 64 and 128 threads do not divide (a thread
    takes 1 to 3 column pairs, a warp's last pair may be past nw and is
    not formed), on clusters of 2 and 4 blocks (each block's slice of the
    columns written into every block's copy): a b R^-1 mod n for random
    operands, a
    = R - 1, n - 1, 0, the aliasing of out with a (and with a and b: a
    squaring), on moduli just below R and a random one; equal to Python
    integers, to the JAX package's pallas_kernels._mont_mul at the same
    R (nw 64 and 96), and every block ends with the same words."""
    R = 1 << (32 * nw)
    rng = random.Random(nw * 100 + warps * 10 + cluster)
    moduli = [rng.getrandbits(32 * nw) | 1 | 1 << (32 * nw - 1), R - 1,
              R - 3, R - (1 << (16 * nw)) + 1]
    cases, got = [], []
    for n in moduli:
        row = _row(nw, warps, cluster, n)
        rinv = pow(R, -1, n)
        for a, b in [(rng.randrange(n), rng.randrange(n)), (n - 1, n - 1),
                     (R - 1, n - 1), (R - 1, rng.randrange(n)), (0, n - 1)]:
            row.store("acc", a)
            row.store("x", b)
            row.mont_mul("acc", "x", "acc")               # out aliases a
            want = a * b * rinv % n
            assert [row.load("acc", r) for r in range(cluster)] == \
                [want] * cluster, (n, a, b)
            cases.append((a, b, n))
            got.append(want)
        v = rng.randrange(n)
        row.store("acc", v)
        row.mont_mul("acc", "acc", "acc")                  # a squaring
        assert row.load("acc", cluster - 1) == v * v * rinv % n
    if nw <= 96 and (warps, cluster) in ((1, 1), (2, 1)):
        for n in moduli:
            sel = [(a, b) for a, b, m in cases if m == n]
            want = [g for (a, b, m), g in zip(cases, got) if m == n]
            assert _jax_mont_mul([a for a, _ in sel], [b for _, b in sel],
                                 n, nw) == want


@pytest.mark.parametrize("warps,cluster", [(1, 1), (2, 2)])
def test_b4w_block_lookahead(warps, cluster):
    """The normalisation's carries: column sums whose words run all-ones
    across whole segments, warps and blocks, with a carry generated at
    the bottom (it must ripple through 120 positions), a 3-word column
    at every position, and random ones; the 0/1 carries by segment
    ballots, warp 0's segment resolution and each lane's carry-in equal
    Python's sums, at P = 2 nw + 1 (into t) and mod R (P = nw, into m)."""
    nw = 64
    rng = random.Random(warps + cluster)
    row = _B4wRow(nw, warps, cluster)
    patterns = [
        [(M32, 0, 0)] * (2 * nw - 1) + [(2, 0, 0)],          # no carry
        [(M32, 0, 0)] * 120 + [(0, 0, 0)] * (2 * nw - 120),
        [(M32, M32, nw)] * (2 * nw - 3) + [(0, 0, 0)] * 3,
        [(rng.getrandbits(32), rng.getrandbits(32), rng.randrange(nw))
         for _ in range(2 * nw - 3)] + [(0, 0, 0)] * 3]
    patterns[1][0] = (M32, 1, 0)            # 2^32 + (2^32 - 1): a carry
    for cols in patterns:
        value = sum((x + (y << 32) + (z << 64)) << (32 * p)
                    for p, (x, y, z) in enumerate(cols))
        for p, vals in enumerate(cols):
            for name, v in zip(("c0", "c1", "c2"), vals):
                row.put_all(name, p, v)
        row.sync()
        for P, out, want in ((2 * nw + 1, "t", value),
                             (nw, "m", value % (1 << (32 * nw)))):
            row.normalise(P, out, 0)
            for r in range(cluster):
                assert row.load(out, r, P) == want


@pytest.mark.parametrize("mode", [0, 1])
def test_b4w_block_ladder(mode):
    """The kernel's whole ladder at window 2, emulated: bm = base R^2 R^-1
    and 1_M (in mode 0 into the table in shared memory; in mode 1 into y
    and acc with the table's copy in global memory, written by each
    word's owner), the table built (mode 1: in x from y), per digit two
    squarings and the table entry times acc (mode 1: the entry staged
    from global memory into y), the exit by 1; on a padded modulus (R^2
    and n' for the padded R, as the wrapper gives them), at 2 warps and a
    cluster of 2: equal to pow and to the plain ladder."""
    nw, window = 64, 2
    TT = 1 << window
    rng = random.Random(0xB4 + mode)
    n = rng.getrandbits(32 * nw - 40) | 1 | 1 << (32 * nw - 41)
    R = 1 << (32 * nw)
    row = _row(nw, 2, 2, n)
    row.alloc("tab", TT * nw, glob=mode == 1)
    x, e = rng.randrange(n), rng.getrandbits(14) | 1 << 13
    digits = tmont.exp_digits(e, window, 7)
    row.store("acc", x)
    row.store("x", R * R % n)
    mm = row.mont_mul

    def entry(v):
        return ("tab", v * nw)

    if mode == 0:
        mm("acc", "x", entry(1))
        row.store("acc", 1)
        mm("acc", "x", "acc", entry(0))
        for v in range(2, TT):
            mm(entry(v - 1), entry(1), entry(v))
    else:
        mm("acc", "x", "y", entry(1))
        row.store("acc", 1)
        mm("acc", "x", "acc", entry(0))
        for v in range(2, TT):
            mm("y" if v == 2 else "x", "y", "x", entry(v))
    assert [row.get(1, "tab", i) for i in range(nw)] == [
        (R % n) >> (32 * i) & M32 for i in range(nw)]
    for d in digits:
        for _ in range(window):
            mm("acc", "acc", "acc")
        if mode == 0:
            mm(entry(int(d)), "acc", "acc")
        else:
            for i in range(nw):                  # the cp.async staging
                row.put_all("y", i, row.get(0, entry(int(d)), i))
            row.sync()
            mm("y", "acc", "acc")
    row.store("x", 1)
    mm("acc", "x", "acc")
    assert row.load("acc", 1) == pow(x, e, n)
    ctx = tmont.make_mont_ctx(n, device=CPU)
    got = tmont.mont_pow_digits_plain(
        ctx, _limbs([x], ctx.n_limbs), digits, window)
    assert decode_batch(got) == [pow(x, e, n)]


# ---------------------------------------------------------------------------
# Threshold decryption's limb branches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[64, 128])
def thr(request):
    """A (5, 3) threshold key of the port, the same key in the JAX
    package, ciphertexts of the port's Encryptor, servers {1, 3, 5}
    (negative Lagrange weights), and the results of the port's RNS
    branches (n^2 within the RNS engine) and, at 64 bits, of the JAX
    package (``partial_decrypt_all`` and ``combine``, its limb branches
    on the CPU; None at 128 bits)."""
    bits = request.param
    keys = tkg.ThresholdKeyGenerator(bits, 5, 3, random.Random(bits),
                                     device=CPU).generate()
    tpk = keys[0].public()
    rng = random.Random(bits + 1)
    ms = [rng.randrange(tpk.n) for _ in range(4)] + [0]
    ct = pt.Encryptor(tpk, rng=rng, device=CPU).encrypt(ms)
    servers = [keys[0], keys[2], keys[4]]
    rns_parts = ttdec.partial_decrypt_all(servers, ct)
    assert isinstance(tpk.device(CPU).engine(1), rns2.Rns2Engine)
    fields = {f: getattr(keys[0], f) for f in (
        "n", "g", "h", "k", "bits", "l", "t", "v", "vi")}
    jservers = [jtkeys.ThresholdSecretKey(**fields, id=k.id, share=k.share)
                for k in servers]
    jparts = jms = None
    if bits == 64:
        jct = jkeys.Ciphertext(c=jnp.asarray(_u32(ct.c)))
        jparts = jtdec.partial_decrypt_all(jservers, jct)
        jms = jtdec.combine(jservers[0].public(), jparts)
    return dict(bits=bits, tpk=tpk, ms=ms, ct=ct, servers=servers,
                rns_parts=rns_parts, jparts=jparts, jms=jms,
                rns_ms=ttdec.combine(tpk, rns_parts))


def test_threshold_limb_branches(thr, monkeypatch):
    """With the RNS engine's limit below n^2, fresh copies of the keys
    take the limb engine of n^2: partial_decrypt_all runs one
    shared-exponent limb ladder a server and combine its limb trees.  The
    partial decryptions equal the RNS engine's limbs (and the JAX
    package's at 64 bits), the plaintexts equal the RNS engine's, the
    messages (and the JAX package's); the limb trees' positive / negative
    products equal the residue trees'; an odd count of rows pads the
    limb tree with the limbs of 1."""
    tpk, ct = thr["tpk"], thr["ct"]
    L = tpk.device(CPU).L
    stacked = torch.stack([p.c for p in thr["rns_parts"]])
    exps = [abs(2 * ttdec.compute_lambda(tpk, s.id, [1, 3, 5]))
            for s in thr["servers"]]
    sel = torch.tensor([ttdec.compute_lambda(tpk, s.id, [1, 3, 5]) > 0
                        for s in thr["servers"]])[:, None, None]
    powed = ttdec.lagrange_powers(tpk, stacked, exps)
    rns_prod = ttdec._combine_products(tpk.device(CPU), powed, sel)
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", thr["bits"])
    ltpk = dataclasses.replace(tpk)
    servers = [dataclasses.replace(k) for k in thr["servers"]]
    dk = ltpk.device(CPU)
    eng = dk.engine(1)
    assert isinstance(eng, LimbEngine)
    parts = ttdec.partial_decrypt_all(servers, ct)
    assert isinstance(servers[0].device(CPU).engine(1), LimbEngine)
    for got, rp in zip(parts, thr["rns_parts"]):
        assert got.id == rp.id and got.c.shape[-1] == 2 * L
        assert torch.equal(got.c, rp.c)
    ms = ttdec.combine(ltpk, parts)
    assert ms == thr["rns_ms"] == thr["ms"]
    if thr["jparts"] is not None:
        for got, jp in zip(parts, thr["jparts"]):
            assert got.id == jp.id
            assert np.array_equal(_u32(got.c), np.asarray(jp.c))
        assert ms == thr["jms"]
    limb_prod = ttdec._combine_products(dk, powed, sel)
    for got, want in zip(limb_prod, rns_prod):
        assert torch.equal(got, want)
    three = product_tree(eng.mul, powed, eng.one)
    n2 = tpk.n2
    want = [a * b * c % n2 for a, b, c in zip(
        *(decode_batch(powed[i]) for i in range(3)))]
    assert decode_batch(three) == want


# ---------------------------------------------------------------------------
# The limb CRT decryption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [256, 512])
def test_limb_crt_decrypt_vs_jax(bits, monkeypatch):
    """With the RNS engine's limit below p^2, Decryptor(crt=True) takes
    the limb engine for its halves (one limb ladder mod p^2 and one mod
    q^2) and gives the limbs of its halves on the RNS engine (built
    before the limit was lowered) and, at 256 bits, of the JAX package's
    crt_decrypt_kernel (its Decryptor with crt=True on the limb
    engine)."""
    sk, pk = pt.keygen(bits, random.Random(bits + 7), device=CPU)
    rng = random.Random(bits)
    ms = [rng.randrange(pk.n) for _ in range(4)] + [0, pk.n - 1]
    ct = pt.Encryptor(pk, rng=rng, device=CPU).encrypt(ms)
    mm = tdec.Decryptor(sk, crt=True, device=CPU).decrypt_array(ct)
    calls = []
    ladder = LimbEngine.pow_shared

    def counted(eng, x, e, **kw):
        calls.append((eng.L, e))
        return ladder(eng, x, e, **kw)

    monkeypatch.setattr(LimbEngine, "pow_shared", counted)
    monkeypatch.setattr(rns2, "MAX_MODULUS_BITS", bits - 8)
    dec = tdec.Decryptor(sk, crt=True, device=CPU)
    got = dec.decrypt_array(ct)
    assert calls == [(bits // 16, sk.p - 1), (bits // 16, sk.q - 1)]
    assert torch.equal(got, mm)
    assert dec.decrypt(ct) == ms
    if bits == 256:
        jsk = jkeys.SecretKey(n=sk.n, g=sk.g, h=sk.h, k=sk.k, bits=sk.bits,
                              lam=sk.lam, p=sk.p, q=sk.q)
        want = jdec.Decryptor(jsk, 1, crt=True, engine="limb")._fn(
            jnp.asarray(_u32(ct.c)))
        assert np.array_equal(_u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# DDLEQ's CRT halves past the RNS engine
# ---------------------------------------------------------------------------

def test_ddleq_crt_plans_past_5774_bits_raise_in_both():
    """A 5,776-bit key's p^3 (8,664 bits) is past the RNS engine's 8,661:
    the prover's CRT plans raise in both packages (the port in
    ``crt_plans``'s guard), before any ladder runs (use_crt=False, the
    full-width path, is what takes such a key)."""
    rng = random.Random(5776)
    p, q = (rng.getrandbits(2888) | 3 << 2886 | 1 for _ in range(2))
    n = p * q
    assert n.bit_length() == 5776 and (p ** 3).bit_length() > \
        rns2.MAX_MODULUS_BITS
    sk = pt.SecretKey(n=n, g=n + 1, h=2, k=1, bits=5776,
                      lam=(p - 1) * (q - 1), p=p, q=q)
    msg = "not enough sub-14-bit primes"
    with pytest.raises(ValueError, match=msg):
        tzd.crt_plans(sk, CPU)
    jsk = jkeys.SecretKey(n=n, g=n + 1, h=2, k=1, bits=5776,
                          lam=(p - 1) * (q - 1), p=p, q=q)
    with pytest.raises(ValueError, match=msg):
        jzd._CrtN3Plans(jsk, host.limbs_for_bits(5776))


# ---------------------------------------------------------------------------
# An 8192-bit key at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def key8192():
    n = P4096 * Q4096
    sk = pt.SecretKey(n=n, g=n + 1, h=prand.random_qr_generator(
        n, random.Random(8192)), k=1 << 4096, bits=8192,
        lam=(P4096 - 1) * (Q4096 - 1), p=P4096, q=Q4096)
    return sk


def test_8192_bit_key_builds_at_both_levels(key8192):
    """Both levels of an 8192-bit key are past the RNS engine (n^2: 1,024
    limbs, n^3: 1,536, both B4w on the card): the Encryptor and the
    Decryptor build at levels 1 and 2, and Decryptor(crt=True) at level
    1 with its p^2 / q^2 halves (8,192 bits) on the RNS engine at
    k = 704.  No RNS engine of n^2 or n^3 is built, and the RNS engine
    itself refuses both moduli."""
    sk = key8192
    pk = sk.public()
    dk = pk.device(CPU)
    assert [mk.variant(dk.limbs_for_level(lv)) for lv in (1, 2)] == [
        "B4w", "B4w"]
    for level in (1, 2):
        assert pt.Encryptor(pk, level, device=CPU).dk is dk
        assert pt.Decryptor(sk, level, device=CPU).level == level
    dec = pt.Decryptor(sk, 1, crt=True, device=CPU)
    assert dec.crt
    for d in (dk, sk.device(CPU)):
        assert sorted(d._engines) == [1, 2]
        assert all(isinstance(e, LimbEngine) for e in d._engines.values())
    for level in (1, 2):
        with pytest.raises(ValueError, match="not enough sub-14-bit primes"):
            rns2.Rns2Engine(pk.modulus_for_level(level), device=CPU)


def test_8192_bit_level2_ladder_at_full_width(key8192):
    """DeviceKey.pow at level 2 of the 8192-bit key: the limb ladder at
    L = 1,536 (B4w's width on the card; the plain ladder here) on one row
    over 4 digits equals pow."""
    pk = key8192.public()
    dk = pk.device(CPU)
    rng = random.Random(1536)
    x = rng.randrange(pk.n3)
    e = rng.getrandbits(16) | 1 << 15
    got = dk.pow(2, _limbs([x], 1536), tmont.exp_digits(e, 4, 4))
    assert dk.engine(2).L == 1536
    assert decode_batch(got) == [pow(x, e, pk.n3)]
