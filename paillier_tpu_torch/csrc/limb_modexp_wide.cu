// Kernel B4w: the limb-domain Montgomery fixed-window ladder of kernel B4
// (csrc/limb_modexp.cu) with a thread block, or a cluster of blocks, per
// row, running the TPU kernel's three-product Montgomery multiply.
//
// Replaces paillier_tpu/bigint/pallas_kernels.py:155 (_modexp_kernel, the
// Pallas TPU kernel behind mont_pow_pallas) wherever the launch rule
// (mont_kernel.variant) prefers it to B4: past B4's 768 limbs always, and
// below them where a few wide rows would leave B4 latency bound.  The
// contract is B4's: for every row b of a batch, the canonical
// base_b^e_b mod n_b, with e given as MSB-first base-2^w digits, one
// string for the batch ([D]) or one per row ([B, D]), and n one modulus
// for the batch or one per row.  The ladder is
// montgomery.mont_pow_digits_plain's, multiply for multiply:
//   bm = base * R^2 * R^-1; table = [1_M, bm, bm^2, .., bm^(2^w - 1)];
//   acc = 1_M; per digit d: w squarings, then table[d] * acc, d = 0
//   included; exit: acc * 1.
// Every product is a canonical Montgomery product, so the output equals
// the plain version's (and Python's pow) whatever R is: R = 2^(32 nw)
// with nw a multiple of 32 words, the wrapper padding n with zero words
// and giving R^2 mod n and the full n' = -n^-1 mod R for that R.
//
// The Montgomery product is pallas_kernels.py:_mont_mul's, three products
// free of any word-by-word dependency:
//   A: t = a b                    (2 nw + 1 words)
//   B: m = (t mod R) n' mod R     (nw words)
//   C: u = (t + m n) / R, then one conditional subtract of n.
// Each product is a product-scanning pass.  Thread j of the row's G
// threads (32 w a block, c blocks in a cluster) owns the column pairs
// (k, k + nw) for k = j + G s: column k sums a_i b_(k-i) over i <= k and
// column k + nw sums a_i b_(k-i+nw) over i > k, so every thread sums
// exactly nw terms a pair (the columns of a product, paired so that the
// short low columns go with the short high ones).  A step i reads a_i,
// one word for the whole warp (a broadcast, four steps in one 16-byte
// load), and b_(k-i) at 32 consecutive words, one a bank: no bank
// conflict; a chunk of 32 steps loads its a and b words first and then
// runs its 32 terms.  A thread keeps each column in three words in registers
// (mad.lo.cc / madc.hi.cc / addc, which ptxas makes one IMAD.WIDE.U32
// with a carry-out and half an IADD3.X a term) and takes its column
// pairs one at a time.  The lanes of a warp move from column k to k + nw at
// steps k0 .. k0 + 31 (k0 = k - lane, a multiple of 32): only that chunk
// of 32 steps runs a per-lane switch.  B needs the columns below nw
// alone: a warp stops after its switch (no high sums are formed), so B
// costs about half of A or C.
//
// After each product the column words go to shared memory (each block
// of a cluster writes its columns into every block's copy through
// distributed shared memory) and the row normalises them:
//   x_p = c0_p + c1_(p-1) + c2_(p-2)   (< 3 2^32),
//   y_p = lo(x_p) + hi(x_(p-1))        (< 2^32 + 3: a word and a 0/1 carry),
// then the 0/1 carries by a carry-lookahead: generate and propagate bits
// of each 32-position segment by __ballot_sync, the segments' carries by
// one warp of each block over the segments' flags (which every block
// writes into every block's copy), and each word's carry-in from its
// segment's.  The conditional subtract takes its borrows the same way.
// Each block ends holding the whole normalised result, which the next
// product reads from its own copy.  A Montgomery product thus costs 11
// row barriers (cluster barriers where c > 1, block barriers where
// c = 1) and 4 block barriers, instead of nw dependent word steps.
//
// Where a row's operands, columns and table pass what a block's shared
// memory holds (232,448 B: at window 4 past 1,888 words, a 60,416-bit
// modulus), the table moves to a global scratch tensor [B, 2^w, nw]
// (mode 1): a digit's entry is brought into a shared staging operand by
// cp.async, issued before the digit's squarings so that its latency hides
// behind them.  Past 4,064 words the operands and columns move there too
// (mode 2, one block a row).  The wrapper picks the mode by width, and
// the warps and cluster size by the width, the batch and the SMs
// (mont_kernel.wide_shape), so no width is refused.
//
// What bounds it on an H100: the 2 nw^2 + nw 32x32->64 multiply-adds of a
// Montgomery product on the INT32 pipe (an IMAD.WIDE takes two issues).
// This design does more of them, about 2.5 nw^2 (A and C nw^2 each, B
// about half of that), each one IMAD.WIDE.U32 with a carry-out and half
// an IADD3.X besides its shared-memory load; it gains all the same
// because its products are parallel (a thread's chain is nw terms a pass
// instead of a row's nw dependent word steps with their shuffles and
// broadcasts), a product needs a handful of barriers, and a batch smaller
// than the card takes more SMs a row (a cluster of up to 8 blocks).
// Measured (PERF.md section 6): without the products'
// multiply-adds 4-13 us of a 25-58 us Montgomery product remain
// (normalisation, barriers, cluster stores); knocking out a's broadcast
// or b's loads saves 5-15%, and loading a chunk's words ahead of its
// carry chain 15-23%: the chain of dependent multiply-adds binds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use
constexpr int PAD = 32;              // zero words around a column array

// Words of a row's operands, product and columns (n, n', acc, x, y, m:
// nw each; t: 2 nw + 32; three column arrays of 2 nw positions with PAD
// zero words on each side), and of its segment flags (generate and
// propagate masks and carries of the 32-position segments of a product).
__host__ __device__ constexpr size_t ops_words(int nw) {
  return 14 * (size_t)nw + 32 + 6 * PAD;
}
__host__ __device__ constexpr size_t seg_words(int nw) {
  return 3 * ((size_t)nw / 16 + 8);
}

struct Row {
  int nw;
  int g, G;            // this thread among the row's threads, their count
  int tid, T, lane, warp;
  int csize;           // blocks of the row's cluster
  uint32_t *c0, *c1, *c2;   // column words by position (this block's copy)
  uint32_t *sg, *sp, *sc;   // segment generate / propagate masks, carries
};

__device__ __forceinline__ void row_sync(const Row& r) {
  if (r.csize == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// v into *p (a word of a shared array) in every block of the row's
// cluster; *p alone where the row is one block (or p lies in global
// memory, mode 2)
__device__ __forceinline__ void put_all(const Row& r, uint32_t* p,
                                        uint32_t v) {
  if (r.csize == 1) {
    *p = v;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int k = 0; k < r.csize; ++k) *cl.map_shared_rank(p, k) = v;
}

// (s, h) += a b: a three-word column sum held as its low 64 bits s (a
// register pair, the addend of IMAD.WIDE) and the word above, h
__device__ __forceinline__ void mac(uint64_t& s, uint32_t& h, uint32_t a,
                                    uint32_t b) {
  uint32_t x = (uint32_t)s, y = (uint32_t)(s >> 32);
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(x), "+r"(y), "+r"(h)
      : "r"(a), "r"(b));
  s = ((uint64_t)y << 32) | x;
}

// Column sums of a b (plus init, where given, at every position) for this
// thread's column pairs (k, k + nw), k = g + G s, one pair at a time,
// written as three words to positions k and k + nw of every block's
// column arrays; low: the columns below nw alone (product B).
__device__ __forceinline__ void product(const Row& r, const uint32_t* a,
                                        const uint32_t* b,
                                        const uint32_t* init, bool low) {
  const int nw = r.nw;
  for (int k0 = r.g - r.lane; k0 < nw; k0 += r.G) {   // the warp's first k
    const int k = k0 + r.lane;
    uint64_t s = init ? init[k] : 0u, ls = 0u;
    uint32_t h = 0u, lh = 0u;
    const int qend = low ? k0 / LANES + 1 : nw / LANES;
    for (int q = 0; q < qend; ++q) {
      const int i0 = q * LANES;
      if (i0 != k0) {
        const uint32_t* bp = b + k - i0 + (i0 > k0 ? nw : 0);
        // the chunk's 32 words of b first, then its 32 terms: the loads
        // issue ahead of the carry chain (23% faster than 8 steps at a
        // time, whose loads the compiler left on the chain; PERF.md §6)
        uint32_t av[LANES], bv[LANES];
#pragma unroll
        for (int u = 0; u < LANES; u += 4) {
          const uint4 A = *reinterpret_cast<const uint4*>(a + i0 + u);
          av[u] = A.x;
          av[u + 1] = A.y;
          av[u + 2] = A.z;
          av[u + 3] = A.w;
        }
#pragma unroll
        for (int u = 0; u < LANES; ++u) bv[u] = bp[-u];
#pragma unroll
        for (int u = 0; u < LANES; ++u) mac(s, h, av[u], bv[u]);
      } else {
        // the chunk of the switch: lane l leaves column k after step l
        // (i = k) for column k + nw
#pragma unroll 4
        for (int u = 0; u < LANES; ++u) {
          mac(s, h, a[i0 + u], b[k - i0 - u + (u > r.lane ? nw : 0)]);
          if (u == r.lane) {
            ls = s;
            lh = h;
            s = init ? init[k + nw] : 0u;
            h = 0u;
          }
        }
      }
    }
    put_all(r, r.c0 + k, (uint32_t)ls);
    put_all(r, r.c1 + k, (uint32_t)(ls >> 32));
    put_all(r, r.c2 + k, lh);
    if (!low) {
      put_all(r, r.c0 + k + nw, (uint32_t)s);
      put_all(r, r.c1 + k + nw, (uint32_t)(s >> 32));
      put_all(r, r.c2 + k + nw, h);
    }
  }
}

// Carry (or borrow) into each segment of NS from the flags sg / sp that
// every block holds: warp 0 of each block, 32 segments at a time, into
// sc[0 .. NS - 1], and out of the last into sc[NS].
__device__ __forceinline__ void resolve(const Row& r, int NS) {
  if (r.warp == 0) {
    uint32_t carry = 0;
    for (int b0 = 0; b0 < NS; b0 += LANES) {
      const int j = b0 + r.lane;
      uint32_t Gm = 0, Pm = 0;
      if (j < NS) {
        Gm = r.sg[j];
        Pm = r.sp[j];
      }
      const bool gs = ((((uint64_t)(Gm | Pm) + Gm) >> 32) & 1u) != 0;
      const bool ps = Pm == FULL;
      const uint64_t GG = __ballot_sync(FULL, gs);
      const uint64_t PP = __ballot_sync(FULL, ps);
      const uint64_t c = ((GG | PP) + GG + carry) ^ (GG | PP) ^ GG;
      if (j < NS) r.sc[j] = (uint32_t)(c >> r.lane) & 1u;
      carry = (uint32_t)(c >> min(LANES, NS - b0)) & 1u;   // out of NS - 1
    }
    if (r.lane == 0) r.sc[NS] = carry;
  }
  __syncthreads();
}

// carry into this lane of a segment with masks (Gm, Pm) and carry-in cin
__device__ __forceinline__ uint32_t lane_carry(uint32_t Gm, uint32_t Pm,
                                               uint32_t cin, int lane) {
  const uint64_t c = ((uint64_t)(Gm | Pm) + Gm + cin) ^ (Gm | Pm) ^ Gm;
  return (uint32_t)(c >> lane) & 1u;
}

// The column sums at positions 0 .. P - 1 as words into out (every
// block's copy from position keep on; below it only this block's, as the
// carries' scratch).  Position p belongs to thread p mod G.
__device__ __forceinline__ void normalise(const Row& r, int P,
                                          uint32_t* out, int keep) {
  const int wb = r.g - r.lane;
  for (int pb = wb; pb < P; pb += r.G) {
    const int p = pb + r.lane;
    bool gen = false, prop = false;
    if (p < P) {
      const uint64_t xp =
          (uint64_t)r.c0[p] + r.c1[p - 1] + (uint64_t)r.c2[p - 2];
      const uint64_t xq =
          (uint64_t)r.c0[p - 1] + r.c1[p - 2] + (uint64_t)r.c2[p - 3];
      const uint64_t y = (xp & FULL) + (xq >> 32);
      const uint32_t w = (uint32_t)y;
      gen = (y >> 32) != 0;
      prop = w == FULL;
      out[p] = w;
    }
    const uint32_t Gm = __ballot_sync(FULL, gen);
    const uint32_t Pm = __ballot_sync(FULL, prop);
    if (r.lane == 0) {
      put_all(r, r.sg + pb / LANES, Gm);
      put_all(r, r.sp + pb / LANES, Pm);
    }
  }
  row_sync(r);
  resolve(r, (P + LANES - 1) / LANES);
  for (int pb = wb; pb < P; pb += r.G) {
    const int p = pb + r.lane, s = pb / LANES;
    const uint32_t c = lane_carry(r.sg[s], r.sp[s], r.sc[s], r.lane);
    if (p < P && p >= keep) put_all(r, out + p, out[p] + c);
  }
  row_sync(r);
}

// out = u - n if u >= n else u, for u = t[nw .. 2 nw] (t[2 nw] 0 or 1);
// out in every block's copy, out2 (where given) too: in every block's
// copy where shared, by each word's owner where global.
template <bool SHARED2>
__device__ __forceinline__ void cond_sub(const Row& r, const uint32_t* t,
                                         const uint32_t* n, uint32_t* out,
                                         uint32_t* out2) {
  const int nw = r.nw, wb = r.g - r.lane, NS = nw / LANES;
  for (int pb = wb; pb < nw; pb += r.G) {
    const int p = pb + r.lane;
    const uint32_t u = t[nw + p], v = n[p];
    const uint32_t Gm = __ballot_sync(FULL, u < v);
    const uint32_t Pm = __ballot_sync(FULL, u == v);
    if (r.lane == 0) {
      put_all(r, r.sg + pb / LANES, Gm);
      put_all(r, r.sp + pb / LANES, Pm);
    }
  }
  row_sync(r);
  resolve(r, NS);
  const bool sub = t[2 * nw] != 0 || r.sc[NS] == 0;
  for (int pb = wb; pb < nw; pb += r.G) {
    const int p = pb + r.lane, s = pb / LANES;
    const uint32_t bin = lane_carry(r.sg[s], r.sp[s], r.sc[s], r.lane);
    const uint32_t u = t[nw + p];
    const uint32_t w = sub ? u - n[p] - bin : u;
    put_all(r, out + p, w);
    if (out2) {
      if (SHARED2)
        put_all(r, out2 + p, w);
      else
        out2[p] = w;
    }
  }
  row_sync(r);
}

// out = a b R^-1 mod n, canonical, for a < R and b < n (and out2 = out
// where given); out may alias a or b.
template <bool SHARED2>
__device__ __forceinline__ void mont_mul(const Row& r, const uint32_t* a,
                                         const uint32_t* b, uint32_t* out,
                                         uint32_t* out2, const uint32_t* n,
                                         const uint32_t* np, uint32_t* t,
                                         uint32_t* m) {
  const int nw = r.nw;
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t* pa = pass == 0 ? a : pass == 1 ? t : m;
    const uint32_t* pb = pass == 0 ? b : pass == 1 ? np : n;
    product(r, pa, pb, pass == 2 ? t : nullptr, pass == 1);
    row_sync(r);
    normalise(r, pass == 1 ? nw : 2 * nw + 1, pass == 1 ? m : t,
              pass == 2 ? nw : 0);
  }
  cond_sub<SHARED2>(r, t, n, out, out2);
}

// words [0, nw) of v from a row of 16-bit limbs (int32 [2 nw]), this
// block's copy
__device__ __forceinline__ void load_words(uint32_t* v, const int* src,
                                           int nw, int tid, int T) {
  for (int j = tid; j < nw; j += T)
    v[j] = (uint32_t)__ldg(src + 2 * j) |
           ((uint32_t)__ldg(src + 2 * j + 1) << 16);
}

__device__ __forceinline__ void set_one(uint32_t* v, int nw, int tid,
                                        int T) {
  for (int j = tid; j < nw; j += T) v[j] = j == 0;
}

// Bring nw words of src (global) into dst (shared) by cp.async, 16 bytes
// a copy; cp_wait() ends them.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int nw, int tid, int T) {
  for (int j = 4 * tid; j < nw; j += 4 * T) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + j);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + j)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// MODE 0: operands, columns and table in shared memory; 1: the table in
// the global scratch [B, 2^w, nw]; 2: everything but the segment flags in
// the scratch [B, ops_words + 2^w nw] (one block a row).
template <int MODE>
__global__ void __launch_bounds__(1024)
limb_modexp_wide_kernel(const int* __restrict__ base,
                        const int* __restrict__ digits, int n_digits,
                        int per_row, const int* __restrict__ nmod,
                        const int* __restrict__ nprime,
                        const int* __restrict__ r2, int ctx_per_row,
                        int* __restrict__ out, int nw, int window,
                        uint32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) uint32_t smem[];
  Row r;
  r.nw = nw;
  r.tid = threadIdx.x;
  r.T = blockDim.x;
  r.lane = r.tid & (LANES - 1);
  r.warp = r.tid / LANES;
  int rank = 0, row = blockIdx.x;
  if (MODE == 2) {
    r.csize = 1;
  } else {
    cg::cluster_group cl = cg::this_cluster();
    r.csize = (int)cl.num_blocks();
    rank = (int)cl.block_rank();
    row = blockIdx.x / r.csize;
  }
  r.g = rank * r.T + r.tid;
  r.G = r.T * r.csize;
  const int TT = 1 << window;
  const size_t ow = ops_words(nw), tw = (size_t)TT * nw;
  uint32_t* ops = MODE == 2 ? scratch + (size_t)row * (ow + tw) : smem;
  uint32_t* tab = MODE == 0   ? smem + ow
                  : MODE == 1 ? scratch + (size_t)row * tw
                              : ops + ow;
  uint32_t* seg = MODE == 0 ? smem + ow + tw : MODE == 1 ? smem + ow : smem;
  uint32_t* n = ops;
  uint32_t* np = n + nw;
  uint32_t* acc = np + nw;
  uint32_t* x = acc + nw;
  uint32_t* y = x + nw;
  uint32_t* m = y + nw;
  uint32_t* t = m + nw;                          // 2 nw + 32 words
  r.c0 = t + 2 * nw + 32 + PAD;
  r.c1 = r.c0 + 2 * nw + 2 * PAD;
  r.c2 = r.c1 + 2 * nw + 2 * PAD;
  const int nseg = nw / 16 + 8;
  r.sg = seg;
  r.sp = seg + nseg;
  r.sc = seg + 2 * nseg;

  const size_t L = 2 * (size_t)nw;
  const size_t crow = ctx_per_row ? (size_t)row : 0;
  load_words(n, nmod + crow * L, nw, r.tid, r.T);
  load_words(np, nprime + crow * L, nw, r.tid, r.T);
  load_words(acc, base + (size_t)row * L, nw, r.tid, r.T);
  load_words(x, r2 + crow * L, nw, r.tid, r.T);
  for (int j = r.tid; j < PAD; j += r.T) {
    r.c0[j - PAD] = r.c1[j - PAD] = r.c2[j - PAD] = 0u;
    r.c0[2 * nw + j] = r.c1[2 * nw + j] = r.c2[2 * nw + j] = 0u;
  }
  row_sync(r);

  // the ladder, one Montgomery product a step: bm into table[1] (mode 1:
  // y, and the table's copy), 1_M into acc (and table[0]), table[v] =
  // table[v-1] * bm (mode 1: built in x from y), per digit `window`
  // squarings and table[d] * acc (mode 1: the entry staged into y by
  // cp.async at the digit's first squaring), the exit acc * 1
  constexpr bool DIRECT = MODE != 1;        // operands read from the table
  const int* dig = per_row ? digits + (size_t)row * n_digits : digits;
  const int n_mul = TT + n_digits * (window + 1) + 1;
  for (int st = 0; st < n_mul; ++st) {
    const uint32_t *A = acc, *Bv = acc;
    uint32_t* O = acc;
    uint32_t* O2 = nullptr;
    if (st == 0) {
      Bv = x;
      O = DIRECT ? tab + nw : y;
      O2 = DIRECT ? nullptr : tab + nw;
    } else if (st == 1) {
      set_one(acc, nw, r.tid, r.T);
      __syncthreads();
      Bv = x;
      O2 = tab;
    } else if (st < TT) {
      A = DIRECT ? tab + (size_t)(st - 1) * nw : st == 2 ? y : x;
      Bv = DIRECT ? tab + nw : y;
      O = DIRECT ? tab + (size_t)st * nw : x;
      O2 = DIRECT ? nullptr : tab + (size_t)st * nw;
    } else if (st < n_mul - 1) {
      const int j = st - TT, k = j / (window + 1), s = j % (window + 1);
      const int d = __ldg(dig + k);
      if (s < window) {
        if (!DIRECT && s == 0) stage(y, tab + (size_t)d * nw, nw, r.tid, r.T);
      } else {
        if (!DIRECT) cp_wait();
        A = DIRECT ? tab + (size_t)d * nw : y;
      }
    } else {
      set_one(x, nw, r.tid, r.T);
      __syncthreads();
      Bv = x;
    }
    mont_mul<MODE == 0>(r, A, Bv, O, O2, n, np, t, m);
  }

  if (rank == 0) {
    int* o = out + (size_t)row * L;
    for (int j = r.tid; j < nw; j += r.T) {
      o[2 * j] = (int)(acc[j] & 0xFFFFu);
      o[2 * j + 1] = (int)(acc[j] >> 16);
    }
  }
}

template <int MODE>
int launch_mode(int B, int threads, int cluster, size_t smem, void* stream,
                const void* base, const void* digits, int n_digits,
                int per_row, const void* nmod, const void* nprime,
                const void* r2, int ctx_per_row, void* out, int nw,
                int window, void* scratch) {
  auto kern = limb_modexp_wide_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == 2 ? 0 : 1;
  if (MODE != 2 && cluster > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&cfg, kern, (const int*)base, (const int*)digits,
                           n_digits, per_row, (const int*)nmod,
                           (const int*)nprime, (const int*)r2, ctx_per_row,
                           (int*)out, nw, window, (uint32_t*)scratch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one row's block at `mode`
// (mont_kernel.wide_row_bytes): the operands, product and columns
// (ops_words), the table of 2^window entries (mode 0) and the segment
// flags; mode 1 without the table, mode 2 the segment flags alone.
extern "C" long long limb_modexp_wide_row_bytes(int nw, int window,
                                                int mode) {
  size_t words = seg_words(nw);
  if (mode < 2) words += ops_words(nw);
  if (mode == 0) words += ((size_t)1 << window) * nw;
  return (long long)(words * sizeof(uint32_t));
}

// Launch on `stream`: a block of 32 `warps` threads a row (1 to 32),
// `cluster` blocks a row (1, 2, 4 or 8; a thread block cluster), nw a
// multiple of 32 words, `mode` as above with `scratch` the global uint32
// buffer of modes 1 ([B, 2^window nw]) and 2 ([B, ops_words(nw) +
// 2^window nw]).  Returns the cudaError_t of the attribute call, the cluster
// occupancy query or the launch (0 on success; cudaErrorInvalidValue for
// a shape the kernel does not take).  base, out: int32 [B, 2 nw] 16-bit
// limbs; digits int32 [D] (per_row 0) or [B, D]; nmod, nprime, r2: int32
// [2 nw] (ctx_per_row 0) or [B, 2 nw], n' = -n^-1 mod 2^(32 nw).
extern "C" int limb_modexp_wide_launch(const void* base, const void* digits,
                                       int n_digits, int per_row,
                                       const void* nmod, const void* nprime,
                                       const void* r2, int ctx_per_row,
                                       void* out, int B, int nw, int window,
                                       int warps, int cluster, int mode,
                                       void* scratch,
                                       void* stream) {
  if (B < 1 || nw < LANES || nw % LANES || window < 1 || window > 8 ||
      warps < 1 || warps > 32 ||
      !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) ||
      mode < 0 || mode > 2 ||
      (mode == 2 && cluster != 1) || (mode > 0 && scratch == nullptr) ||
      n_digits < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)limb_modexp_wide_row_bytes(nw, window, mode);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int threads = warps * LANES;
#define B4W_LAUNCH(M)                                                      \
  launch_mode<M>(B, threads, cluster, smem, stream, base, digits, n_digits, \
                 per_row, nmod, nprime, r2, ctx_per_row, out, nw, window,   \
                 scratch)
  switch (mode) {
    case 0: return B4W_LAUNCH(0);
    case 1: return B4W_LAUNCH(1);
    default: return B4W_LAUNCH(2);
  }
#undef B4W_LAUNCH
}
