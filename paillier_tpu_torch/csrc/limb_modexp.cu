// Kernel B4: limb-domain Montgomery fixed-window ladder, shared or
// per-row moduli and exponents.
//
// Replaces paillier_tpu/bigint/pallas_kernels.py:_modexp_kernel (the
// Pallas TPU kernel behind mont_pow_pallas, which the JAX package also
// vmaps over per-candidate moduli in keygen's Fermat batch).  It computes,
// for every row b of a batch, the canonical base_b^e_b mod n_b, with e
// given as MSB-first base-2^w digits, one string for the batch ([D]) or
// one per row ([B, D]), and n one modulus for the batch or one per row.
// The ladder is montgomery.mont_pow_digits_plain's, multiply for multiply:
//   bm = base * R^2 * R^-1; table = [1_M, bm, bm^2, .., bm^(2^w - 1)];
//   acc = 1_M; per digit d: w squarings, then acc * table[d], d = 0
//   included; exit: acc * 1.
// Every product is a canonical Montgomery product, so the output equals
// the plain version's (and Python's pow) whatever R is: R = 2^(32 nw)
// with nw = TPI * W words, the wrapper padding n with zero words and
// rebuilding R^2 mod n for that R.
//
// Layout: a group of TPI lanes of one warp (TPI a power of two, 4..32,
// chosen by the wrapper from the batch: mont_kernel.lanes_per_row) serves
// a row; lane l holds words l W .. l W + W - 1 of the operands, the
// accumulator and n in registers.  The 2^w-entry power table lies in
// shared memory, [row of the block][entry][word], so a lane reads its own
// W words of an entry contiguously (and only words it wrote: no barrier
// anywhere); rows with per-row digits read different entries.
//
// The Montgomery product is CIOS by words of b (Koc et al.), spread over
// the group.  For each word b_i:
//   b_i is broadcast from its owner lane (__shfl_sync over the group);
//   m_i = (t_0 + a_0 b_i) (-n^-1) mod 2^32 is formed from the group's
//     word 0, which is exact (no carry is ever pending there), and
//     broadcast;
//   every lane adds a_j b_i + m_i n_j into its words (two 32-bit carry
//     chains) and keeps its carry-out instead of passing it along the
//     group; the one-word shift brings the word 0 of the lane above in on
//     top, plus the lane's own carry-out, and the carry of that sum (at
//     most 2) is the lane above's pending carry, which that lane forms
//     itself from the carry-out it receives (one shuffle each way, in
//     parallel).
// After the nw steps the pending carries are resolved once: each lane
// adds its own, then the carries between lanes come from a carry-lookahead
// over the group (generate and propagate bits by __ballot_sync, the
// carries of the sum (G|P) + G).  The conditional subtract of n takes its
// borrows the same way.  t < a + n < 2R throughout, so one bit above the
// top word (kept by the group's top lane) holds it.
//
// What bounds it on an H100: the 2 nw^2 + nw 32x32->64 multiply-adds per
// product on the INT32 pipe (an IMAD.WIDE takes two issues, so at most 32
// per clock per SM).  One thread per row, as this kernel first was, left
// about one warp per SM at 4096 rows, bound by the latency of its carry
// chains; TPI lanes a row give TPI times the warps, and a word step's
// dependent chain (two multiplies, a shuffle of m_i, W multiply-adds, a
// shuffle) is W multiply-adds long instead of nw.  Measured on an H100
// (PERF.md §6): 4096 rows at L = 128 ran fastest with 8 lanes a row
// (more lanes cost more shuffles than they hide), 1024 rows with 32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;   // threads (rows x TPI) of a block

// A row's group of lanes within its warp.
struct Group {
  unsigned mask;   // the group's lanes
  int tpi;         // lanes in the group
  int l;           // this lane's index in the group
  int base;        // warp lane of the group's lane 0
  bool top;        // l == tpi - 1
};

__device__ __forceinline__ uint32_t bcast(const Group& g, uint32_t v,
                                          int src) {
  return __shfl_sync(g.mask, v, src, g.tpi);
}

// Carries into this lane (return) and out of the group's top (cout) of a
// sum whose lanes generate (gen) or propagate (prop) a carry; gen and
// prop are never both set in one lane.
__device__ __forceinline__ uint32_t lookahead(const Group& g, bool gen,
                                              bool prop, uint32_t& cout) {
  const uint64_t low = g.tpi == 32 ? 0xffffffffull : (1ull << g.tpi) - 1;
  const uint64_t G = (__ballot_sync(g.mask, gen) >> g.base) & low;
  const uint64_t P = (__ballot_sync(g.mask, prop) >> g.base) & low;
  const uint64_t c = ((G | P) + G) ^ (G | P) ^ G;   // carry into each bit
  cout = (uint32_t)(c >> g.tpi) & 1u;
  return (uint32_t)(c >> g.l) & 1u;
}

// out = a * b * R^-1 mod n, canonical, for a < R and b < n; each array
// holds this lane's W words.  out may alias a or b.
template <int W>
__device__ __forceinline__ void mont_mul(const Group& g,
                                         const uint32_t (&a)[W],
                                         const uint32_t (&b)[W],
                                         const uint32_t (&n)[W], uint32_t n0,
                                         uint32_t (&out)[W]) {
  uint32_t t[W];
#pragma unroll
  for (int w = 0; w < W; ++w) t[w] = 0;
  uint32_t cy = 0;   // carry pending at this lane's word 0 (lane 0: none)
  uint32_t tx = 0;   // top lane: the bit above the top word
  for (int src = 0; src < g.tpi; ++src) {
#pragma unroll
    for (int wb = 0; wb < W; ++wb) {
      const uint32_t bi = bcast(g, b[wb], src);
      const uint32_t m = bcast(g, (t[0] + a[0] * bi) * n0, 0);
      uint32_t c1 = cy, c2 = 0, u[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint64_t p = (uint64_t)a[w] * bi + t[w] + c1;
        c1 = (uint32_t)(p >> 32);
        const uint64_t q = (uint64_t)m * n[w] + (uint32_t)p + c2;
        c2 = (uint32_t)(q >> 32);
        u[w] = (uint32_t)q;
      }
      // carry-out at this lane's word W, i.e. its top word after the shift
      const uint64_t co = (uint64_t)c1 + c2;
      const uint32_t above = __shfl_down_sync(g.mask, u[0], 1, g.tpi);
      const uint64_t below = __shfl_up_sync(
          g.mask, (unsigned long long)co, 1, g.tpi);
#pragma unroll
      for (int w = 0; w + 1 < W; ++w) t[w] = u[w + 1];
      const uint64_t s = (uint64_t)(g.top ? tx : above) + co;
      t[W - 1] = (uint32_t)s;
      if (g.top) tx = (uint32_t)(s >> 32);
      // the lane below's top-word sum carries into this lane's word 0
      cy = g.l == 0 ? 0u : (uint32_t)(((uint64_t)u[0] + below) >> 32);
    }
  }
  // resolve: this lane's own pending carry, then the carries between lanes
  uint32_t c = cy;
  bool ones = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)t[w] + c;
    t[w] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
    ones = ones && t[w] == 0xffffffffu;
  }
  uint32_t cout;
  c = lookahead(g, c != 0, ones, cout);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)t[w] + c;
    t[w] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  tx += cout;        // only the top lane's tx counts
  // t < 2n: d = t - n, borrows between lanes by the same lookahead
  uint32_t d[W], bw = 0;
  bool zero = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)t[w] - n[w] - bw;
    d[w] = (uint32_t)v;
    bw = (uint32_t)(v >> 32) & 1u;
    zero = zero && d[w] == 0;
  }
  uint32_t bout;
  bw = lookahead(g, bw != 0, zero, bout);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)d[w] - bw;
    d[w] = (uint32_t)v;
    bw = (uint32_t)(v >> 32) & 1u;
  }
  const bool sub = bcast(g, tx, g.tpi - 1) != 0 || bout == 0;
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = sub ? d[w] : t[w];
}

// this lane's words of a row of 16-bit limbs (int32 [2 nw])
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&v)[W], const int* src,
                                           int l) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = l * W + w;
    v[w] = (uint32_t)__ldg(src + 2 * j) | ((uint32_t)__ldg(src + 2 * j + 1)
                                            << 16);
  }
}

// the value 1 (word 0 of lane 0)
template <int W>
__device__ __forceinline__ void set_one(uint32_t (&v)[W], int l) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = l == 0 && w == 0;
}

template <int W>
__device__ __forceinline__ void copy_words(uint32_t* dst,
                                           const uint32_t (&v)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) dst[w] = v[w];
}

template <int W>
__device__ __forceinline__ void read_words(uint32_t (&v)[W],
                                           const uint32_t* src) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = src[w];
}

template <int W>
__global__ void __launch_bounds__(MAX_THREADS)
limb_modexp_kernel(const int* __restrict__ base,
                   const int* __restrict__ digits, int n_digits, int per_row,
                   const int* __restrict__ nmod, const int* __restrict__ n0,
                   const int* __restrict__ r2, int ctx_per_row,
                   int* __restrict__ out, int B, int nw, int window,
                   int tpi) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  Group g;
  g.tpi = tpi;
  g.l = lane & (tpi - 1);
  g.base = lane - g.l;
  g.mask = (tpi == 32 ? 0xffffffffu : (1u << tpi) - 1u) << g.base;
  g.top = g.l == tpi - 1;
  const int grp = threadIdx.x / tpi;           // the block's row
  const int row = blockIdx.x * (blockDim.x / tpi) + grp;
  if (row >= B) return;       // a whole group: its shuffles name only it
  const int T = 1 << window;
  // this lane's words of table entry 0; entry v at tb[v * nw]
  uint32_t* tb = smem + (size_t)grp * (T * nw + nw % 32) + g.l * W;
  const int L = 2 * nw;
  const size_t crow = ctx_per_row ? (size_t)row : 0;
  uint32_t n[W], acc[W], x[W], aux[W], bm[W];
  load_words<W>(n, nmod + crow * L, g.l);
  const uint32_t k0 = (uint32_t)__ldg(n0 + crow);

  // table[1] = bm = base * R^2 * R^-1; table[0] = 1 * R^2 * R^-1 = R mod n;
  // table[v] = table[v-1] * bm
  load_words<W>(x, base + (size_t)row * L, g.l);
  load_words<W>(aux, r2 + crow * L, g.l);
  mont_mul<W>(g, x, aux, n, k0, bm);
  set_one<W>(x, g.l);
  mont_mul<W>(g, x, aux, n, k0, acc);          // acc = 1_M from here on
  copy_words<W>(tb, acc);
  copy_words<W>(tb + nw, bm);
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = bm[j];
  for (int v = 2; v < T; ++v) {
    mont_mul<W>(g, x, bm, n, k0, x);
    copy_words<W>(tb + v * nw, x);
  }

  const int* dig = per_row ? digits + (size_t)row * n_digits : digits;
  for (int step = 0; step < n_digits; ++step) {
    const int d = __ldg(dig + step);
    for (int s = 0; s < window; ++s) mont_mul<W>(g, acc, acc, n, k0, acc);
    read_words<W>(x, tb + d * nw);
    mont_mul<W>(g, x, acc, n, k0, acc);
  }

  // exit: acc * 1 leaves the Montgomery domain
  set_one<W>(aux, g.l);
  mont_mul<W>(g, acc, aux, n, k0, acc);
  int* o = out + (size_t)row * L + 2 * g.l * W;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    o[2 * w] = (int)(acc[w] & 0xFFFFu);
    o[2 * w + 1] = (int)(acc[w] >> 16);
  }
}

template <int W>
int launch_w(int grid, int threads, size_t smem, void* stream,
             const void* base, const void* digits, int n_digits, int per_row,
             const void* nmod, const void* n0, const void* r2,
             int ctx_per_row, void* out, int B, int nw, int window,
             int tpi) {
  cudaError_t err = cudaFuncSetAttribute(
      limb_modexp_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  limb_modexp_kernel<W><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)base, (const int*)digits, n_digits, per_row,
      (const int*)nmod, (const int*)n0, (const int*)r2, ctx_per_row,
      (int*)out, B, nw, window, tpi);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one row of a block: its 2^window-entry table of
// nw words, padded by nw mod 32 words so that the rows of a warp start on
// different banks.
extern "C" int limb_modexp_row_bytes(int nw, int window) {
  return (int)(((size_t)(1 << window) * nw + nw % 32) * sizeof(uint32_t));
}

// Launch on `stream` with `tpi` lanes a row (a power of two, 4..32, that
// divides nw into W = 1, 2, 3, 4, 8 or 12 words a lane) and blocks of `rb`
// rows (rb * tpi <= MAX_THREADS); returns the cudaError_t of the
// attribute call or of the launch (0 on success; cudaErrorInvalidValue
// for a shape the kernel does not take).  base, out: int32 [B, 2 nw]
// 16-bit limbs; digits int32 [D] (per_row 0) or [B, D]; nmod, r2: int32
// [2 nw] (ctx_per_row 0) or [B, 2 nw]; n0: int32 [1] or [B], the low 32
// bits of -n^-1 mod 2^32.
extern "C" int limb_modexp_launch(const void* base, const void* digits,
                                  int n_digits, int per_row, const void* nmod,
                                  const void* n0, const void* r2,
                                  int ctx_per_row, void* out, int B, int nw,
                                  int window, int tpi, int rb, void* stream) {
  if (tpi < 4 || tpi > 32 || (tpi & (tpi - 1)) || nw % tpi || rb < 1 ||
      rb * tpi > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rb * limb_modexp_row_bytes(nw, window);
  const int grid = (B + rb - 1) / rb;
#define B4_LAUNCH(W)                                                        \
  launch_w<W>(grid, rb * tpi, smem, stream, base, digits, n_digits, per_row, \
              nmod, n0, r2, ctx_per_row, out, B, nw, window, tpi)
  switch (nw / tpi) {
    case 1: return B4_LAUNCH(1);
    case 2: return B4_LAUNCH(2);
    case 3: return B4_LAUNCH(3);
    case 4: return B4_LAUNCH(4);
    case 8: return B4_LAUNCH(8);
    case 12: return B4_LAUNCH(12);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B4_LAUNCH
}
