// Kernel B4w: the limb-domain Montgomery fixed-window ladder of kernel B4
// (csrc/limb_modexp.cu) for moduli past B4's 768 limbs, with a row's
// operands in shared memory instead of registers.
//
// Replaces, with B4, paillier_tpu/bigint/pallas_kernels.py:_modexp_kernel
// (the Pallas TPU kernel behind mont_pow_pallas), at the widths B4 does
// not take.  The contract is B4's: for every row b of a batch, the
// canonical base_b^e_b mod n_b, with e given as MSB-first base-2^w
// digits, one string for the batch ([D]) or one per row ([B, D]), and n
// one modulus for the batch or one per row.  The ladder is
// montgomery.mont_pow_digits_plain's, multiply for multiply:
//   bm = base * R^2 * R^-1; table = [1_M, bm, bm^2, .., bm^(2^w - 1)];
//   acc = 1_M; per digit d: w squarings, then table[d] * acc, d = 0
//   included; exit: acc * 1.
// Every product is a canonical Montgomery product, so the output equals
// the plain version's (and Python's pow) whatever R is: R = 2^(32 nw)
// with nw a multiple of 32 words, the wrapper padding n with zero words
// and rebuilding R^2 mod n for that R.
//
// Why a second kernel: B4 holds a lane's W words of five operands in
// registers, W a template case up to 12 (nw = 384 words, 128 registers).
// n^3 of an 8192-bit key is 768 words, W = 24 at 32 lanes, past the 255
// registers a thread has.  Here one warp serves a row, W = nw / 32 is a
// run-time count, and the operands n, t (the product being formed), acc
// and x (a scratch operand), each nw words, lie in shared memory with the
// 2^w-entry power table.
//
// Layout: lane l owns the logical words l W .. l W + W - 1 of every
// operand, as in B4, so the product's word steps, shuffles and carry
// lookahead are B4's.  Its word w is stored at [w * 32 + l] of the
// operand (interleaved): when the warp touches "its own word w", the 32
// lanes read 32 consecutive words, one a bank, with no bank conflict
// (a contiguous block a lane, [l W + w], would put lanes l and
// l + 32 / gcd(W, 32) on one bank: a gcd(W, 32)-way conflict, 8-way at
// W = 16 and 24).  A lane only ever
// reads and writes its own words (b_i goes to the other lanes by
// __shfl_sync, never through shared memory), so no barrier is needed:
// each lane's shared words are private to it.  Table entry v of a row
// lies at [v * nw] in the same interleaved layout.
//
// Where a row's operands and table pass what a block's shared memory
// holds (232,448 B: 4 + 2^w operands of nw words; at window 4 past 2,905
// words, a 92,960-bit modulus), the table moves to a global scratch
// tensor [B, 2^w, nw] the wrapper allocates (mode 1); past 14,528 words
// (the four operands alone) the operands move there too (mode 2).  The
// wrapper picks the mode by width (mont_kernel.wide_mode) and the rows
// of a block (warps) by the batch and shared memory
// (mont_kernel.wide_rows_per_block), so no width is refused.
//
// The Montgomery product is CIOS by words of b, spread over the warp, as
// in B4.  For each word b_i:
//   b_i is broadcast from its owner lane (__shfl_sync);
//   m_i = (t_0 + a_0 b_i) (-n^-1) mod 2^32 is formed from the warp's
//     word 0, which is exact (no carry is ever pending there), and
//     broadcast;
//   every lane adds a_j b_i + m_i n_j into its words (two 32-bit carry
//     chains, each word read from shared memory and the shifted word
//     written back) and keeps its carry-out instead of passing it along;
//     the one-word shift brings word 0 of the lane above in on top, plus
//     the lane's own carry-out, and the carry of that sum (at most 2) is
//     the lane above's pending carry, which that lane forms itself from
//     the carry-out it receives (one shuffle each way).
// After the nw steps the pending carries are resolved once (each lane
// its own, then the carries between lanes by a carry-lookahead over the
// warp: generate and propagate bits by __ballot_sync), and the
// conditional subtract of n takes its borrows the same way.  t < a + n <
// 2R throughout, so one bit above the top word (kept by lane 31) holds
// it.
//
// What bounds it on an H100: the 2 nw^2 + nw 32x32->64 multiply-adds of
// a product on the INT32 pipe (an IMAD.WIDE takes two issues).  With a
// warp a row and tens of rows, the card is far below that: a product is
// nw dependent word steps, each W multiply-add pairs with three shared
// loads and a store, plus two shuffles and the m_i broadcast, so the
// kernel is latency bound (as B4 is at 768 limbs on 64 rows): one warp
// on one of an SM's four schedulers.  What the design does about it: a
// step's shared loads and multiplies go in chunks of 4 words, all issued
// before the chunk's two carry chains, which are additions only (20%
// faster than a word at a time on an H100, PERF.md §6).  Spreading a
// row over the SM's four schedulers is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ROWS = 8;          // rows (warps) of a block
constexpr int OPERANDS = 4;          // n, t, acc, x
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use

// Carries into this lane (return) and out of lane 31 (cout) of a sum
// whose lanes generate (gen) or propagate (prop) a carry; gen and prop
// are never both set in one lane.
__device__ __forceinline__ uint32_t lookahead(bool gen, bool prop, int l,
                                              uint32_t& cout) {
  const uint64_t G = __ballot_sync(FULL, gen);
  const uint64_t P = __ballot_sync(FULL, prop);
  const uint64_t c = ((G | P) + G) ^ (G | P) ^ G;   // carry into each bit
  cout = (uint32_t)(c >> LANES) & 1u;
  return (uint32_t)(c >> l) & 1u;
}

// x * y + z, 32 x 32 -> 64 bits (PTX mad.wide.u32: an asm block, so the
// compiler cannot fold a carry into it and put the multiply on the carry
// chain)
__device__ __forceinline__ uint64_t madw(uint32_t x, uint32_t y,
                                         uint64_t z) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(x), "r"(y), "l"(z));
  return r;
}

// Words of a lane that a word step takes at once (see word_step).
constexpr int CHUNK = 4;

// One word step over this lane's W words: t + a b_i + m_i n with the
// pending carry cy at word 0, shifted down one word in place (t[w - 1]
// takes the new word w).  Returns the new word 0 (u0, before the shift)
// and the carry-out at word W (co).  Every pointer is this lane's word 0
// of an interleaved operand.  The words after 0 go in chunks of CHUNK:
// a chunk's shared loads and its products a_j b_i + t_j and m_i n_j are
// issued first, all independent of the carries, and then only the two
// carry chains (additions) run word by word; the last W - 1 mod CHUNK
// words go one at a time.
__device__ __forceinline__ void word_step(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ n,
    uint32_t* __restrict__ t, int W, uint32_t a0, uint32_t n0w, uint32_t bi,
    uint32_t k0, uint32_t cy, uint32_t& u0, uint64_t& co) {
  const uint32_t t0 = t[0];
  const uint32_t m = __shfl_sync(FULL, (t0 + a0 * bi) * k0, 0);
  uint64_t p = (uint64_t)a0 * bi + t0 + cy;
  uint32_t c1 = (uint32_t)(p >> 32);
  uint64_t q = (uint64_t)m * n0w + (uint32_t)p;
  uint32_t c2 = (uint32_t)(q >> 32);
  u0 = (uint32_t)q;
  int w = 1;
  for (; w + CHUNK <= W; w += CHUNK) {
    uint64_t X[CHUNK], Y[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      X[j] = madw(a[(w + j) * LANES], bi, t[(w + j) * LANES]);
      Y[j] = madw(m, n[(w + j) * LANES], 0);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      p = X[j] + c1;
      c1 = (uint32_t)(p >> 32);
      q = Y[j] + (uint32_t)p + c2;
      c2 = (uint32_t)(q >> 32);
      t[(w + j - 1) * LANES] = (uint32_t)q;
    }
  }
  for (; w < W; ++w) {
    p = madw(a[w * LANES], bi, t[w * LANES]) + c1;
    c1 = (uint32_t)(p >> 32);
    q = madw(m, n[w * LANES], 0) + (uint32_t)p + c2;
    c2 = (uint32_t)(q >> 32);
    t[(w - 1) * LANES] = (uint32_t)q;
  }
  co = (uint64_t)c1 + c2;
}

// out = a * b * R^-1 mod n, canonical, for a < R and b < n; t is the
// row's product scratch.  out may alias a or b (both are read before out
// is written).
__device__ __forceinline__ void mont_mul(const uint32_t* a,
                                         const uint32_t* b,
                                         const uint32_t* n, uint32_t* t,
                                         uint32_t k0, uint32_t* out, int W,
                                         int l) {
  const bool top = l == LANES - 1;
  for (int w = 0; w < W; ++w) t[w * LANES] = 0;
  const uint32_t a0 = a[0], n0w = n[0];
  uint32_t cy = 0;   // carry pending at this lane's word 0 (lane 0: none)
  uint32_t tx = 0;   // lane 31: the bit above the top word
  for (int src = 0; src < LANES; ++src) {
    for (int wb = 0; wb < W; ++wb) {
      const uint32_t bi = __shfl_sync(FULL, b[wb * LANES], src);
      uint32_t u0;
      uint64_t co;
      word_step(a, n, t, W, a0, n0w, bi, k0, cy, u0, co);
      const uint32_t above = __shfl_down_sync(FULL, u0, 1);
      const uint64_t below = __shfl_up_sync(FULL, (unsigned long long)co, 1);
      const uint64_t s = (uint64_t)(top ? tx : above) + co;
      t[(W - 1) * LANES] = (uint32_t)s;
      if (top) tx = (uint32_t)(s >> 32);
      // the lane below's top-word sum carries into this lane's word 0
      cy = l == 0 ? 0u : (uint32_t)(((uint64_t)u0 + below) >> 32);
    }
  }
  // resolve: this lane's own pending carry, then the carries between lanes
  uint32_t c = cy;
  bool ones = true;
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)t[w * LANES] + c;
    t[w * LANES] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
    ones = ones && (uint32_t)v == FULL;
  }
  uint32_t cout;
  c = lookahead(c != 0, ones, l, cout);
  tx += cout;        // only lane 31's tx counts
  // add the incoming carry; t < 2n: the borrows of t - n, by lane
  uint32_t bw = 0;
  bool zero = true;
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)t[w * LANES] + c;
    const uint32_t tw = (uint32_t)v;
    t[w * LANES] = tw;
    c = (uint32_t)(v >> 32);
    const uint64_t d = (uint64_t)tw - n[w * LANES] - bw;
    bw = (uint32_t)(d >> 32) & 1u;
    zero = zero && (uint32_t)d == 0;
  }
  uint32_t bout;
  bw = lookahead(bw != 0, zero, l, bout);
  const bool sub = __shfl_sync(FULL, tx, LANES - 1) != 0 || bout == 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t tw = t[w * LANES];
    if (sub) {
      const uint64_t d = (uint64_t)tw - n[w * LANES] - bw;
      bw = (uint32_t)(d >> 32) & 1u;
      out[w * LANES] = (uint32_t)d;
    } else {
      out[w * LANES] = tw;
    }
  }
}

// this lane's words of a row of 16-bit limbs (int32 [2 nw])
__device__ __forceinline__ void load_words(uint32_t* v, const int* src,
                                           int W, int l) {
  for (int w = 0; w < W; ++w) {
    const size_t j = (size_t)l * W + w;
    v[w * LANES] = (uint32_t)__ldg(src + 2 * j) |
                   ((uint32_t)__ldg(src + 2 * j + 1) << 16);
  }
}

// the value 1 (word 0 of lane 0)
__device__ __forceinline__ void set_one(uint32_t* v, int W, int l) {
  for (int w = 0; w < W; ++w) v[w * LANES] = l == 0 && w == 0;
}

// MODE 0: operands and table in shared memory; 1: the table in the
// global scratch [B, 2^w, nw]; 2: both in the scratch [B, 4 + 2^w, nw].
template <int MODE>
__global__ void __launch_bounds__(MAX_ROWS * LANES)
limb_modexp_wide_kernel(const int* __restrict__ base,
                        const int* __restrict__ digits, int n_digits,
                        int per_row, const int* __restrict__ nmod,
                        const int* __restrict__ n0,
                        const int* __restrict__ r2, int ctx_per_row,
                        int* __restrict__ out, int B, int nw, int window,
                        uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t smem[];
  const int l = threadIdx.x & (LANES - 1);
  const int grp = threadIdx.x / LANES;          // the block's row
  const int row = blockIdx.x * (blockDim.x / LANES) + grp;
  if (row >= B) return;       // a whole warp: its shuffles name only it
  const int W = nw / LANES, T = 1 << window;
  const size_t L = 2 * (size_t)nw;
  const size_t ops_w = (size_t)OPERANDS * nw, tab_w = (size_t)T * nw;
  uint32_t* ops;
  uint32_t* tab;
  if (MODE == 0) {
    ops = smem + grp * (ops_w + tab_w);
    tab = ops + ops_w;
  } else if (MODE == 1) {
    ops = smem + grp * ops_w;
    tab = scratch + row * tab_w;
  } else {
    ops = scratch + row * (ops_w + tab_w);
    tab = ops + ops_w;
  }
  uint32_t* n = ops + l;
  uint32_t* t = n + nw;
  uint32_t* acc = t + nw;
  uint32_t* x = acc + nw;
  uint32_t* tb = tab + l;     // this lane's word 0 of entry 0
  const size_t crow = ctx_per_row ? (size_t)row : 0;
  load_words(n, nmod + crow * L, W, l);
  const uint32_t k0 = (uint32_t)__ldg(n0 + crow);

  // table[1] = bm = base * R^2 * R^-1; table[0] = 1 * R^2 * R^-1 = R mod n;
  // table[v] = table[v-1] * bm
  load_words(acc, base + row * L, W, l);
  load_words(x, r2 + crow * L, W, l);
  mont_mul(acc, x, n, t, k0, tb + nw, W, l);
  set_one(acc, W, l);
  mont_mul(acc, x, n, t, k0, tb, W, l);          // acc = 1_M from here on
  for (int w = 0; w < W; ++w) acc[w * LANES] = tb[w * LANES];
  for (int v = 2; v < T; ++v)
    mont_mul(tb + (size_t)(v - 1) * nw, tb + nw, n, t, k0,
             tb + (size_t)v * nw, W, l);

  const int* dig = per_row ? digits + (size_t)row * n_digits : digits;
  for (int step = 0; step < n_digits; ++step) {
    const int d = __ldg(dig + step);
    for (int s = 0; s < window; ++s) mont_mul(acc, acc, n, t, k0, acc, W, l);
    mont_mul(tb + (size_t)d * nw, acc, n, t, k0, acc, W, l);
  }

  // exit: acc * 1 leaves the Montgomery domain
  set_one(x, W, l);
  mont_mul(acc, x, n, t, k0, acc, W, l);
  int* o = out + row * L;
  for (int w = 0; w < W; ++w) {
    const size_t j = (size_t)l * W + w;
    o[2 * j] = (int)(acc[w * LANES] & 0xFFFFu);
    o[2 * j + 1] = (int)(acc[w * LANES] >> 16);
  }
}

template <int MODE>
int launch_mode(int grid, int threads, size_t smem, void* stream,
                const void* base, const void* digits, int n_digits,
                int per_row, const void* nmod, const void* n0, const void* r2,
                int ctx_per_row, void* out, int B, int nw, int window,
                void* scratch) {
  cudaError_t err = cudaFuncSetAttribute(
      limb_modexp_wide_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  limb_modexp_wide_kernel<MODE><<<grid, threads, smem,
                                  (cudaStream_t)stream>>>(
      (const int*)base, (const int*)digits, n_digits, per_row,
      (const int*)nmod, (const int*)n0, (const int*)r2, ctx_per_row,
      (int*)out, B, nw, window, (uint32_t*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one row at `mode` (mont_kernel.wide_row_bytes):
// 4 + 2^window operands of nw words (mode 0), the 4 operands (mode 1),
// none (mode 2).
extern "C" long long limb_modexp_wide_row_bytes(int nw, int window,
                                                int mode) {
  const size_t ops = mode == 0 ? OPERANDS + ((size_t)1 << window)
                     : mode == 1 ? OPERANDS : 0;
  return (long long)(ops * nw * sizeof(uint32_t));
}

// Launch on `stream`: one warp a row, `rb` rows a block (1..8), nw a
// multiple of 32 words, `mode` as above with `scratch` the global uint32
// buffer of modes 1 ([B, 2^window, nw]) and 2 ([B, 4 + 2^window, nw]).
// Returns the cudaError_t of the attribute call or of the launch (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take).
// base, out: int32 [B, 2 nw] 16-bit limbs; digits int32 [D] (per_row 0)
// or [B, D]; nmod, r2: int32 [2 nw] (ctx_per_row 0) or [B, 2 nw]; n0:
// int32 [1] or [B], the low 32 bits of -n^-1 mod 2^32.
extern "C" int limb_modexp_wide_launch(const void* base, const void* digits,
                                       int n_digits, int per_row,
                                       const void* nmod, const void* n0,
                                       const void* r2, int ctx_per_row,
                                       void* out, int B, int nw, int window,
                                       int rb, int mode, void* scratch,
                                       void* stream) {
  if (B < 1 || nw < LANES || nw % LANES || window < 1 || window > 8 ||
      rb < 1 || rb > MAX_ROWS || mode < 0 || mode > 2 ||
      (mode > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)rb * (size_t)limb_modexp_wide_row_bytes(nw, window, mode);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (B + rb - 1) / rb;
#define B4W_LAUNCH(M)                                                     \
  launch_mode<M>(grid, rb * LANES, smem, stream, base, digits, n_digits,  \
                 per_row, nmod, n0, r2, ctx_per_row, out, B, nw, window,  \
                 scratch)
  switch (mode) {
    case 0: return B4W_LAUNCH(0);
    case 1: return B4W_LAUNCH(1);
    default: return B4W_LAUNCH(2);
  }
#undef B4W_LAUNCH
}
