// The Cox-Rower RNS Montgomery multiply on int8 tensor cores, used by
// kernels B1 (rns2_sliding.cu) and B2 (rns2_modexp.cu), and the launch
// rule both kernels share (end of this file).
//
// It is rns2.rns2_mont_mul_pair on a tile of R batch rows (R = 8, 16 or
// 32), bit for bit: the reductions and rounding rules are those of
// rns2_mont.cuh (red_exact, red_lazy, red_fast; __fmul_rn, floors
// __float2int_rd, truncations __float2int_rz; no --use_fast_math), and
// the int32 extension sums are exact in any order.
//
// Products.  Each base extension P = lhs [R, 2k] x E [2k, 2k] runs as
// P^T = E^T lhs^T on mma.sync.m16n8k32.row.col.s32.s8.s8.s32:
//   A (16 x 32, row)  a 16-channel x 32-digit slice of E^T, read from L2
//                     with one 16-byte __ldg a lane; the host packs E into
//                     that fragment order (cuda_build.pack_mma);
//   B (32 x 8, col)   8 batch rows x 32 digits of lhs, which is row-major
//                     [R][2k] in shared memory, i.e. the .col layout;
//   C (16 x 8)        int32 sums, channel on M, batch row on N.
// A warp owns a group of 16 channels c0..c0+15 and accumulates its lo
// columns (c0 + m) and hi columns (k + c0 + m) over K = 2k for all R
// rows, so lo and hi of one (channel, row) sit in one lane at one
// fragment slot: lane (g, t) holds channels c0+g, c0+g+8 of rows 2t,
// 2t+1 of each 8-row slice.  The stage after each extension therefore
// stays private to a thread, as in rns2_mont.cuh.  Within each 64-digit
// slice the contraction order is permuted (the sum does not depend on
// it) so that a lane's B fragments of two k32 steps are one 16-byte
// shared-memory load: lane t reads digits 64s + 16t .. 64s + 16t + 15.
// lhs rows are padded by LHS_PAD bytes, which spreads those loads over
// all 32 banks.
//
// Tiles.  The residue tiles (acc, opd) are int16 [R][k] per base: lazy
// residues lie in (-m - 820, 2m) with 2m < 2^15.  Shared memory per
// block: 4 R k 2 + 2 R (2k + 64) + R (k/16) 4 + R 4 bytes (129,664 at
// R = 32, k = 320).  Two lhs buffers let a warp write the second
// extension's digits while others still read the first's.
//
// Elementwise stages (loads, stage 1, table stores) visit the tile
// through for_each, which gives a thread the same elements every time,
// so they need no synchronisation among themselves; the stages after the
// products use the fragment mapping and are fenced by __syncthreads.
//
// Cox alpha sums: per row a pairwise tree, first over a lane's two
// channels, then a shuffle tree over the 8 lanes of one t (16 channels),
// then over the k/16 group partials in shared memory (one pair, then a
// shuffle tree).  Their f32 error stays far below the 2e-3 the spec's
// COX_EPS check assumes.
//
// Wide specs (WIDE, k >= 512) pre-reduce the hi column sum exactly where
// rns2._mm_lhs2 / _mm_finish do (see rns2_mont.cuh).
//
// Launch rule (tile_rows; the wrappers ask for the tile, size their
// table scratch by it and pass it back to the launch).  Instantiations:
//   R = 32  k <= 320 only; __launch_bounds__(640, 1), 2k threads (a warp
//           per 16-channel group; 20 warps at k = 320); 129,664 bytes of
//           shared memory at k = 320.
//   R = 16  __launch_bounds__(704, 1): 2k threads up to k = 320, else k
//           (a warp per two groups); at k = 512 __launch_bounds__(512, 1),
//           which gives a thread 128 registers instead of 80 and made B1
//           9% faster.
//   R = 8   __launch_bounds__(704, 1).
// Rule, from every tile timed at 512-8192 rows (k = 192, 320) and
// 256-4096 rows (k = 512, 704) on an H100 (PERF.md §6,
// scripts/ab_sliding.py):
//   k <= 320: a block takes about as long whatever the grid (B1 at
//     k = 320: ~27 ms at 8 rows, ~34 at 16, ~41 at 32 for e = n), so the
//     time is the number of waves times a block's time.  A wave of R-row
//     tiles holds SMs x (blocks an SM keeps resident, from the occupancy
//     API) x R rows; take the tile whose one wave holds B with the fewest
//     rows to spare (the larger tile on a tie: at k = 192, two resident
//     16-row blocks were slower than one 32-row block), and if no wave
//     holds B the one with the most rows per wave.  On an H100 at
//     k = 320: 8 rows up to 1056, 16 up to 2112, then 32; at k = 192: 8
//     up to 2112, then 32.
//   k > 320: the L2 reads of the matrices bind, so fewer blocks win: the
//     largest tile whose grid keeps MIN_BLOCKS = 64 blocks (at 1024 rows,
//     64 blocks of 16 rows beat 128 blocks of 8).
// B2's block has B1's shared memory and threads, so one rule serves both.

#pragma once

#include "rns2_mont.cuh"

namespace rns2mma {

// what is shared with the __dp4a multiply (its tile helpers are not)
using rns2::CHUNK;
using rns2::COX_EPS;
using rns2::I1_M2M;
using rns2::I2_U0S;
using rns2::I_ENTRY;
using rns2::I_M;
using rns2::I_ONE;
using rns2::I_ONEM;
using rns2::K_MAX;
using rns2::K_NARROW;
using rns2::WIDE_K;
using rns2::red_exact;
using rns2::red_fast;
using rns2::red_lazy;
using rns2::warp_sum;

constexpr int LHS_PAD = 64;      // bytes after each lhs row

__host__ __device__ inline int lhs_stride(int k) { return 2 * k + LHS_PAD; }

// Dynamic shared memory of one block with R-row tiles.
template <int R>
inline size_t smem_bytes(int k) {
  return (size_t)4 * R * k * sizeof(int16_t)     // acc, opd
         + (size_t)2 * R * lhs_stride(k)          // lhs1, lhs2
         + (size_t)R * (k / 16) * sizeof(float)   // group alpha partials
         + (size_t)R * sizeof(int);               // alpha
}

// Threads of a block: 2k (a warp per 16-channel group) when MAXT allows,
// else k (a warp per two groups).  Either way thread i owns channel
// i mod k of every (i div k + j nthr/k)-th tile row in the elementwise
// stages.
inline int block_threads(int k, int maxt) { return 2 * k <= maxt ? 2 * k : k; }

struct Tile {
  int16_t* acc1; int16_t* acc2;    // accumulator [R][k] per base
  int16_t* opd1; int16_t* opd2;    // second operand [R][k] per base
  int8_t* lhs1; int8_t* lhs2;      // digit rows [R][lhs_stride(k)]
  float* part;                     // alpha partials [R][k/16]
  int* alpha;                      // [R]
};

struct Ctx {                       // global inputs and the block's shape
  const int* ic1; const int* ic2;
  const float* f1; const float* f2;
  const int4* e1p; const int4* e2p;  // pack_mma matrices
  int k, G, LS;
  int warp, nwarp, lane, g, t;
  int ec, er, edr;                 // elementwise: channel, first row, row step
};

template <int R>
__device__ __forceinline__ void setup(Tile& s, Ctx& c, int4* smem_raw,
                                      int k) {
  s.acc1 = reinterpret_cast<int16_t*>(smem_raw);
  s.acc2 = s.acc1 + R * k;
  s.opd1 = s.acc2 + R * k;
  s.opd2 = s.opd1 + R * k;
  s.lhs1 = reinterpret_cast<int8_t*>(s.opd2 + R * k);   // 16B aligned
  s.lhs2 = s.lhs1 + R * lhs_stride(k);
  s.part = reinterpret_cast<float*>(s.lhs2 + R * lhs_stride(k));
  s.alpha = reinterpret_cast<int*>(s.part + R * (k / 16));
  c.k = k;
  c.G = k / 16;
  c.LS = lhs_stride(k);
  const int tid = threadIdx.x;
  c.warp = tid >> 5;
  c.nwarp = blockDim.x >> 5;
  c.lane = tid & 31;
  c.g = c.lane >> 2;
  c.t = c.lane & 3;
  c.er = tid >= k;                 // blockDim.x is k or 2k
  c.ec = tid - c.er * k;
  c.edr = blockDim.x / k;
}

// f(r) for every row r of the tile that this thread's channel cx.ec
// visits in the elementwise stages; a thread always visits the same
// elements.
template <int R, typename F>
__device__ __forceinline__ void for_each(const Ctx& cx, F f) {
  for (int r = cx.er; r < R; r += cx.edr) f(r);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int4& a, int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// How ext_mma loads the packed matrix: through the read-only data cache
// (__ldg), as B1 and B2 read it.  LoadL2 (ld.global.cg) caches in L2 only,
// so every load is an L2 read (the probe P4's L2 rate case).
struct LoadNC {
  __device__ __forceinline__ static int4 ld(const int4* p) { return __ldg(p); }
};
struct LoadL2 {
  __device__ __forceinline__ static int4 ld(const int4* p) {
    return __ldcg(p);
  }
};

// lo / hi sums of channel group cg for all R rows: lo[n][j] is channel
// cg*16 + g + 8*(j >> 1) of row 8n + 2t + (j & 1); hi the same channel's
// hi column.  ep: the pack_mma matrix, [G][2k/32][2][32] int4 (k32 step,
// lo/hi, lane).
template <int R, typename LD = LoadNC>
__device__ __forceinline__ void ext_mma(const Ctx& cx, const int8_t* lhs,
                                        const int4* __restrict__ ep, int cg,
                                        int (&lo)[R / 8][4],
                                        int (&hi)[R / 8][4]) {
#pragma unroll
  for (int n = 0; n < R / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) { lo[n][j] = 0; hi[n][j] = 0; }
  const int npair = cx.k / 32;                 // 64-digit slices
  const int4* ap = ep + (size_t)cg * npair * 128 + cx.lane;
  const int8_t* bp = lhs + cx.g * cx.LS + 16 * cx.t;
  int4 a[4], nx[4];                // [step u][lo, hi], this slice and next
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = LD::ld(ap + 32 * q);
  for (int s = 0; s < npair; ++s) {
    const int4* np = ap + 128 * min(s + 1, npair - 1);   // one slice ahead
#pragma unroll
    for (int q = 0; q < 4; ++q) nx[q] = LD::ld(np + 32 * q);
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      const int4 b = *reinterpret_cast<const int4*>(bp + 8 * n * cx.LS +
                                                    64 * s);
      mma_s8(lo[n], a[0], b.x, b.y);
      mma_s8(hi[n], a[1], b.x, b.y);
      mma_s8(lo[n], a[2], b.z, b.w);
      mma_s8(hi[n], a[3], b.z, b.w);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = nx[q];
  }
}

// O = X * Y * M^-1 (rns2_mont_mul_pair) on the tile; X, Y, O are int16
// [R][k] tiles per base.  O may alias X or Y: stage 1 reads X and Y
// element by element before writing that element of O2 (it parks s2
// there), and O1 is written after the last read of X1 and Y1.
template <int R, bool WIDE>
__device__ void mont_mul(const Tile& s, const Ctx& cx,
                         const int16_t* X1, const int16_t* X2,
                         const int16_t* Y1, const int16_t* Y2,
                         int16_t* O1, int16_t* O2, bool lazy) {
  const int k = cx.k, LS = cx.LS, G = cx.G;
  // stage 1: channel products, digit / lazy reductions, ext1 digits
  {
    const int c = cx.ec;
    const int m1 = __ldg(cx.ic1 + I_M * k + c);
    const int m2 = __ldg(cx.ic2 + I_M * k + c);
    const float f1 = __ldg(cx.f1 + c), f2 = __ldg(cx.f2 + c);
    for_each<R>(cx, [&](int r) {
      const int i = r * k + c;
      const int p1 = X1[i] * Y1[i];
      const int s1 = lazy ? red_fast(p1, m1, f1) : red_exact(p1, m1, f1);
      O2[i] = (int16_t)red_lazy(X2[i] * Y2[i], m2, f2);
      s.lhs1[r * LS + c] = (int8_t)(s1 & 127);
      s.lhs1[r * LS + k + c] = (int8_t)(s1 >> CHUNK);
    });
  }
  __syncthreads();
  // ext1, then stage 2 per channel group: sigma-form B2 result sg (into
  // O2), ext2 digits, alpha partials
  for (int cg = cx.warp; cg < G; cg += cx.nwarp) {
    int lo[R / 8][4], hi[R / 8][4];
    ext_mma<R>(cx, s.lhs1, cx.e1p, cg, lo, hi);
    int m2[2], u0s[2];
    float f2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cg * 16 + cx.g + 8 * h;
      m2[h] = __ldg(cx.ic2 + I_M * k + c);
      u0s[h] = __ldg(cx.ic2 + I2_U0S * k + c);
      f2[h] = __ldg(cx.f2 + c);
    }
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      float part[2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        const int r = 8 * n + 2 * cx.t + (j & 1);
        const int c = cg * 16 + cx.g + 8 * h;
        int hv = hi[n][j];
        if (WIDE) hv = lazy ? red_fast(hv, m2[h], f2[h])
                            : red_exact(hv, m2[h], f2[h]);
        const int v = lo[n][j] + hv * 128 + O2[r * k + c] * u0s[h];
        const int sg = lazy ? red_fast(v, m2[h], f2[h])
                            : red_exact(v, m2[h], f2[h]);
        O2[r * k + c] = (int16_t)sg;
        s.lhs2[r * LS + c] = (int8_t)(sg & 127);
        s.lhs2[r * LS + k + c] = (int8_t)(sg >> CHUNK);
        const float p = __fmul_rn(__int2float_rn(sg), f2[h]);
        if (h == 0) part[j & 1] = p;
        else part[j & 1] = __fadd_rn(part[j & 1], p);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = part[q];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (cx.g == 0) s.part[(8 * n + 2 * cx.t + q) * G + cg] = v;
      }
    }
  }
  __syncthreads();
  // alpha per row: a pairwise tree over the G <= 64 group partials
  for (int r = cx.warp; r < R; r += cx.nwarp) {
    const float* pr = s.part + r * G;
    float v = cx.lane < G ? pr[cx.lane] : 0.0f;
    if (cx.lane + 32 < G) v = __fadd_rn(v, pr[cx.lane + 32]);
    v = warp_sum(v);
    if (cx.lane == 0) s.alpha[r] = __float2int_rd(__fadd_rn(v, COX_EPS));
  }
  __syncthreads();
  // ext2, then stage 3 per channel group: B1 result into O1
  for (int cg = cx.warp; cg < G; cg += cx.nwarp) {
    int lo[R / 8][4], hi[R / 8][4];
    ext_mma<R>(cx, s.lhs2, cx.e2p, cg, lo, hi);
    int m1[2], m2m[2];
    float f1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cg * 16 + cx.g + 8 * h;
      m1[h] = __ldg(cx.ic1 + I_M * k + c);
      m2m[h] = __ldg(cx.ic1 + I1_M2M * k + c);
      f1[h] = __ldg(cx.f1 + c);
    }
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        const int r = 8 * n + 2 * cx.t + (j & 1);
        const int c = cg * 16 + cx.g + 8 * h;
        int hv = hi[n][j];
        if (WIDE) hv = lazy ? red_fast(hv, m1[h], f1[h])
                            : red_exact(hv, m1[h], f1[h]);
        const int v = lo[n][j] + hv * 128 + s.alpha[r] * m2m[h];
        O1[r * k + c] = (int16_t)(lazy ? red_lazy(v, m1[h], f1[h])
                                       : red_exact(v, m1[h], f1[h]));
      }
  }
  __syncthreads();                     // O, lhs and alpha free again
}

// rows past B read zeros and are never stored
template <int R>
__device__ __forceinline__ void load_rows(const Ctx& cx, int16_t* o1,
                                          int16_t* o2, const int* src,
                                          int row0, int B) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    const bool ok = row0 + r < B;
    const int* row = src + (size_t)(row0 + r) * 2 * k;
    o1[r * k + c] = ok ? (int16_t)row[c] : 0;
    o2[r * k + c] = ok ? (int16_t)row[k + c] : 0;
  });
}

// every row of (o1, o2) = the constant rows (r1, r2)
template <int R>
__device__ __forceinline__ void fill_rows(const Ctx& cx, int16_t* o1,
                                          int16_t* o2, const int* r1,
                                          const int* r2) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    o1[r * k + c] = (int16_t)__ldg(r1 + c);
    o2[r * k + c] = (int16_t)__ldg(r2 + c);
  });
}

template <int R>
__device__ __forceinline__ void store_rows(const Ctx& cx, int* out,
                                           const int16_t* a1,
                                           const int16_t* a2, int row0,
                                           int B) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    if (row0 + r < B) {
      int* row = out + (size_t)(row0 + r) * 2 * k;
      row[c] = a1[r * k + c];
      row[k + c] = a2[r * k + c];
    }
  });
}

// Power tables in a global int16 scratch [B', T, 2k] (B' = B rounded up
// to R); a thread reads back only the elements it wrote.
template <int R>
__device__ __forceinline__ void store_tbl(const Ctx& cx, int16_t* tb,
                                          const int16_t* a1,
                                          const int16_t* a2, int d, int T) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    int16_t* row = tb + ((size_t)r * T + d) * 2 * k;
    row[c] = a1[r * k + c];
    row[k + c] = a2[r * k + c];
  });
}

template <int R>
__device__ __forceinline__ void load_tbl(const Ctx& cx, int16_t* o1,
                                         int16_t* o2, const int16_t* tb,
                                         int d, int T) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    const int16_t* row = tb + ((size_t)r * T + d) * 2 * k;
    o1[r * k + c] = row[c];
    o2[r * k + c] = row[k + c];
  });
}

// ---------------------------------------------------------------------
// The launch rule shared by B1 and B2.  K is a kernel family: a struct
// whose `template <int R, bool WIDE, int MAXT> static const void* fn()`
// returns that instantiation of its kernel.

constexpr int MIN_BLOCKS = 64;   // k > 320: blocks wanted before a larger tile
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use

// One instantiation of a kernel with what its launch needs.
struct Launch {
  const void* fn;   // null: the tile does not fit k
  int threads;
  size_t smem;
};

template <class K, int R, bool WIDE, int MAXT>
Launch launch_of(int k) {
  return {K::template fn<R, WIDE, MAXT>(), block_threads(k, MAXT),
          smem_bytes<R>(k)};
}

// The instantiation for tiles of `rows` rows (8, 16 or 32; 32 only at
// k <= K_NARROW) at k channels per base.
template <class K>
Launch launch_for(int rows, int k) {
  const bool wide = k >= WIDE_K;
  if (rows == 32 && k <= K_NARROW && smem_bytes<32>(k) <= SMEM_MAX)
    return launch_of<K, 32, false, 640>(k);
  if (rows == 16 && smem_bytes<16>(k) <= SMEM_MAX) {
    if (!wide) return launch_of<K, 16, false, K_MAX>(k);
    return k <= WIDE_K ? launch_of<K, 16, true, WIDE_K>(k)
                       : launch_of<K, 16, true, K_MAX>(k);
  }
  if (rows == 8 && smem_bytes<8>(k) <= SMEM_MAX)
    return wide ? launch_of<K, 8, true, K_MAX>(k)
                : launch_of<K, 8, false, K_MAX>(k);
  return {nullptr, 0, 0};
}

inline cudaError_t allow_smem(const Launch& l) {
  return cudaFuncSetAttribute(
      l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
}

// Rows that one wave of `rows`-row blocks holds on the current device:
// SMs x blocks an SM keeps resident x rows (0 if the tile does not fit
// k); a negative cudaError_t if a query failed.
template <class K>
int wave_rows(int rows, int k) {
  const Launch l = launch_for<K>(rows, k);
  if (l.fn == nullptr) return 0;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(l);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.fn,
                                                        l.threads, l.smem);
  return err == cudaSuccess ? sms * per_sm * rows : -(int)err;
}

// Tile rows for a batch of B rows at k channels per base on the current
// device (the rule of the header note); a negative cudaError_t if a
// device query failed.
template <class K>
int tile_rows(int B, int k) {
  if (k > K_NARROW)
    return launch_for<K>(16, k).fn != nullptr && (B + 15) / 16 >= MIN_BLOCKS
               ? 16 : 8;
  const int tiles[3] = {8, 16, 32};
  int best = 0, best_cap = 0;
  for (int rows : tiles) {
    const int cap = wave_rows<K>(rows, k);
    if (cap < 0) return cap;
    if (cap == 0) continue;
    // fewest rows to spare in one wave that holds B (the larger tile on
    // a tie); if no wave holds B, the most rows per wave
    const bool holds = cap >= B, best_holds = best_cap >= B;
    if (best == 0 || (holds ? !best_holds || cap <= best_cap
                            : !best_holds && cap >= best_cap)) {
      best = rows;
      best_cap = cap;
    }
  }
  return best;
}

// Launch K with tiles of `rows` rows on B rows; args in the order of the
// kernel's parameters.  Returns the cudaError_t of the attribute call or
// of the launch (0 on success; cudaErrorInvalidValue for a tile that
// does not fit k).
template <class K>
int launch_tiles(int rows, int k, int B, void** args, void* stream) {
  const Launch l = launch_for<K>(rows, k);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(l);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernel(l.fn, dim3((B + rows - 1) / rows),
                               dim3(l.threads), args, l.smem,
                               (cudaStream_t)stream);
}

}  // namespace rns2mma
