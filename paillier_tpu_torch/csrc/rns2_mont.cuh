// The Cox-Rower RNS Montgomery multiply on __dp4a, used by kernel B3
// (rns2_fixed_base.cu); its reductions and constants also serve the
// tensor-core multiply of kernels B1 and B2 (rns2_mont_mma.cuh).
//
// It is rns2.rns2_mont_mul_pair on a tile of ROWS batch rows, and the
// arithmetic matches the plain torch version bit for bit:
//   _red       q = floor(f32(v) * inv_m), two conditional fixes
//   _red_lazy  the same q, no fixes
//   _red_fast  q = trunc(f32(v - 420) * inv_m)
//   cox alpha  floor(sum(f32(sg) * inv_m') + 0.05)
// Conversions are __int2float_rn, products __fmul_rn (no FMA
// contraction can reach a quotient), floors __float2int_rd, truncations
// __float2int_rz.  Build without --use_fast_math.
//
// Layout: one block per tile of ROWS rows with k threads; thread i owns
// channel i of both bases, so every elementwise stage is private to a
// thread and the accumulator / operand tiles sit in shared memory
// without synchronisation.  Only the packed int8 digit rows (read by all
// threads in the products) and the cox alpha sums are shared.  The two
// base extensions are __dp4a products against the [2k, 2k] int8
// matrices, which the wrappers repack as int32 words of 4 consecutive
// rows ([2k/4, 2k]) and which stay in L2 (2 x 400 KB at k = 320, 2 x
// 2 MB at k = 704).  Each matrix word loaded feeds ROWS __dp4a per
// column, and each 16-byte digit load from shared memory feeds 8.
//
// The cox alpha row sums are pairwise trees: a warp shuffle tree over
// the 32 lanes, then a shuffle tree over the k/32 <= 22 warp sums.
// Their f32 error stays far below the 2e-3 the spec's COX_EPS check
// assumes (a sequential sum of up to 704 terms would not be guaranteed
// to).
//
// Wide specs (WIDE, k >= 512: n^3 of a 2048-bit key, n^2 of a 4096-bit
// key): lo + (hi << 7) of an extension product can exceed int32, so the
// hi column sum is reduced first, by _red_fast in a lazy multiply and by
// _red in the final one, exactly where rns2._mm_lhs2 / _mm_finish do it.
// Narrower specs (k <= 448) must not pre-reduce: the plain version
// gates on k >= 512, and so do the kernels' launchers.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace rns2 {

constexpr int CHUNK = 7;
constexpr int RED_BIAS = 420;    // rns2.RED_BIAS_INT
constexpr float COX_EPS = 0.05f; // rns2.COX_EPS
constexpr int WIDE_K = 512;      // k from which the hi product is pre-reduced
constexpr int K_NARROW = 320;    // block size bound of the two-blocks-per-SM build
constexpr int K_MAX = 704;       // largest k a kernel takes (22 warps)

// context rows (rns2.I1_* / rns2.I2_*)
constexpr int I_M = 0;
constexpr int I1_M2M = 1;
constexpr int I2_U0S = 1;
constexpr int I_ENTRY = 2;
constexpr int I_ONEM = 3;
constexpr int I_ONE = 4;

__device__ __forceinline__ int quot_floor(int v, float inv) {
  return __float2int_rd(__fmul_rn(__int2float_rn(v), inv));
}

__device__ __forceinline__ int red_exact(int v, int m, float inv) {
  int r = v - quot_floor(v, inv) * m;
  r = r < 0 ? r + m : r;
  return r >= m ? r - m : r;
}

__device__ __forceinline__ int red_lazy(int v, int m, float inv) {
  return v - quot_floor(v, inv) * m;
}

__device__ __forceinline__ int red_fast(int v, int m, float inv) {
  return v - __float2int_rz(__fmul_rn(__int2float_rn(v - RED_BIAS), inv)) * m;
}

struct Shared {      // views into the block's dynamic shared memory
  int* acc1; int* acc2;     // accumulator tile [ROWS][k]
  int* opd1; int* opd2;     // second operand tile [ROWS][k]
  int8_t* lhs;              // packed digit rows [ROWS][2k]
  float* wsum;              // per-warp alpha partials [ROWS][32]
  float* rowsum;            // alpha sums [ROWS]
};

// Dynamic shared memory of one block: 4 * ROWS * k * 4 + ROWS * 2k +
// ROWS * 33 * 4 bytes (102,432 at ROWS = 8, k = 704).
template <int ROWS>
inline size_t smem_bytes(int k) {
  return (size_t)4 * ROWS * k * sizeof(int)    // acc, opd
         + (size_t)ROWS * 2 * k                 // lhs
         + (size_t)ROWS * 32 * sizeof(float)    // wsum
         + (size_t)ROWS * sizeof(float);        // rowsum
}

struct Chan {        // per-thread channel constants
  int m1, m2m, m2, u0s;
  float f1, f2;
};

// Fill the block's shared-memory views and thread i's channel constants
// in place.  (Returning them as const values instead cost 24 bytes of
// spills at k = 320 and made kernel B1 5% slower on an H100.)
template <int ROWS>
__device__ __forceinline__ void setup(Shared& s, Chan& ch, int4* smem_raw,
                                      const int* __restrict__ ic1,
                                      const int* __restrict__ ic2,
                                      const float* __restrict__ f1,
                                      const float* __restrict__ f2,
                                      int k, int i) {
  s.acc1 = reinterpret_cast<int*>(smem_raw);
  s.acc2 = s.acc1 + ROWS * k;
  s.opd1 = s.acc2 + ROWS * k;
  s.opd2 = s.opd1 + ROWS * k;
  s.lhs = reinterpret_cast<int8_t*>(s.opd2 + ROWS * k);   // 16B aligned
  s.wsum = reinterpret_cast<float*>(s.lhs + ROWS * 2 * k);
  s.rowsum = s.wsum + ROWS * 32;
  ch.m1 = ic1[I_M * k + i];
  ch.m2m = ic1[I1_M2M * k + i];
  ch.m2 = ic2[I_M * k + i];
  ch.u0s = ic2[I2_U0S * k + i];
  ch.f1 = f1[i];
  ch.f2 = f2[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// out[r][c] for c = i (lo column) and c = k + i (hi column), over the
// tile's ROWS packed digit rows: lhs [ROWS][2k] int8 against
// E [2k, 2k] int8 stored as Eq [2k/4][2k] int32 words.
template <int ROWS>
__device__ __forceinline__ void ext_product(const int8_t* lhs,
                                            const int* __restrict__ Eq,
                                            int k, int i,
                                            int (&lo)[ROWS], int (&hi)[ROWS]) {
  const int C = 2 * k;
  const int n16 = C / 16;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { lo[r] = 0; hi[r] = 0; }
  const int4* L4 = reinterpret_cast<const int4*>(lhs);
  for (int c16 = 0; c16 < n16; ++c16) {
    int el[4], eh[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int* row = Eq + (size_t)(4 * c16 + t) * C;
      el[t] = __ldg(row + i);
      eh[t] = __ldg(row + k + i);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int4 l = L4[r * n16 + c16];
      int a = lo[r], b = hi[r];
      a = __dp4a(l.x, el[0], a); b = __dp4a(l.x, eh[0], b);
      a = __dp4a(l.y, el[1], a); b = __dp4a(l.y, eh[1], b);
      a = __dp4a(l.z, el[2], a); b = __dp4a(l.z, eh[2], b);
      a = __dp4a(l.w, el[3], a); b = __dp4a(l.w, eh[3], b);
      lo[r] = a; hi[r] = b;
    }
  }
}

// Per-row block sums of part[r] into s.rowsum[r] (pairwise trees); at
// most 32 warps.
template <int ROWS>
__device__ __forceinline__ void row_sums(const Shared& s, float (&part)[ROWS],
                                         int k, int i) {
  const int lane = i & 31, warp = i >> 5, nw = k >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float w = warp_sum(part[r]);
    if (lane == 0) s.wsum[r * 32 + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = warp_sum(lane < nw ? s.wsum[r * 32 + lane] : 0.0f);
      if (lane == 0) s.rowsum[r] = v;
    }
  }
  __syncthreads();
}

// O = X * Y * M^-1 (rns2_mont_mul_pair) on the tile; X, Y, O are
// [ROWS][k] B1 / B2 halves with row strides xs, ys (0: one constant row
// for all rows), k.  O may alias X or Y: thread i reads channel i of X
// and Y before it writes channel i of O, and no other thread touches it.
template <int ROWS, bool WIDE>
__device__ void mont_mul(const Shared& s, const Chan& ch,
                         const int* __restrict__ e1q,
                         const int* __restrict__ e2q,
                         const int* X1, const int* X2, int xs,
                         const int* Y1, const int* Y2, int ys,
                         int* O1, int* O2, bool lazy, int k, int i) {
  const int C = 2 * k;
  int s2[ROWS], sg[ROWS];
  float part[ROWS];
  // stage 1: channel products, digit / lazy reductions, ext1 lhs
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int p1 = X1[r * xs + i] * Y1[r * ys + i];
    const int s1 = lazy ? red_fast(p1, ch.m1, ch.f1)
                        : red_exact(p1, ch.m1, ch.f1);
    s2[r] = red_lazy(X2[r * xs + i] * Y2[r * ys + i], ch.m2, ch.f2);
    s.lhs[r * C + i] = (int8_t)(s1 & 127);
    s.lhs[r * C + k + i] = (int8_t)(s1 >> CHUNK);
  }
  __syncthreads();
  int lo[ROWS], hi[ROWS];
  ext_product<ROWS>(s.lhs, e1q, k, i, lo, hi);
  __syncthreads();                     // every thread is done with lhs
  // stage 2: sigma-form B2 result sg, ext2 lhs, alpha terms
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int h = hi[r];
    if (WIDE) h = lazy ? red_fast(h, ch.m2, ch.f2) : red_exact(h, ch.m2, ch.f2);
    const int t = lo[r] + h * 128 + s2[r] * ch.u0s;
    sg[r] = lazy ? red_fast(t, ch.m2, ch.f2) : red_exact(t, ch.m2, ch.f2);
    s.lhs[r * C + i] = (int8_t)(sg[r] & 127);
    s.lhs[r * C + k + i] = (int8_t)(sg[r] >> CHUNK);
    part[r] = __fmul_rn(__int2float_rn(sg[r]), ch.f2);
  }
  row_sums<ROWS>(s, part, k, i);       // syncs: lhs and rowsum visible
  ext_product<ROWS>(s.lhs, e2q, k, i, lo, hi);
  // stage 3: combine ext2 + cox alpha -> B1 result
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int h = hi[r];
    if (WIDE) h = lazy ? red_fast(h, ch.m1, ch.f1) : red_exact(h, ch.m1, ch.f1);
    const int alpha = __float2int_rd(__fadd_rn(s.rowsum[r], COX_EPS));
    const int v = lo[r] + h * 128 + alpha * ch.m2m;
    O1[r * k + i] = lazy ? red_lazy(v, ch.m1, ch.f1)
                         : red_exact(v, ch.m1, ch.f1);
    O2[r * k + i] = sg[r];
  }
  __syncthreads();                     // lhs / rowsum free for the next one
}

// rows past B read zeros and are never stored
template <int ROWS>
__device__ __forceinline__ void load_rows(int* o1, int* o2, const int* src,
                                          int row0, int B, int k, int i) {
  const int C = 2 * k;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool ok = row0 + r < B;
    o1[r * k + i] = ok ? src[(size_t)(row0 + r) * C + i] : 0;
    o2[r * k + i] = ok ? src[(size_t)(row0 + r) * C + k + i] : 0;
  }
}

template <int ROWS>
__device__ __forceinline__ void store_rows(int* out, const Shared& s,
                                           int row0, int B, int k, int i) {
  const int C = 2 * k;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r < B) {
      out[(size_t)(row0 + r) * C + i] = s.acc1[r * k + i];
      out[(size_t)(row0 + r) * C + k + i] = s.acc2[r * k + i];
    }
  }
}

// Launch one instantiation of a ladder kernel: set its shared-memory
// limit, launch, and return the cudaError_t (0 on success).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, int grid, int k, size_t smem,
                  void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, k, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace rns2
