// Kernel B1: shared-exponent sliding-window RNS Montgomery ladder.
//
// Replaces paillier_tpu/bigint/pallas_rns2.py:_sliding_kernel (the
// Pallas TPU kernel behind rns2_pow_sliding_pallas).  It computes, for
// every row b of a batch, x[b]^e * fin[b] mod N on Cox-Rower RNS
// residues, with one exponent e shared by the batch and given as a
// sliding-window schedule (rns2.sliding_window_schedule): entry 0 is the
// odd-power table index of the leading window; each later entry is -2
// (skip), -1 (square) or d >= 0 (square, then multiply by table[d]).
// Every step is the Montgomery multiply of rns2.rns2_mont_mul_pair, and
// the arithmetic matches the plain torch version bit for bit:
//   _red       q = floor(f32(v) * inv_m), two conditional fixes
//   _red_lazy  the same q, no fixes
//   _red_fast  q = trunc(f32(v - 420) * inv_m)
//   cox alpha  floor(sum(f32(sg) * inv_m') + 0.05)
// Conversions are __int2float_rn, products __fmul_rn (no FMA
// contraction can reach a quotient), floors __float2int_rd, truncations
// __float2int_rz.  Build without --use_fast_math.
//
// What bounds it on an H100: per row and per Montgomery multiply, two
// int8 base extensions [2k] x [2k, 2k], i.e. 2 * (2k)^2 multiply-adds
// (819,200 at k = 320, ~2,360 multiplies for a 2048-bit exponent), plus
// the reads of both [2k, 2k] int8 matrices (2 x 400 KB at k = 320).
// The TPU kernel held the matrices, the odd-power table and the
// accumulator in 100 MiB of VMEM; an SM has at most 227 KB of shared
// memory, so this layout is:
//   * both extension matrices in global memory, repacked by the wrapper
//     as int32 words of 4 consecutive rows ([2k/4, 2k]) for __dp4a; all
//     blocks read the same 800 KB, which stays resident in the 50 MB L2;
//   * the odd-power table in a global int16 scratch [B', T, 2k] that the
//     wrapper allocates (B' = B rounded up to ROWS); each thread only
//     ever reads back the channels it wrote;
//   * one block per tile of ROWS rows with k threads: thread i owns
//     channel i of both bases, so every elementwise stage is private to
//     a thread and the accumulator / operand tiles sit in shared memory
//     without synchronisation.  Only the packed int8 digit rows (read by
//     all threads in the products) and the cox alpha sums are shared.
// Each matrix word loaded from L2 feeds ROWS __dp4a per column, and
// each 16-byte digit load from shared memory feeds 8.  Tensor-core
// (mma/wgmma) products, TMA and a table resident in shared memory are
// later work.
//
// The cox alpha row sums are pairwise trees: a warp shuffle tree over
// the 32 lanes, then a shuffle tree over the (k/32 <= 10) warp sums.
// Their f32 error stays far below the 2e-3 the spec's COX_EPS check
// assumes (a 320-term sequential sum would not be guaranteed to).
//
// Occupancy: __launch_bounds__(320, 2) holds a thread to 96 registers
// (no spills), so two blocks of k = 320 threads share an SM.  Without
// the second bound ptxas used 128 registers, one block fit per SM, and
// a 4096-row ladder at k = 320 took 307 ms instead of 208 ms (H100 SXM,
// 700 W; tiles of 4 or 16 rows were slower or spilled).
//
// Supported: k a multiple of 64 up to 320 (every level-1 spec up to
// 2048-bit keys: k = 320 mod n^2, k = 192 mod p^2 / q^2).  Wider specs,
// including the k >= 512 pre-reduction branch of rns2._mm_lhs2, are not
// implemented; the wrapper refuses such contexts.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ROWS = 8;          // batch rows per block
constexpr int CHUNK = 7;
constexpr int RED_BIAS = 420;    // rns2.RED_BIAS_INT
constexpr float COX_EPS = 0.05f; // rns2.COX_EPS

// context rows (rns2.I1_* / rns2.I2_*)
constexpr int I_M = 0;
constexpr int I1_M2M = 1;
constexpr int I2_U0S = 1;
constexpr int I_ENTRY = 2;
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

struct Chan {        // per-thread channel constants
  int m1, m2m, m2, u0s;
  float f1, f2;
};

struct Shared {      // views into the block's dynamic shared memory
  int* acc1; int* acc2;     // accumulator tile [ROWS][k]
  int* opd1; int* opd2;     // second operand tile [ROWS][k]
  int8_t* lhs;              // packed digit rows [ROWS][2k]
  float* wsum;              // per-warp alpha partials [ROWS][32]
  float* rowsum;            // alpha sums [ROWS]
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// out[r][c] for c = i (lo column) and c = k + i (hi column), over the
// tile's ROWS packed digit rows: lhs [ROWS][2k] int8 against
// E [2k, 2k] int8 stored as Eq [2k/4][2k] int32 words.
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

// Per-row block sums of part[r] into s.rowsum[r] (pairwise trees).
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
  ext_product(s.lhs, e1q, k, i, lo, hi);
  __syncthreads();                     // every thread is done with lhs
  // stage 2: sigma-form B2 result sg, ext2 lhs, alpha terms
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = lo[r] + hi[r] * 128 + s2[r] * ch.u0s;
    sg[r] = lazy ? red_fast(t, ch.m2, ch.f2) : red_exact(t, ch.m2, ch.f2);
    s.lhs[r * C + i] = (int8_t)(sg[r] & 127);
    s.lhs[r * C + k + i] = (int8_t)(sg[r] >> CHUNK);
    part[r] = __fmul_rn(__int2float_rn(sg[r]), ch.f2);
  }
  row_sums(s, part, k, i);             // syncs: lhs and rowsum visible
  ext_product(s.lhs, e2q, k, i, lo, hi);
  // stage 3: combine ext2 + cox alpha -> B1 result
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int alpha = __float2int_rd(__fadd_rn(s.rowsum[r], COX_EPS));
    const int v = lo[r] + hi[r] * 128 + alpha * ch.m2m;
    O1[r * k + i] = lazy ? red_lazy(v, ch.m1, ch.f1)
                         : red_exact(v, ch.m1, ch.f1);
    O2[r * k + i] = sg[r];
  }
  __syncthreads();                     // lhs / rowsum free for the next one
}

__device__ __forceinline__ void store_tbl(int16_t* tb, const Shared& s,
                                          int d, int T, int k, int i) {
  const int C = 2 * k;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int16_t* row = tb + ((size_t)r * T + d) * C;
    row[i] = (int16_t)s.acc1[r * k + i];
    row[k + i] = (int16_t)s.acc2[r * k + i];
  }
}

__device__ __forceinline__ void load_tbl(int* o1, int* o2, const int16_t* tb,
                                         int d, int T, int k, int i) {
  const int C = 2 * k;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int16_t* row = tb + ((size_t)r * T + d) * C;
    o1[r * k + i] = row[i];
    o2[r * k + i] = row[k + i];
  }
}

// rows past B read zeros and are never stored
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

__global__ void __launch_bounds__(320, 2)
rns2_sliding_kernel(const int* __restrict__ x, const int* __restrict__ fin,
                    const int* __restrict__ sched, int n_steps,
                    const int* __restrict__ ic1, const int* __restrict__ ic2,
                    const float* __restrict__ f1, const float* __restrict__ f2,
                    const int* __restrict__ e1q, const int* __restrict__ e2q,
                    int16_t* __restrict__ tbl, int* __restrict__ out,
                    int B, int k, int T) {
  extern __shared__ int4 smem_raw[];
  const int i = threadIdx.x;
  const int C = 2 * k;
  const int row0 = blockIdx.x * ROWS;
  Shared s;
  s.acc1 = reinterpret_cast<int*>(smem_raw);
  s.acc2 = s.acc1 + ROWS * k;
  s.opd1 = s.acc2 + ROWS * k;
  s.opd2 = s.opd1 + ROWS * k;
  s.lhs = reinterpret_cast<int8_t*>(s.opd2 + ROWS * k);   // 16B aligned
  s.wsum = reinterpret_cast<float*>(s.lhs + ROWS * C);
  s.rowsum = s.wsum + ROWS * 32;

  Chan ch;
  ch.m1 = ic1[I_M * k + i];
  ch.m2m = ic1[I1_M2M * k + i];
  ch.m2 = ic2[I_M * k + i];
  ch.u0s = ic2[I2_U0S * k + i];
  ch.f1 = f1[i];
  ch.f2 = f2[i];
  int16_t* tb = tbl + (size_t)row0 * T * C;

  // xm = x * entry (to Montgomery form); table[0] = xm
  load_rows(s.acc1, s.acc2, x, row0, B, k, i);
  mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k,
           ic1 + I_ENTRY * k, ic2 + I_ENTRY * k, 0,
           s.acc1, s.acc2, true, k, i);
  store_tbl(tb, s, 0, T, k, i);
  // opd = xm^2; table[v] = table[v-1] * xm^2
  mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k, s.acc1, s.acc2, k,
           s.opd1, s.opd2, true, k, i);
  for (int v = 1; v < T; ++v) {
    mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k, s.opd1, s.opd2, k,
             s.acc1, s.acc2, true, k, i);
    store_tbl(tb, s, v, T, k, i);
  }

  load_tbl(s.acc1, s.acc2, tb, sched[0], T, k, i);
  for (int step = 1; step <= n_steps; ++step) {
    const int d = sched[step];         // uniform across the block
    if (d >= -1)
      mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k, s.acc1, s.acc2, k,
               s.acc1, s.acc2, true, k, i);
    if (d >= 0) {
      load_tbl(s.opd1, s.opd2, tb, d, T, k, i);
      mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k, s.opd1, s.opd2, k,
               s.acc1, s.acc2, true, k, i);
    }
  }

  // exit multiply: by fin (fused G^m) or by 1; canonical output
  if (fin != nullptr) {
    load_rows(s.opd1, s.opd2, fin, row0, B, k, i);
    mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k, s.opd1, s.opd2, k,
             s.acc1, s.acc2, false, k, i);
  } else {
    mont_mul(s, ch, e1q, e2q, s.acc1, s.acc2, k,
             ic1 + I_ONE * k, ic2 + I_ONE * k, 0,
             s.acc1, s.acc2, false, k, i);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r < B) {
      out[(size_t)(row0 + r) * C + i] = s.acc1[r * k + i];
      out[(size_t)(row0 + r) * C + k + i] = s.acc2[r * k + i];
    }
  }
}

}  // namespace

extern "C" int rns2_sliding_rows() { return ROWS; }

// Launch on `stream`; returns the cudaError_t of the attribute call or
// of the launch (0 on success).  fin may be null (exit multiply by 1).
extern "C" int rns2_sliding_launch(const void* x, const void* fin,
                                   const void* sched, int n_steps,
                                   const void* ic1, const void* ic2,
                                   const void* f1, const void* f2,
                                   const void* e1q, const void* e2q,
                                   void* tbl, void* out, int B, int k,
                                   int window, void* stream) {
  const int T = 1 << (window - 1);
  const size_t smem = (size_t)4 * ROWS * k * sizeof(int)   // acc, opd
                      + (size_t)ROWS * 2 * k               // lhs
                      + (size_t)ROWS * 32 * sizeof(float)  // wsum
                      + (size_t)ROWS * sizeof(float);      // rowsum
  cudaError_t err = cudaFuncSetAttribute(
      rns2_sliding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + ROWS - 1) / ROWS;
  rns2_sliding_kernel<<<grid, k, smem, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)fin, (const int*)sched, n_steps,
      (const int*)ic1, (const int*)ic2, (const float*)f1, (const float*)f2,
      (const int*)e1q, (const int*)e2q, (int16_t*)tbl, (int*)out, B, k, T);
  return (int)cudaGetLastError();
}
