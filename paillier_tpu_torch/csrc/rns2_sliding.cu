// Kernel B1: shared-exponent sliding-window RNS Montgomery ladder.
//
// Replaces paillier_tpu/bigint/pallas_rns2.py:_sliding_kernel (the
// Pallas TPU kernel behind rns2_pow_sliding_pallas).  It computes, for
// every row b of a batch, x[b]^e * fin[b] mod N on Cox-Rower RNS
// residues, with one exponent e shared by the batch and given as a
// sliding-window schedule (rns2.sliding_window_schedule): entry 0 is the
// odd-power table index of the leading window; each later entry is -2
// (skip), -1 (square) or d >= 0 (square, then multiply by table[d]).
// Every step is the Montgomery multiply of rns2_mont.cuh (the tile
// layout and the rounding rules are described there).
//
// What bounds it on an H100: per row and per Montgomery multiply, two
// int8 base extensions [2k] x [2k, 2k], i.e. 2 * (2k)^2 multiply-adds
// (819,200 at k = 320, ~2,360 multiplies for a 2048-bit exponent), plus
// the reads of both [2k, 2k] int8 matrices.  The TPU kernel held the
// matrices, the odd-power table and the accumulator in 100 MiB of VMEM;
// an SM has at most 227 KB of shared memory, so this layout keeps the
// matrices in L2 (rns2_mont.cuh), the odd-power table in a global int16
// scratch [B', T, 2k] that the wrapper allocates, and only the tiles in
// shared memory.  Tensor-core (mma/wgmma) products, TMA and a table
// resident in shared memory are later work.
//
// Launch configurations, chosen by k at launch:
//   k <= 320        ROWS = 8, __launch_bounds__(320, 2): 96 registers a
//                   thread (no spills), two blocks share an SM.  Without
//                   the second bound ptxas used 128 registers, one block
//                   fit per SM, and a 4096-row ladder at k = 320 took
//                   307 ms instead of 208 ms (H100 SXM, 700 W; tiles of
//                   4 or 16 rows were slower or spilled).
//   320 < k < 512   ROWS = 8, __launch_bounds__(704, 1), no pre-reduction
//                   (k = 384 and 448).
//   512 <= k <= 704 ROWS = 8, __launch_bounds__(704, 1) and the wide
//                   pre-reduction (n^3 of a 2048-bit key at k = 512, n^2
//                   of a 4096-bit key at k = 704): one block of up to 22
//                   warps per SM; ptxas holds a thread to 80 registers
//                   (164 B of spill stores, 804 B of spill loads); shared
//                   memory 102 KB at k = 704.  Measured on an H100
//                   (700 W): at k = 512 this beat __launch_bounds__(512,
//                   1) (128 registers, no spills: 255 vs 268 ms for B1,
//                   273 vs 325 ms for B2 at 1024 rows), and tiles of 4
//                   rows lost at full load (k = 704, 1056 rows: 93 vs
//                   60 ms).
// k is a multiple of 64; the wrapper refuses anything else.

#include "rns2_mont.cuh"

namespace {

using namespace rns2;

constexpr int ROWS = 8;          // batch rows per block

template <bool WIDE, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
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
  Chan ch;
  setup<ROWS>(s, ch, smem_raw, ic1, ic2, f1, f2, k, i);
  int16_t* tb = tbl + (size_t)row0 * T * C;
  int* a1 = s.acc1;
  int* a2 = s.acc2;

  // xm = x * entry (to Montgomery form); table[0] = xm
  load_rows<ROWS>(a1, a2, x, row0, B, k, i);
  mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k,
                       ic1 + I_ENTRY * k, ic2 + I_ENTRY * k, 0,
                       a1, a2, true, k, i);
  store_tbl<ROWS>(tb, a1, a2, 0, T, k, i);
  // opd = xm^2; table[v] = table[v-1] * xm^2
  mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, a1, a2, k,
                       s.opd1, s.opd2, true, k, i);
  for (int v = 1; v < T; ++v) {
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, s.opd1, s.opd2, k,
                         a1, a2, true, k, i);
    store_tbl<ROWS>(tb, a1, a2, v, T, k, i);
  }

  load_tbl<ROWS, false>(a1, a2, tb, sched, 0, T, k, i);
  for (int step = 1; step <= n_steps; ++step) {
    const int d = sched[step];         // uniform across the block
    if (d >= -1)
      mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, a1, a2, k,
                           a1, a2, true, k, i);
    if (d >= 0) {
      load_tbl<ROWS, false>(s.opd1, s.opd2, tb, sched + step, 0, T, k, i);
      mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, s.opd1, s.opd2, k,
                           a1, a2, true, k, i);
    }
  }

  // exit multiply: by fin (fused G^m) or by 1; canonical output
  if (fin != nullptr) {
    load_rows<ROWS>(s.opd1, s.opd2, fin, row0, B, k, i);
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, s.opd1, s.opd2, k,
                         a1, a2, false, k, i);
  } else {
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k,
                         ic1 + I_ONE * k, ic2 + I_ONE * k, 0,
                         a1, a2, false, k, i);
  }
  store_rows<ROWS>(out, s, row0, B, k, i);
}

template <bool WIDE, int MAXT, int MINB>
int launch_sliding(const void* x, const void* fin, const void* sched,
                   int n_steps, const void* ic1, const void* ic2,
                   const void* f1, const void* f2, const void* e1q,
                   const void* e2q, void* tbl, void* out, int B, int k,
                   int T, void* stream) {
  return launch(rns2_sliding_kernel<WIDE, MAXT, MINB>, (B + ROWS - 1) / ROWS,
                k, smem_bytes<ROWS>(k), stream,
                (const int*)x, (const int*)fin, (const int*)sched, n_steps,
                (const int*)ic1, (const int*)ic2, (const float*)f1,
                (const float*)f2, (const int*)e1q, (const int*)e2q,
                (int16_t*)tbl, (int*)out, B, k, T);
}

}  // namespace

extern "C" int rns2_sliding_rows() { return ROWS; }

// Launch on `stream`; returns the cudaError_t of the attribute call or
// of the launch (0 on success).  fin may be null (exit multiply by 1).
// k must be a multiple of 64 up to K_MAX (the wrapper checks).
extern "C" int rns2_sliding_launch(const void* x, const void* fin,
                                   const void* sched, int n_steps,
                                   const void* ic1, const void* ic2,
                                   const void* f1, const void* f2,
                                   const void* e1q, const void* e2q,
                                   void* tbl, void* out, int B, int k,
                                   int window, void* stream) {
  const int T = 1 << (window - 1);
#define RNS2_LAUNCH(WIDE, MAXT, MINB)                                        \
  launch_sliding<WIDE, MAXT, MINB>(x, fin, sched, n_steps, ic1, ic2, f1, f2, \
                                   e1q, e2q, tbl, out, B, k, T, stream)
  if (k <= K_NARROW) return RNS2_LAUNCH(false, K_NARROW, 2);
  if (k < WIDE_K) return RNS2_LAUNCH(false, K_MAX, 1);
  return RNS2_LAUNCH(true, K_MAX, 1);
#undef RNS2_LAUNCH
}
