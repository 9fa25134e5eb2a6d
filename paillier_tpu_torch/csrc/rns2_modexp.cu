// Kernel B2: fixed-window RNS Montgomery ladder, shared or per-row
// exponents.
//
// Replaces paillier_tpu/bigint/pallas_rns2.py:_modexp_kernel (the Pallas
// TPU kernel behind rns2_pow_pallas).  It computes, for every row b of a
// batch, x[b]^e_b mod N on Cox-Rower RNS residues, with the exponent
// given as MSB-first base-2^w digits: one digit string for the whole
// batch (shared, digits [D]) or one per row (digits [B', D]).  The ladder
// is the one of rns2.rns2_pow_plain, multiply for multiply:
//   table = [1_M, xm, xm^2, ..., xm^(2^w - 1)], xm = x * entry, each
//           entry the previous one times xm;
//   acc = 1_M; per digit d: w squarings, then acc * table[d], d = 0
//           included;
//   exit: acc * 1 with exact (canonical) reductions.
// Every step is the Montgomery multiply of rns2_mont.cuh (the tile
// layout and the rounding rules are described there).
//
// What bounds it on an H100: the same two int8 base extensions per row
// and multiply as kernel B1 (2 * (2k)^2 multiply-adds, 2.1 M at
// k = 512), (w + 1) multiplies per digit: 5,120 for nested_add's 1,024
// digits at w = 4.  The TPU kernel kept the 2^w-entry int32 table of
// every row in VMEM and chose each row's entry with a 2^w-way masked
// select; here the table lies in a global int16 scratch [B', 2^w, 2k]
// that the wrapper allocates (a thread reads back only the channels it
// wrote), and each row loads its own entry directly: one indexed int16
// load per channel instead of 2^w selects.  Per-row digits are read from
// global memory at each step (one broadcast load per row of the tile).
//
// Launch configurations, chosen by k at launch, are B1's
// (rns2_sliding.cu): k <= 320 with __launch_bounds__(320, 2); k = 384,
// 448 with (704, 1); 512 <= k <= 704 with (704, 1) and the wide
// pre-reduction.  Windows 1..8; k a multiple of 64 (the wrapper checks
// both, and that every digit is below 2^w).

#include "rns2_mont.cuh"

namespace {

using namespace rns2;

constexpr int ROWS = 8;          // batch rows per block

template <bool WIDE, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
rns2_modexp_kernel(const int* __restrict__ x, const int* __restrict__ digits,
                   int n_digits, int per_row,
                   const int* __restrict__ ic1, const int* __restrict__ ic2,
                   const float* __restrict__ f1, const float* __restrict__ f2,
                   const int* __restrict__ e1q, const int* __restrict__ e2q,
                   int16_t* __restrict__ tbl, int* __restrict__ out,
                   int B, int k, int T, int window) {
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
  int* o1 = s.opd1;
  int* o2 = s.opd2;
  // per-row digits: row r of the tile reads dig[r * n_digits + step]
  const int* dig = per_row ? digits + (size_t)row0 * n_digits : digits;
  const int onem1 = ic1[I_ONEM * k + i], onem2 = ic2[I_ONEM * k + i];

  // table[0] = 1_M (the context row); table[1] = xm = x * entry, kept in
  // opd; table[v] = table[v-1] * xm
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    o1[r * k + i] = onem1;
    o2[r * k + i] = onem2;
  }
  store_tbl<ROWS>(tb, o1, o2, 0, T, k, i);
  load_rows<ROWS>(a1, a2, x, row0, B, k, i);
  mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k,
                       ic1 + I_ENTRY * k, ic2 + I_ENTRY * k, 0,
                       a1, a2, true, k, i);
  store_tbl<ROWS>(tb, a1, a2, 1, T, k, i);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {     // each thread copies its channel
    o1[r * k + i] = a1[r * k + i];
    o2[r * k + i] = a2[r * k + i];
  }
  for (int v = 2; v < T; ++v) {
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, o1, o2, k,
                         a1, a2, true, k, i);
    store_tbl<ROWS>(tb, a1, a2, v, T, k, i);
  }

  // acc = 1_M
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    a1[r * k + i] = onem1;
    a2[r * k + i] = onem2;
  }
  for (int step = 0; step < n_digits; ++step) {
    for (int j = 0; j < window; ++j)
      mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, a1, a2, k,
                           a1, a2, true, k, i);
    if (per_row)
      load_tbl<ROWS, true>(o1, o2, tb, dig + step, n_digits, T, k, i);
    else
      load_tbl<ROWS, false>(o1, o2, tb, dig + step, 0, T, k, i);
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, o1, o2, k,
                         a1, a2, true, k, i);
  }

  // exit multiply by 1: canonical output
  mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k,
                       ic1 + I_ONE * k, ic2 + I_ONE * k, 0,
                       a1, a2, false, k, i);
  store_rows<ROWS>(out, s, row0, B, k, i);
}

template <bool WIDE, int MAXT, int MINB>
int launch_modexp(const void* x, const void* digits, int n_digits,
                  int per_row, const void* ic1, const void* ic2,
                  const void* f1, const void* f2, const void* e1q,
                  const void* e2q, void* tbl, void* out, int B, int k,
                  int window, void* stream) {
  return launch(rns2_modexp_kernel<WIDE, MAXT, MINB>, (B + ROWS - 1) / ROWS,
                k, smem_bytes<ROWS>(k), stream,
                (const int*)x, (const int*)digits, n_digits, per_row,
                (const int*)ic1, (const int*)ic2, (const float*)f1,
                (const float*)f2, (const int*)e1q, (const int*)e2q,
                (int16_t*)tbl, (int*)out, B, k, 1 << window, window);
}

}  // namespace

extern "C" int rns2_modexp_rows() { return ROWS; }

// Launch on `stream`; returns the cudaError_t of the attribute call or
// of the launch (0 on success).  digits: int32 [D] (per_row 0) or
// [B', D] with B' = B rounded up to ROWS (per_row 1); tbl: int16
// [B', 2^window, 2k] scratch.
extern "C" int rns2_modexp_launch(const void* x, const void* digits,
                                  int n_digits, int per_row,
                                  const void* ic1, const void* ic2,
                                  const void* f1, const void* f2,
                                  const void* e1q, const void* e2q,
                                  void* tbl, void* out, int B, int k,
                                  int window, void* stream) {
#define RNS2_LAUNCH(WIDE, MAXT, MINB)                                        \
  launch_modexp<WIDE, MAXT, MINB>(x, digits, n_digits, per_row, ic1, ic2, f1, \
                                  f2, e1q, e2q, tbl, out, B, k, window, stream)
  if (k <= K_NARROW) return RNS2_LAUNCH(false, K_NARROW, 2);
  if (k < WIDE_K) return RNS2_LAUNCH(false, K_MAX, 1);
  return RNS2_LAUNCH(true, K_MAX, 1);
#undef RNS2_LAUNCH
}
