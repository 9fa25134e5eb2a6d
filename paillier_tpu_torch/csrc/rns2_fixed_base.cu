// Kernel B3: fixed-base comb RNS Montgomery ladder, per-row exponents.
//
// Replaces paillier_tpu/bigint/pallas_rns2.py:_fixed_base_kernel (the
// Pallas TPU kernel behind rns2_pow_fixed_base_pallas).  It computes, for
// every row b of a batch, base^e_b * fin_b mod N on Cox-Rower RNS
// residues, where the base is fixed (alternative encryption's h_s) and
// its comb table T[step * 2^w + d] = base^(d * 2^(w (D-1-step))) * M
// (rns2.build_fixed_base_table, Montgomery form, canonical) is shared by
// the batch; e_b is given as D MSB-first base-2^w digits per row.  The
// ladder is the one of rns2.rns2_pow_fixed_base_plain, multiply for
// multiply:
//   acc = T[0][d_0]; for j = 1 .. D-1: acc = acc * T[j][d_j] (lazy);
//   exit: acc * fin (or * 1) with exact (canonical) reductions.
// No squarings: D multiplies in all (256 for r < 2^1024 at w = 4).  Every
// step is the Montgomery multiply of rns2_mont.cuh (the tile layout and
// the rounding rules are described there).
//
// What bounds it on an H100: as for B1 and B2, two int8 base extensions
// per row and multiply, 2 * (2k)^2 multiply-adds (819,200 at k = 320),
// against the two [2k, 2k] int8 matrices read from L2.  The TPU kernel
// held the table chunked as int8 in VMEM and gathered each row's entry
// with a one-hot [rows, 2^w] x [2^w, 4q] matmul, because the TPU has no
// cheap dynamic gather.  Here the table stays int16 in global memory
// ([D * 2^w, 2k]: 5.2 MB at k = 320, 8.4 MB at k = 512, resident in the
// 50 MB L2) and each row's digit indexes its own entry directly: one
// int16 load per channel and row per step.  The digits [B', D] are read
// from global memory, one broadcast load per row of the tile and step.
//
// Launch configurations, chosen by k at launch, are B1's
// (rns2_sliding.cu): k <= 320 with __launch_bounds__(320, 2); k = 384,
// 448 with (704, 1); 512 <= k <= 704 with (704, 1) and the wide
// pre-reduction.  k a multiple of 64; the wrapper checks it, the window
// and that every digit is below 2^w.

#include "rns2_mont.cuh"

namespace {

using namespace rns2;

constexpr int ROWS = 8;          // batch rows per block

// Each row r of the tile loads comb entry (step, dig[r * D + step]).
__device__ __forceinline__ void load_comb(int* o1, int* o2,
                                          const int16_t* __restrict__ tbl,
                                          const int* __restrict__ dig,
                                          int step, int D, int T, int k,
                                          int i) {
  const int C = 2 * k;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int d = dig[r * D + step];
    const int16_t* row = tbl + ((size_t)step * T + d) * C;
    o1[r * k + i] = __ldg(row + i);
    o2[r * k + i] = __ldg(row + k + i);
  }
}

template <bool WIDE, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
rns2_fixed_base_kernel(const int16_t* __restrict__ tbl,
                       const int* __restrict__ digits, int n_digits,
                       const int* __restrict__ fin,
                       const int* __restrict__ ic1, const int* __restrict__ ic2,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const int* __restrict__ e1q, const int* __restrict__ e2q,
                       int* __restrict__ out, int B, int k, int T) {
  extern __shared__ int4 smem_raw[];
  const int i = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  Shared s;
  Chan ch;
  setup<ROWS>(s, ch, smem_raw, ic1, ic2, f1, f2, k, i);
  int* a1 = s.acc1;
  int* a2 = s.acc2;
  const int* dig = digits + (size_t)row0 * n_digits;

  load_comb(a1, a2, tbl, dig, 0, n_digits, T, k, i);
  for (int step = 1; step < n_digits; ++step) {
    load_comb(s.opd1, s.opd2, tbl, dig, step, n_digits, T, k, i);
    mont_mul<ROWS, WIDE>(s, ch, e1q, e2q, a1, a2, k, s.opd1, s.opd2, k,
                         a1, a2, true, k, i);
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
int launch_fixed_base(const void* tbl, const void* digits, int n_digits,
                      const void* fin, const void* ic1, const void* ic2,
                      const void* f1, const void* f2, const void* e1q,
                      const void* e2q, void* out, int B, int k, int window,
                      void* stream) {
  return launch(rns2_fixed_base_kernel<WIDE, MAXT, MINB>,
                (B + ROWS - 1) / ROWS, k, smem_bytes<ROWS>(k), stream,
                (const int16_t*)tbl, (const int*)digits, n_digits,
                (const int*)fin, (const int*)ic1, (const int*)ic2,
                (const float*)f1, (const float*)f2, (const int*)e1q,
                (const int*)e2q, (int*)out, B, k, 1 << window);
}

}  // namespace

extern "C" int rns2_fixed_base_rows() { return ROWS; }

// Launch on `stream`; returns the cudaError_t of the attribute call or
// of the launch (0 on success).  tbl: int16 [D * 2^window, 2k]; digits:
// int32 [B', D] with B' = B rounded up to ROWS (pad rows hold valid
// digits and are not stored); fin: int32 [B, 2k] or null (exit multiply
// by 1).
extern "C" int rns2_fixed_base_launch(const void* tbl, const void* digits,
                                      int n_digits, const void* fin,
                                      const void* ic1, const void* ic2,
                                      const void* f1, const void* f2,
                                      const void* e1q, const void* e2q,
                                      void* out, int B, int k, int window,
                                      void* stream) {
#define RNS2_LAUNCH(WIDE, MAXT, MINB)                                     \
  launch_fixed_base<WIDE, MAXT, MINB>(tbl, digits, n_digits, fin, ic1,    \
                                      ic2, f1, f2, e1q, e2q, out, B, k,   \
                                      window, stream)
  if (k <= K_NARROW) return RNS2_LAUNCH(false, K_NARROW, 2);
  if (k < WIDE_K) return RNS2_LAUNCH(false, K_MAX, 1);
  return RNS2_LAUNCH(true, K_MAX, 1);
#undef RNS2_LAUNCH
}
