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
// Every step is kernel B1's Montgomery multiply on int8 tensor cores
// (rns2_mont_mma.cuh: tile layout, rounding rules, and the launch rule
// that both kernels share).
//
// What bounds it on an H100: the same two int8 base extensions per row
// and multiply as kernel B1 (2 * (2k)^2 multiply-adds, 2.1 M at
// k = 512), (w + 1) multiplies per digit: 5,120 for nested_add's 1,024
// digits at w = 4; and per block and multiply the L2 reads of both
// [2k, 2k] int8 matrices, which the 32-row tiles read 4x less often than
// the 8-row tiles of the dp4a kernel this one replaced.  The TPU kernel
// kept the 2^w-entry int32 table of every row in VMEM and chose each
// row's entry with a 2^w-way masked select; here the table lies in a
// global int16 scratch [B', 2^w, 2k] that the wrapper allocates (B' = B
// rounded up to the tile), and each row copies its own entry into the
// operand tile with 16-byte cp.async: one direct indexed load instead of
// 2^w selects.  At k = 320 and 4096 rows the scratch is 84 MB, more than
// the L2, so each digit fetches ~5.2 MB from device memory; the copy is
// issued before the digit's w squarings (which do not touch the operand
// tile) and awaited only before its table multiply, so its latency
// hides behind them.
//
// Windows 1..8; k a multiple of 64 up to 704 (the wrapper checks both,
// and that every digit is below 2^w).

#include "rns2_mont_mma.cuh"

namespace {

using namespace rns2mma;

// every row of (o1, o2) = the same rows of (a1, a2)
template <int R>
__device__ __forceinline__ void copy_rows(const Ctx& cx, int16_t* o1,
                                          int16_t* o2, const int16_t* a1,
                                          const int16_t* a2) {
  const int k = cx.k, c = cx.ec;
  for_each<R>(cx, [&](int r) {
    o1[r * k + c] = a1[r * k + c];
    o2[r * k + c] = a2[r * k + c];
  });
}

template <int R, bool WIDE, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
rns2_modexp_kernel(const int* __restrict__ x, const int* __restrict__ digits,
                   int n_digits, int per_row,
                   const int* __restrict__ ic1, const int* __restrict__ ic2,
                   const float* __restrict__ f1, const float* __restrict__ f2,
                   const int4* __restrict__ e1p, const int4* __restrict__ e2p,
                   int16_t* __restrict__ tbl, int* __restrict__ out,
                   int B, int k, int window) {
  extern __shared__ int4 smem_raw[];
  Tile s;
  Ctx cx;
  setup<R>(s, cx, smem_raw, k);
  cx.ic1 = ic1; cx.ic2 = ic2; cx.f1 = f1; cx.f2 = f2;
  cx.e1p = e1p; cx.e2p = e2p;
  const int T = 1 << window;
  const int row0 = blockIdx.x * R;
  int16_t* tb = tbl + (size_t)row0 * T * 2 * k;
  int16_t* a1 = s.acc1;
  int16_t* a2 = s.acc2;
  int16_t* o1 = s.opd1;
  int16_t* o2 = s.opd2;
  // per-row digits: row r of the tile reads dig[r * n_digits + step]
  const int* dig = per_row ? digits + (size_t)row0 * n_digits : digits;
  const int ds = per_row ? n_digits : 0;

  // table[0] = 1_M; table[1] = xm = x * entry, kept in opd;
  // table[v] = table[v-1] * xm
  fill_rows<R>(cx, o1, o2, ic1 + I_ONEM * k, ic2 + I_ONEM * k);
  store_tbl<R>(cx, tb, o1, o2, 0, T);
  load_rows<R>(cx, a1, a2, x, row0, B);
  fill_rows<R>(cx, o1, o2, ic1 + I_ENTRY * k, ic2 + I_ENTRY * k);
  mont_mul<R, WIDE>(s, cx, a1, a2, o1, o2, a1, a2, true);
  store_tbl<R>(cx, tb, a1, a2, 1, T);
  copy_rows<R>(cx, o1, o2, a1, a2);
  for (int v = 2; v < T; ++v) {
    mont_mul<R, WIDE>(s, cx, a1, a2, o1, o2, a1, a2, true);
    store_tbl<R>(cx, tb, a1, a2, v, T);
  }

  // acc = 1_M; the table's stores are visible to the whole block after
  // the barrier, so any thread may copy any entry back
  fill_rows<R>(cx, a1, a2, ic1 + I_ONEM * k, ic2 + I_ONEM * k);
  __syncthreads();
  for (int step = 0; step < n_digits; ++step) {
    tbl_fetch<R>(cx, o1, o2, tb, T, dig + step, ds);
    for (int j = 0; j < window; ++j)
      mont_mul<R, WIDE>(s, cx, a1, a2, a1, a2, a1, a2, true);
    tbl_wait();
    mont_mul<R, WIDE>(s, cx, a1, a2, o1, o2, a1, a2, true);
  }

  // exit multiply by 1: canonical output
  fill_rows<R>(cx, o1, o2, ic1 + I_ONE * k, ic2 + I_ONE * k);
  mont_mul<R, WIDE>(s, cx, a1, a2, o1, o2, a1, a2, false);
  store_rows<R>(cx, out, a1, a2, row0, B);
}

struct ModexpKernel {
  template <int R, bool WIDE, int MAXT>
  static const void* fn() {
    return (const void*)rns2_modexp_kernel<R, WIDE, MAXT>;
  }
};

}  // namespace

// Tile rows for a batch of B rows at k channels per base on the current
// device (the rule B1 and B2 share); a negative cudaError_t if a device
// query failed.
extern "C" int rns2_modexp_rows(int B, int k) {
  return tile_rows<ModexpKernel>(B, k);
}

// Launch on `stream` with tiles of `rows` rows (8, 16 or 32; 32 only at
// k <= 320); returns the cudaError_t of the attribute call or of the
// launch (0 on success; cudaErrorInvalidValue for a tile that does not
// fit k).  digits: int32 [D] (per_row 0) or [B', D] with B' = B rounded
// up to `rows` (per_row 1); tbl: int16 [B', 2^window, 2k] scratch; e1p,
// e2p: the pack_mma matrices.
extern "C" int rns2_modexp_launch(const void* x, const void* digits,
                                  int n_digits, int per_row,
                                  const void* ic1, const void* ic2,
                                  const void* f1, const void* f2,
                                  const void* e1p, const void* e2p,
                                  void* tbl, void* out, int B, int k,
                                  int window, int rows, void* stream) {
  // in the order of rns2_modexp_kernel's parameters
  void* args[] = {&x, &digits, &n_digits, &per_row, &ic1, &ic2, &f1, &f2,
                  &e1p, &e2p, &tbl, &out, &B, &k, &window};
  return launch_tiles<ModexpKernel>(rows, k, B, args, stream);
}
