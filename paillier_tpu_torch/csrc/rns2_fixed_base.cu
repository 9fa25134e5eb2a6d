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
// step is kernel B1's Montgomery multiply on int8 tensor cores
// (rns2_mont_mma.cuh: tile layout, rounding rules, and the launch rule
// that B1, B2 and B3 share).
//
// What bounds it on an H100: as for B1 and B2, two int8 base extensions
// per row and multiply, 2 * (2k)^2 multiply-adds (819,200 at k = 320),
// and per block and multiply the L2 reads of both [2k, 2k] int8
// matrices, which the 32-row tiles read 4x less often than the 8-row
// tiles of the dp4a kernel this one replaced.  The TPU kernel held the
// table chunked as int8 in VMEM and gathered each row's entry with a
// one-hot [rows, 2^w] x [2^w, 4q] matmul, because the TPU has no cheap
// dynamic gather.  Here the table stays int16 in global memory
// ([D * 2^w, 2k]: 5.2 MB at k = 320, 8.4 MB at k = 512, resident in the
// 50 MB L2) and each tile row copies its own entry T[step][d] into an
// operand tile with 16-byte cp.async (tbl_fetch, as B2 copies its power
// table entries): 4k bytes a row and step, 5% of the matrix reads at
// R = 32.  Step 0 is copied straight into the accumulator.  The comb has
// no squarings to hide a copy behind, and each copy is awaited right
// after it is issued: on an H100 a second operand tile, filled one step
// ahead, bought nothing measurable (PERF.md §6).  So the block is B1's
// and B2's, and so is its tile rule.
//
// k a multiple of 64 up to 704; the wrapper checks it, the window and
// that every digit is below 2^w.

#include "rns2_mont_mma.cuh"

namespace {

using namespace rns2mma;

template <int R, bool WIDE, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
rns2_fixed_base_kernel(const int16_t* __restrict__ tbl,
                       const int* __restrict__ digits, int n_digits,
                       const int* __restrict__ fin,
                       const int* __restrict__ ic1, const int* __restrict__ ic2,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const int4* __restrict__ e1p,
                       const int4* __restrict__ e2p,
                       int* __restrict__ out, int B, int k, int T) {
  extern __shared__ int4 smem_raw[];
  Tile s;
  Ctx cx;
  setup<R>(s, cx, smem_raw, k);
  cx.ic1 = ic1; cx.ic2 = ic2; cx.f1 = f1; cx.f2 = f2;
  cx.e1p = e1p; cx.e2p = e2p;
  const int row0 = blockIdx.x * R;
  const int D = n_digits;
  // row r of the tile reads dig[r * D + step]
  const int* dig = digits + (size_t)row0 * D;
  const size_t step_len = (size_t)T * 2 * k;   // int16 of one step's entries
  int16_t* a1 = s.acc1;
  int16_t* a2 = s.acc2;

  tbl_fetch<R>(cx, a1, a2, tbl, 0, dig, D);
  tbl_wait();
  for (int j = 1; j < D; ++j) {
    // mont_mul has read its operand tile before it returns
    tbl_fetch<R>(cx, s.opd1, s.opd2, tbl + j * step_len, 0, dig + j, D);
    tbl_wait();
    mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, true);
  }

  // exit multiply: by fin (fused G^m) or by 1; canonical output
  if (fin != nullptr)
    load_rows<R>(cx, s.opd1, s.opd2, fin, row0, B);
  else
    fill_rows<R>(cx, s.opd1, s.opd2, ic1 + I_ONE * k, ic2 + I_ONE * k);
  mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, false);
  store_rows<R>(cx, out, a1, a2, row0, B);
}

struct FixedBaseKernel {
  template <int R, bool WIDE, int MAXT>
  static const void* fn() {
    return (const void*)rns2_fixed_base_kernel<R, WIDE, MAXT>;
  }
};

}  // namespace

// Tile rows for a batch of B rows at k channels per base on the current
// device (the rule B1, B2 and B3 share); a negative cudaError_t if a
// device query failed.
extern "C" int rns2_fixed_base_rows(int B, int k) {
  return tile_rows<FixedBaseKernel>(B, k);
}

// Launch on `stream` with tiles of `rows` rows (8, 16 or 32; 32 only at
// k <= 320); returns the cudaError_t of the attribute call or of the
// launch (0 on success; cudaErrorInvalidValue for a tile that does not
// fit k).  tbl: int16 [D * 2^window, 2k]; digits: int32 [B', D] with
// B' = B rounded up to `rows` (pad rows hold valid digits and are not
// stored); fin: int32 [B, 2k] or null (exit multiply by 1); e1p, e2p:
// the pack_mma matrices.
extern "C" int rns2_fixed_base_launch(const void* tbl, const void* digits,
                                      int n_digits, const void* fin,
                                      const void* ic1, const void* ic2,
                                      const void* f1, const void* f2,
                                      const void* e1p, const void* e2p,
                                      void* out, int B, int k, int window,
                                      int rows, void* stream) {
  int T = 1 << window;
  // in the order of rns2_fixed_base_kernel's parameters
  void* args[] = {&tbl, &digits, &n_digits, &fin, &ic1, &ic2, &f1, &f2,
                  &e1p, &e2p, &out, &B, &k, &T};
  return launch_tiles<FixedBaseKernel>(rows, k, B, args, stream);
}
