// Kernel B1: shared-exponent sliding-window RNS Montgomery ladder.
//
// Replaces paillier_tpu/bigint/pallas_rns2.py:_sliding_kernel (the
// Pallas TPU kernel behind rns2_pow_sliding_pallas).  It computes, for
// every row b of a batch, x[b]^e * fin[b] mod N on Cox-Rower RNS
// residues, with one exponent e shared by the batch and given as a
// sliding-window schedule (rns2.sliding_window_schedule): entry 0 is the
// odd-power table index of the leading window; each later entry is -2
// (skip), -1 (square) or d >= 0 (square, then multiply by table[d]).
// Every step is the tensor-core Montgomery multiply of rns2_mont_mma.cuh
// (its layout and rounding rules are described there).
//
// What bounds it on an H100: per row and per Montgomery multiply, two
// int8 base extensions [2k] x [2k, 2k], i.e. 2 * (2k)^2 multiply-adds
// (819,200 at k = 320, ~2,370 multiplies for a 2048-bit exponent), and
// per block and multiply the L2 reads of both [2k, 2k] int8 matrices
// (2 (2k)^2 bytes).  The TPU kernel held the matrices, the odd-power
// table and the accumulator in 100 MiB of VMEM; an SM has at most 227 KB
// of shared memory, so the matrices stay in L2 (packed into mma fragment
// order), the odd-power table in a global int16 scratch [B', T, 2k] that
// the wrapper allocates, and only the int16 tiles in shared memory.  The
// products run on the int8 tensor cores (mma.sync m16n8k32), and a block
// of R rows reads the matrices once per multiply, so larger tiles read
// less per row.  Measured on an H100 (700 W), a 4096-row ladder at
// k = 320 spends about a third of its time in the elementwise stages and
// their barriers and the rest in the products, where neither the L2
// reads nor the mma issue alone accounts for it; the 16-row tiles at
// k = 512 and 704 are bound by the L2 reads (PERF.md §5).
//
// Launch: rns2_sliding_rows picks R from k, B and the device by the rule
// that B1 and B2 share (rns2_mont_mma.cuh, end of its header note); the
// wrapper passes it back to rns2_sliding_launch and sizes the table
// scratch by it.  At k = 320 and 4096 rows the 32-row tiles make 128
// blocks, one wave on 132 SMs, each reading the matrices 4x less often
// than the 8-row tiles of the dp4a kernel did (105 MB per multiply).
// k is a multiple of 64 up to 704; the wrapper refuses anything else.

#include "rns2_mont_mma.cuh"

namespace {

using namespace rns2mma;

template <int R, bool WIDE, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
rns2_sliding_kernel(const int* __restrict__ x, const int* __restrict__ fin,
                    const int* __restrict__ sched, int n_steps,
                    const int* __restrict__ ic1, const int* __restrict__ ic2,
                    const float* __restrict__ f1, const float* __restrict__ f2,
                    const int4* __restrict__ e1p, const int4* __restrict__ e2p,
                    int16_t* __restrict__ tbl, int* __restrict__ out,
                    int B, int k, int T) {
  extern __shared__ int4 smem_raw[];
  Tile s;
  Ctx cx;
  setup<R>(s, cx, smem_raw, k);
  cx.ic1 = ic1; cx.ic2 = ic2; cx.f1 = f1; cx.f2 = f2;
  cx.e1p = e1p; cx.e2p = e2p;
  const int row0 = blockIdx.x * R;
  int16_t* tb = tbl + (size_t)row0 * T * 2 * k;
  int16_t* a1 = s.acc1;
  int16_t* a2 = s.acc2;

  // xm = x * entry (to Montgomery form); table[0] = xm
  load_rows<R>(cx, a1, a2, x, row0, B);
  fill_rows<R>(cx, s.opd1, s.opd2, ic1 + I_ENTRY * k, ic2 + I_ENTRY * k);
  mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, true);
  store_tbl<R>(cx, tb, a1, a2, 0, T);
  // opd = xm^2; table[v] = table[v-1] * xm^2
  mont_mul<R, WIDE>(s, cx, a1, a2, a1, a2, s.opd1, s.opd2, true);
  for (int v = 1; v < T; ++v) {
    mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, true);
    store_tbl<R>(cx, tb, a1, a2, v, T);
  }

  load_tbl<R>(cx, a1, a2, tb, sched[0], T);
  for (int step = 1; step <= n_steps; ++step) {
    const int d = sched[step];         // uniform across the block
    if (d >= -1)
      mont_mul<R, WIDE>(s, cx, a1, a2, a1, a2, a1, a2, true);
    if (d >= 0) {
      load_tbl<R>(cx, s.opd1, s.opd2, tb, d, T);
      mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, true);
    }
  }

  // exit multiply: by fin (fused G^m) or by 1; canonical output
  if (fin != nullptr)
    load_rows<R>(cx, s.opd1, s.opd2, fin, row0, B);
  else
    fill_rows<R>(cx, s.opd1, s.opd2, ic1 + I_ONE * k, ic2 + I_ONE * k);
  mont_mul<R, WIDE>(s, cx, a1, a2, s.opd1, s.opd2, a1, a2, false);
  store_rows<R>(cx, out, a1, a2, row0, B);
}

struct SlidingKernel {
  template <int R, bool WIDE, int MAXT>
  static const void* fn() {
    return (const void*)rns2_sliding_kernel<R, WIDE, MAXT>;
  }
};

}  // namespace

// Tile rows for a batch of B rows at k channels per base on the current
// device; a negative cudaError_t if a device query failed.
extern "C" int rns2_sliding_rows(int B, int k) {
  return tile_rows<SlidingKernel>(B, k);
}

// Launch on `stream` with tiles of `rows` rows (8, 16 or 32; 32 only at
// k <= 320); returns the cudaError_t of the attribute call or of the
// launch (0 on success; cudaErrorInvalidValue for a tile that does not
// fit k).  fin may be null (exit multiply by 1).  k must be a multiple of
// 64 up to K_MAX (the wrapper checks).
extern "C" int rns2_sliding_launch(const void* x, const void* fin,
                                   const void* sched, int n_steps,
                                   const void* ic1, const void* ic2,
                                   const void* f1, const void* f2,
                                   const void* e1p, const void* e2p,
                                   void* tbl, void* out, int B, int k,
                                   int window, int rows, void* stream) {
  int T = 1 << (window - 1);
  // in the order of rns2_sliding_kernel's parameters
  void* args[] = {&x, &fin, &sched, &n_steps, &ic1, &ic2, &f1, &f2, &e1p,
                  &e2p, &tbl, &out, &B, &k, &T};
  return launch_tiles<SlidingKernel>(rows, k, B, args, stream);
}
