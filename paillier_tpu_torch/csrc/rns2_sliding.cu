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
// Launch (rns2_sliding_rows picks R from k, B and the device; the wrapper
// passes it back to rns2_sliding_launch and sizes the table scratch by
// it).  Instantiations:
//   R = 32  k <= 320 only; __launch_bounds__(640, 1), 2k threads (a warp
//           per 16-channel group; 20 warps at k = 320); 129,664 bytes of
//           shared memory at k = 320.  4096 rows are 128 blocks, one wave
//           on 132 SMs, each reading the matrices 4x less often than the
//           8-row tiles of the dp4a kernel did (105 MB per multiply at
//           k = 320).
//   R = 16  __launch_bounds__(704, 1): 2k threads up to k = 320, else k
//           (a warp per two groups); at k = 512 __launch_bounds__(512, 1),
//           which gives a thread 128 registers instead of 80 and was 9%
//           faster.
//   R = 8   __launch_bounds__(704, 1).
// Rule, from every tile timed at 512-8192 rows (k = 192, 320) and
// 256-4096 rows (k = 512, 704) on an H100 (PERF.md §6,
// scripts/ab_sliding.py):
//   k <= 320: a block takes about as long whatever the grid (k = 320:
//     ~27 ms at 8 rows, ~34 at 16, ~41 at 32 for e = n), so the time is
//     the number of waves times a block's time.  A wave of R-row tiles
//     holds SMs x (blocks an SM keeps resident, from the occupancy API)
//     x R rows; take the tile whose one wave holds B with the fewest rows
//     to spare (the larger tile on a tie: at k = 192, two resident 16-row
//     blocks were slower than one 32-row block), and if no wave holds B
//     the one with the most rows per wave.  On an H100 at k = 320: 8 rows
//     up to 1056, 16 up to 2112, then 32; at k = 192: 8 up to 2112, then
//     32.
//   k > 320: the L2 reads of the matrices bind, so fewer blocks win: the
//     largest tile whose grid keeps MIN_BLOCKS = 64 blocks (at 1024 rows,
//     64 blocks of 16 rows beat 128 blocks of 8).
// k is a multiple of 64 up to 704; the wrapper refuses anything else.

#include "rns2_mont_mma.cuh"

namespace {

using namespace rns2mma;

constexpr int MIN_BLOCKS = 64;   // k > 320: blocks wanted before a larger tile
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use

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

// One instantiation of the kernel with what its launch needs.
struct Launch {
  const void* fn;   // null: the tile does not fit k
  int threads;
  size_t smem;
};

template <int R, bool WIDE, int MAXT>
Launch launch_of(int k) {
  return {(const void*)rns2_sliding_kernel<R, WIDE, MAXT>,
          block_threads(k, MAXT), smem_bytes<R>(k)};
}

// The instantiation for tiles of `rows` rows (8, 16 or 32; 32 only at
// k <= K_NARROW) at k channels per base.
Launch launch_for(int rows, int k) {
  const bool wide = k >= WIDE_K;
  if (rows == 32 && k <= K_NARROW && smem_bytes<32>(k) <= SMEM_MAX)
    return launch_of<32, false, 640>(k);
  if (rows == 16 && smem_bytes<16>(k) <= SMEM_MAX) {
    if (!wide) return launch_of<16, false, K_MAX>(k);
    return k <= WIDE_K ? launch_of<16, true, WIDE_K>(k)
                       : launch_of<16, true, K_MAX>(k);
  }
  if (rows == 8 && smem_bytes<8>(k) <= SMEM_MAX)
    return wide ? launch_of<8, true, K_MAX>(k) : launch_of<8, false, K_MAX>(k);
  return {nullptr, 0, 0};
}

cudaError_t allow_smem(const Launch& l) {
  return cudaFuncSetAttribute(
      l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
}

// Rows that one wave of `rows`-row blocks holds on the current device:
// SMs x blocks an SM keeps resident x rows (0 if the tile does not fit
// k); a negative cudaError_t if a query failed.
int wave_rows(int rows, int k) {
  const Launch l = launch_for(rows, k);
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

}  // namespace

// Tile rows for a batch of B rows at k channels per base on the current
// device (the rule of the header note); a negative cudaError_t if a
// device query failed.
extern "C" int rns2_sliding_rows(int B, int k) {
  if (k > K_NARROW)
    return launch_for(16, k).fn != nullptr && (B + 15) / 16 >= MIN_BLOCKS
               ? 16 : 8;
  const int tiles[3] = {8, 16, 32};
  int best = 0, best_cap = 0;
  for (int rows : tiles) {
    const int cap = wave_rows(rows, k);
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
  const Launch l = launch_for(rows, k);
  if (l.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(l);
  if (err != cudaSuccess) return (int)err;
  int T = 1 << (window - 1);
  // in the order of rns2_sliding_kernel's parameters
  void* args[] = {&x, &fin, &sched, &n_steps, &ic1, &ic2, &f1, &f2, &e1p,
                  &e2p, &tbl, &out, &B, &k, &T};
  return (int)cudaLaunchKernel(l.fn, dim3((B + rows - 1) / rows),
                               dim3(l.threads), args, l.smem,
                               (cudaStream_t)stream);
}
