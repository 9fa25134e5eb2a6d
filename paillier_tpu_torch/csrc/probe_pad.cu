// Probe P4: the L2 read rate of the extension matrices, and a column
// permutation.
//
// Replaces the v5e probe scripts/perf_pad.py: bench_dots' `kern`
// (pl.pallas_call at :87) and bench_roll's `kern_roll` / `kern_base`
// (:129).
//
// pad_kernel: `steps` chained products acc' = (int8(acc) W) & 63 of
// acc int32 [B, 640] and W int8 [640, lanes] (lanes 768, 640 or 384),
// fed back at 640 columns: columns past 640 dropped, columns past `lanes`
// zero.  B1's fragment code (ext_mma) runs on W packed as lo | hi halves
// of lanes / 2 columns, a warp per 16-column group of a half (lanes / 32
// warps), and every block reads all of W at every step, as B1 reads its
// matrices: ceil(B / R) * 640 * lanes bytes a step.  With LD = LoadNC
// (__ldg, B1's loads) some of those reads may hit in L1, so bytes over
// time is the rate the blocks ask for; with LD = LoadL2 (ld.global.cg)
// every load is an L2 read, so it is the L2's read rate.  Bound: the
// int8 MACs the function needs (640 x min(lanes, 640) a row and step:
// the columns past 640 are dropped) over 1,979 TOP/s, or the bytes of
// acc, the used columns of W and the output over 3.35 TB/s.
//
// roll_kernel: 32 steps of acc' = (acc + roll(acc, 320, 1)) & 0xFFFF
// (roll != 0) against acc' = (acc + acc) & 0xFFFF (roll == 0) on int32
// [B, 640].  A thread holds one column of 8 rows in registers; the roll
// moves each value to the thread 320 columns on through shared memory
// (a store, a barrier, a load, a barrier a step), which is its cost.

#include "probes.cuh"

namespace probes {

template <int R, int MAXT, typename LD>
__global__ void __launch_bounds__(MAXT, 1)
pad_kernel(const int* __restrict__ x, const int4* __restrict__ ep,
           int* __restrict__ out, int* sink, int B, int lanes, int steps,
           int k) {
  extern __shared__ int4 smem[];
  int8_t* b0 = reinterpret_cast<int8_t*>(smem);
  int8_t* b1 = b0 + R * LS;
  const Ctx cx = make_ctx(k);
  const int row0 = blockIdx.x * R;
  const int half = lanes / 2;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    b0[r * LS + c] = row0 + r < B ? (int8_t)__ldg(x + (size_t)(row0 + r) * D
                                                  + c) : 0;
  }
  __syncthreads();
  uint32_t junk = 0u;
  const int cg = cx.warp;
  for (int s = 0; s < steps; ++s) {
    const int8_t* cur = s & 1 ? b1 : b0;
    int8_t* nxt = s & 1 ? b0 : b1;
    int lo[R / 8][4], hi[R / 8][4];
    ext_mma<R, LD>(cx, cur, step_ptr(ep, cx, s), cg, lo, hi);
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = frag_row(cx, n, j), c = frag_col(cx, cg, j);
        nxt[r * LS + c] = (int8_t)(lo[n][j] & 63);
        if (half + c < D) nxt[r * LS + half + c] = (int8_t)(hi[n][j] & 63);
        else junk |= (uint32_t)hi[n][j];
      }
    for (int i = threadIdx.x; i < R * (D - lanes); i += blockDim.x)
      nxt[(i / (D - lanes)) * LS + lanes + i % (D - lanes)] = 0;
    __syncthreads();
  }
  const int8_t* fin = steps & 1 ? b1 : b0;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    if (row0 + r < B) out[(size_t)(row0 + r) * D + c] = fin[r * LS + c];
  }
  flush_junk(sink, junk);
}

constexpr int ROLL_ROWS = 8;     // rows of a roll block (640 threads)

__global__ void __launch_bounds__(D)
roll_kernel(const int* __restrict__ x, int* __restrict__ out, int B,
            int steps, int roll) {
  __shared__ int sh[ROLL_ROWS][D];
  const int c = threadIdx.x, row0 = blockIdx.x * ROLL_ROWS;
  int a[ROLL_ROWS];
#pragma unroll
  for (int r = 0; r < ROLL_ROWS; ++r)
    a[r] = row0 + r < B ? __ldg(x + (size_t)(row0 + r) * D + c) : 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (roll) {
#pragma unroll
      for (int r = 0; r < ROLL_ROWS; ++r) sh[r][c] = a[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < ROLL_ROWS; ++r)
        a[r] = (int)(((uint32_t)a[r] + (uint32_t)sh[r][(c + K) % D]) &
                     0xFFFFu);
      __syncthreads();
    } else {
#pragma unroll
      for (int r = 0; r < ROLL_ROWS; ++r) {
        a[r] = (int)(((uint32_t)a[r] + (uint32_t)a[r]) & 0xFFFFu);
        asm volatile("mov.b32 %0, %0;" : "+r"(a[r]));   // no folding
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROLL_ROWS; ++r)
    if (row0 + r < B) out[(size_t)(row0 + r) * D + c] = a[r];
}

template <int R, typename LD>
int launch_rows(void** args, int B, int lanes, void* stream) {
  const void* fn = lanes > D ? (const void*)pad_kernel<R, 768, LD>
                             : (const void*)pad_kernel<R, 640, LD>;
  return launch(fn, B, R, lanes / 32 * 32, tile_bytes<R>(), args, stream);
}

template <typename LD>
int launch_tile(void** args, int B, int lanes, int rows, void* stream) {
  switch (rows) {
    case 8: return launch_rows<8, LD>(args, B, lanes, stream);
    case 16: return launch_rows<16, LD>(args, B, lanes, stream);
    case 32: return launch_rows<32, LD>(args, B, lanes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace probes

// x int32 [B, 640]; ep: cuda_build.pack_mma of W int8 [640, lanes]; sink:
// null or one int that receives the OR of the dropped products (columns
// past 640); l2_only: load W with ld.global.cg (L2 only) instead of
// __ldg.  Returns a cudaError_t (0 on success).
extern "C" int pad_launch(const void* x, const void* ep, void* out,
                          void* sink, int B, int lanes, int steps, int rows,
                          int l2_only, void* stream) {
  using namespace probes;
  if (lanes % 64 || lanes < 64 || lanes > 768 || steps < 1)
    return (int)cudaErrorInvalidValue;
  int k = K;
  void* args[] = {&x, &ep, &out, &sink, &B, &lanes, &steps, &k};
  return l2_only ? launch_tile<rns2mma::LoadL2>(args, B, lanes, rows, stream)
                 : launch_tile<rns2mma::LoadNC>(args, B, lanes, rows, stream);
}

extern "C" int roll_launch(const void* x, void* out, int B, int steps,
                           int roll, void* stream) {
  using namespace probes;
  void* args[] = {&x, &out, &B, &steps, &roll};
  return launch((const void*)roll_kernel, B, ROLL_ROWS, D, 0, args, stream);
}
