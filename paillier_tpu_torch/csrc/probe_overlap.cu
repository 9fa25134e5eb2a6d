// Probe P3: do the tensor-core products and the elementwise reductions
// overlap when the same warps of one block issue both?
//
// Replaces the v5e probe scripts/perf_overlap.py (k_dots, k_vpu, k_both,
// pl.pallas_call at :89).  `steps` steps of one or both of two
// independent chains on a tile of R rows:
//   dots  x' = int8(concat(v, v)), v = (x mlo + x mhi + x mlo + x mhi)
//         & 127: two ext_mma passes of B1's fragment code over the packed
//         [mlo | mhi], x int8 [B, 640] in shared memory (chain_step DOTS);
//   vpu   three passes of t = y * 12345, q = floor(f32(t) * inv),
//         y = t - q m, two conditional corrections, on y int32 [B, 320]
//         held in registers (a thread owns one channel of R / 2 rows).
// mode: 1 dots, 2 vpu, 3 both in one loop body; the chain that does not
// run passes its input through.  If `both` takes about max(dots, vpu) the
// two overlap; about their sum, they share issue slots.  Rounding as B1's
// reductions: __int2float_rn, __fmul_rn, __float2int_rd (no fast math);
// int32 products wrap, so they are computed in uint32.  Bound: dots'
// int8 MACs over 1,979 TOP/s against vpu's instructions (9 a pass at
// least) over 132 SMs x 128 lanes x 1.98 GHz (the larger for both).

#include "probes.cuh"

namespace probes {

__device__ __forceinline__ int vpu_pass3(int y, int m, float inv) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int t = (int)((uint32_t)y * 12345u);
    const int q = __float2int_rd(__fmul_rn(__int2float_rn(t), inv));
    y = (int)((uint32_t)t - (uint32_t)q * (uint32_t)m);
    y = y < 0 ? y + m : y;
    y = y >= m ? y - m : y;
  }
  return y;
}

template <int R>
__global__ void __launch_bounds__(640, 1)
overlap_kernel(const int8_t* __restrict__ x, const int4* __restrict__ ep,
               const int* __restrict__ y, const int* __restrict__ m,
               const float* __restrict__ inv, int8_t* __restrict__ o,
               int* __restrict__ p, int B, int steps, int mode, int k) {
  extern __shared__ int4 smem[];
  int8_t* b0 = reinterpret_cast<int8_t*>(smem);
  int8_t* b1 = b0 + R * LS;
  const Ctx cx = make_ctx(k);
  const int row0 = blockIdx.x * R;
  const int c = threadIdx.x % K, r0 = threadIdx.x / K;   // vpu: rows r0 + 2i
  const bool dots = mode & 1, vpu = mode & 2;
  load_i8<R>(b0, x, row0, B);
  int yv[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int r = row0 + r0 + 2 * i;
    yv[i] = r < B ? __ldg(y + (size_t)r * K + c) : 0;
  }
  const int mc = __ldg(m + c);
  const float ic = __ldg(inv + c);
  __syncthreads();
  uint32_t junk = 0u;            // stays 0: every group is a real channel
  for (int s = 0; s < steps; ++s) {
    if (dots)
      chain_step<R, DOTS>(cx, s & 1 ? b1 : b0, s & 1 ? b0 : b1,
                          step_ptr(ep, cx, s), cx.warp, junk);
    if (vpu) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) yv[i] = vpu_pass3(yv[i], mc, ic);
    }
    if (dots) __syncthreads();
  }
  store_i8<R>(o, dots && (steps & 1) ? b1 : b0, row0, B);
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int r = row0 + r0 + 2 * i;
    if (r < B) p[(size_t)r * K + c] = yv[i];
  }
}

template <int R>
int launch_rows(void** args, int B, void* stream) {
  return launch((const void*)overlap_kernel<R>, B, R, 640, tile_bytes<R>(),
                args, stream);
}

}  // namespace probes

// ep: cuda_build.pack_mma of [mlo | mhi]; y int32 [B, 320]; m int32 [320]
// and inv f32 [320] (the script's moduli row and 1 / f32(m), shared by
// every row).  Returns a cudaError_t (0 on success).
extern "C" int overlap_launch(const void* x, const void* ep, const void* y,
                              const void* m, const void* inv, void* o,
                              void* p, int B, int steps, int mode, int rows,
                              void* stream) {
  using namespace probes;
  if (mode < 1 || mode > 3) return (int)cudaErrorInvalidValue;
  int k = K;
  void* args[] = {&x, &ep, &y, &m, &inv, &o, &p, &B, &steps, &mode, &k};
  switch (rows) {
    case 8: return launch_rows<8>(args, B, stream);
    case 16: return launch_rows<16>(args, B, stream);
    case 32: return launch_rows<32>(args, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
