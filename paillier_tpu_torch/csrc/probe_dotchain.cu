// Probe P2: the latency of a dependent chain of tensor-core products.
//
// Replaces the v5e probe scripts/perf_dotchain.py (kernel, pl.pallas_call
// at :47): `steps` steps of two dependent extensions on x int8 [B, 640],
// each x' = int8(concat(v, v)) with v = (x mlo + x mhi) & 127, i.e. one
// ext_mma pass of B1's fragment code over the packed [mlo | mhi] (640 x
// 640) and one __syncthreads.  Every product of a step waits for the one
// before it, so at one block an SM (132 R rows) nothing hides the chain's
// latency; B = 512 is the script's shape.  Bound: int8 MACs (B * steps *
// 819,200) over 1,979 TOP/s.  640 threads, a warp per 16-channel group.

#include "probes.cuh"

namespace probes {

template <int R>
__global__ void __launch_bounds__(640, 1)
dotchain_kernel(const int8_t* __restrict__ x, const int4* __restrict__ ep,
                int8_t* __restrict__ out, int B, int steps, int k) {
  extern __shared__ int4 smem[];
  int8_t* b0 = reinterpret_cast<int8_t*>(smem);
  int8_t* b1 = b0 + R * LS;
  const Ctx cx = make_ctx(k);
  const int row0 = blockIdx.x * R;
  load_i8<R>(b0, x, row0, B);
  __syncthreads();
  uint32_t junk = 0u;            // stays 0: every group is a real channel
  for (int i = 0; i < steps; ++i) {
    const int4* e = step_ptr(ep, cx, i);
    chain_step<R, CHAIN>(cx, b0, b1, e, cx.warp, junk);
    __syncthreads();
    chain_step<R, CHAIN>(cx, b1, b0, e, cx.warp, junk);
    __syncthreads();
  }
  store_i8<R>(out, b0, row0, B);
}

template <int R>
int launch_rows(const void* x, const void* ep, void* out, int B, int steps,
                void* stream) {
  int k = K;
  void* args[] = {&x, &ep, &out, &B, &steps, &k};
  return launch((const void*)dotchain_kernel<R>, B, R, 640, tile_bytes<R>(),
                args, stream);
}

}  // namespace probes

// ep: cuda_build.pack_mma of [mlo | mhi] (640 x 640).  Returns a
// cudaError_t (0 on success).
extern "C" int dotchain_launch(const void* x, const void* ep, void* out,
                               int B, int steps, int rows, void* stream) {
  using namespace probes;
  switch (rows) {
    case 8: return launch_rows<8>(x, ep, out, B, steps, stream);
    case 16: return launch_rows<16>(x, ep, out, B, steps, stream);
    case 32: return launch_rows<32>(x, ep, out, B, steps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
