// Probe P1: the product layouts of one Montgomery multiply's extensions.
//
// Replaces the v5e probe scripts/perf_dotvar.py (mk_kernel, pl.pallas_call
// at :91): `steps` steps of x' = int8(concat(v, v)) on x int8 [B, 640],
// v = (lo + (hi << 7)) & 127 summed over the layout's passes (see
// probes::Variant: split4, gap2, fused2 compute one function, wide1 half
// of its products).  On the H100 the layouts differ in how B1's fragment
// code (rns2mma::ext_mma, mma.m16n8k32 s8) walks the matrices:
//   split4  four passes, one [640, 320] half each (pass_one);
//   fused2  two passes over the packed [640, 640], lo and hi of a channel
//           in one lane: B1's base extension;
//   gap2    two passes over the padded [640, 768]: 20% more MACs, 24 warps;
//   wide1   one pass over the padded [640, 768].
// Bound: int8 MACs (B * steps * 819,200 for split4 / fused2) over the
// tensor cores' 1,979 TOP/s; the matrices stay in L2 and are re-read by
// every block at every pass, as B1 reads them.  One warp a channel group:
// 640 threads ([640, 640]) or 768 (the padded [640, 768]).

#include "probes.cuh"

namespace probes {

template <int R, int V>
__device__ __forceinline__ int8_t* run(const Ctx& cx, int8_t* b0, int8_t* b1,
                                       const int4* ep, int steps,
                                       uint32_t& junk) {
  for (int i = 0; i < steps; ++i) {
    chain_step<R, V>(cx, i & 1 ? b1 : b0, i & 1 ? b0 : b1,
                     step_ptr(ep, cx, i), cx.warp, junk);
    __syncthreads();
  }
  return steps & 1 ? b1 : b0;
}

template <int R, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
dotvar_kernel(const int8_t* __restrict__ x, const int4* __restrict__ ep,
              int8_t* __restrict__ out, int* sink, int B, int steps,
              int variant, int k) {
  extern __shared__ int4 smem[];
  int8_t* b0 = reinterpret_cast<int8_t*>(smem);
  int8_t* b1 = b0 + R * LS;
  const Ctx cx = make_ctx(k);
  const int row0 = blockIdx.x * R;
  load_i8<R>(b0, x, row0, B);
  __syncthreads();
  uint32_t junk = 0u;
  int8_t* fin;
  // one loop a layout, each with its own code; 640 threads run the
  // [640, 640] layouts, 768 the padded [640, 768]
  if constexpr (MAXT == 768)
    fin = variant == GAP2 ? run<R, GAP2>(cx, b0, b1, ep, steps, junk)
                          : run<R, WIDE1>(cx, b0, b1, ep, steps, junk);
  else
    fin = variant == SPLIT4 ? run<R, SPLIT4>(cx, b0, b1, ep, steps, junk)
                            : run<R, FUSED2>(cx, b0, b1, ep, steps, junk);
  store_i8<R>(out, fin, row0, B);
  flush_junk(sink, junk);
}

template <int R>
int launch_rows(const void* x, const void* ep, void* out, void* sink, int B,
                int steps, int variant, void* stream) {
  const bool padded = variant == GAP2 || variant == WIDE1;
  const void* fn = padded ? (const void*)dotvar_kernel<R, 768>
                          : (const void*)dotvar_kernel<R, 640>;
  int k = K;
  void* args[] = {&x, &ep, &out, &sink, &B, &steps, &variant, &k};
  return launch(fn, B, R, padded ? 768 : 640, tile_bytes<R>(), args, stream);
}

}  // namespace probes

// ep: cuda_build.pack_mma of the layout's matrix ([640, 640] for split4
// and fused2, the padded [640, 768] for gap2 and wide1); sink: null or one
// int that receives the OR of the dropped gap products.  Returns a
// cudaError_t (0 on success).
extern "C" int dotvar_launch(const void* x, const void* ep, void* out,
                             void* sink, int B, int steps, int variant,
                             int rows, void* stream) {
  using namespace probes;
  if (variant < SPLIT4 || variant > WIDE1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_rows<8>(x, ep, out, sink, B, steps, variant,
                                  stream);
    case 16: return launch_rows<16>(x, ep, out, sink, B, steps, variant,
                                    stream);
    case 32: return launch_rows<32>(x, ep, out, sink, B, steps, variant,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
