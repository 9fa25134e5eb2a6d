// Constants and channel reductions of the Cox-Rower RNS Montgomery
// multiply on int8 tensor cores (rns2_mont_mma.cuh), which kernels B1,
// B2 and B3 run.
//
// The arithmetic matches the plain torch version (rns2.rns2_mont_mul_pair)
// bit for bit:
//   _red       q = floor(f32(v) * inv_m), two conditional fixes
//   _red_lazy  the same q, no fixes
//   _red_fast  q = trunc(f32(v - 420) * inv_m)
//   cox alpha  floor(sum(f32(sg) * inv_m') + 0.05)
// Conversions are __int2float_rn, products __fmul_rn (no FMA
// contraction can reach a quotient), floors __float2int_rd, truncations
// __float2int_rz.  Build without --use_fast_math.
//
// Wide specs (WIDE, k >= 512: n^3 of a 2048-bit key, n^2 of a 4096-bit
// key): lo + (hi << 7) of an extension product can exceed int32, so the
// hi column sum is reduced first, by _red_fast in a lazy multiply and by
// _red in the final one, exactly where rns2._mm_lhs2 / _mm_finish do it.
// Narrower specs (k <= 448) must not pre-reduce: the plain version
// gates on k >= 512, and so do the kernels' launchers.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace rns2 {

constexpr int CHUNK = 7;
constexpr int RED_BIAS = 420;    // rns2.RED_BIAS_INT
constexpr float COX_EPS = 0.05f; // rns2.COX_EPS
constexpr int WIDE_K = 512;      // k from which the hi product is pre-reduced
constexpr int K_NARROW = 320;    // largest k of the 32-row tiles (640 threads)
constexpr int K_MAX = 704;       // largest k a kernel takes (22 warps)

// context rows (rns2.I1_* / rns2.I2_*)
constexpr int I_M = 0;
constexpr int I1_M2M = 1;
constexpr int I2_U0S = 1;
constexpr int I_ENTRY = 2;
constexpr int I_ONEM = 3;
constexpr int I_ONE = 4;

__device__ __forceinline__ int quot_floor(int v, float inv) {
  return __float2int_rd(__fmul_rn(__int2float_rn(v), inv));
}

__device__ __forceinline__ int red_exact(int v, int m, float inv) {
  int r = v - quot_floor(v, inv) * m;
  r = r < 0 ? r + m : r;
  return r >= m ? r - m : r;
}

__device__ __forceinline__ int red_lazy(int v, int m, float inv) {
  return v - quot_floor(v, inv) * m;
}

__device__ __forceinline__ int red_fast(int v, int m, float inv) {
  return v - __float2int_rz(__fmul_rn(__int2float_rn(v - RED_BIAS), inv)) * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace rns2
