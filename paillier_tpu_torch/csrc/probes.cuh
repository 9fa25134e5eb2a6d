// What the probe kernels P1-P4 (probe_dotvar.cu, probe_dotchain.cu,
// probe_overlap.cu, probe_pad.cu) share: B1's tensor-core product over a
// tile of R rows (R = 8, 16 or 32) and the tile's loads and stores.
//
// The products are B1's own: rns2mma::ext_mma (both halves of a packed
// matrix, lo and hi of one channel in one lane) and, for P1's split4
// layout, pass_one below (one half per pass, the same fragments and
// mma_s8).  The matrices are packed by cuda_build.pack_mma and read from
// L2 with __ldg at every pass, as B1 reads them.  A row holds D = 640
// int8 digits (k = 320 channels a half, B1's width at 2048 bits) in
// shared memory with B1's padded stride; a tile's digit rows are double
// buffered, so a step that reads one buffer and writes the other needs one
// __syncthreads.  Every block has one warp per 16-channel group of the
// matrix it multiplies (20 groups of [640, 640], 24 of the padded
// [640, 768], 12 of [640, 384]).
//
// Products whose results the probe's function drops (the zero gap columns
// of P1's padded layout, the columns past 640 of P4's widest matrix) are
// folded into `junk`, stored to `sink` if it is not null: the wrappers
// pass null, which the compiler cannot know, so it keeps them.

#pragma once

#include <cstdint>

#include "rns2_mont_mma.cuh"

namespace probes {

using rns2mma::Ctx;
using rns2mma::ext_mma;
using rns2mma::mma_s8;

constexpr int K = 320;                         // channels a half
constexpr int D = 2 * K;                       // digits a row
constexpr int LS = D + rns2mma::LHS_PAD;       // shared-memory row stride

template <int R>
constexpr size_t tile_bytes() { return (size_t)2 * R * LS; }

// k: K, passed by the host as a kernel argument.  Were it a constant,
// the compiler would unroll ext_mma's slice loop and keep the whole
// matrix in (spilled) registers across the steps instead of reading it
// from L2 at every pass; B1's k is a kernel argument too.
__device__ __forceinline__ Ctx make_ctx(int k) {
  Ctx c{};
  c.k = k;
  c.G = K / 16;
  c.LS = LS;
  const int tid = threadIdx.x;
  c.warp = tid >> 5;
  c.nwarp = blockDim.x >> 5;
  c.lane = tid & 31;
  c.g = c.lane >> 2;
  c.t = c.lane & 3;
  return c;
}

// The packed matrix at step i: ep itself (k == K at run time), at an
// address the compiler cannot prove the same at every step, so no
// fragment load is hoisted out of the step loop.
__device__ __forceinline__ const int4* step_ptr(const int4* ep,
                                                const Ctx& cx, int i) {
  return ep + (i & (cx.k - K));
}

// Row r and channel c of lane slot (n, j) of the mma fragments (ext_mma's
// mapping): channel cg*16 + g + 8 (j >> 1) of row 8 n + 2 t + (j & 1).
__device__ __forceinline__ int frag_row(const Ctx& cx, int n, int j) {
  return 8 * n + 2 * cx.t + (j & 1);
}
__device__ __forceinline__ int frag_col(const Ctx& cx, int cg, int j) {
  return cg * 16 + cx.g + 8 * (j >> 1);
}

// One half h (0: lo, 1: hi) of the packed matrix ep against the tile:
// acc[n][j] = sum_d lhs[row][d] * E[d][h * half + col], with ext_mma's
// fragments and order of loads, one pass over the contraction.
template <int R>
__device__ __forceinline__ void pass_one(const Ctx& cx, const int8_t* lhs,
                                         const int4* __restrict__ ep, int cg,
                                         int h, int (&acc)[R / 8][4]) {
#pragma unroll
  for (int n = 0; n < R / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0;
  const int npair = cx.k / 32;
  const int4* ap = ep + (size_t)cg * npair * 128 + cx.lane + 32 * h;
  const int8_t* bp = lhs + cx.g * cx.LS + 16 * cx.t;
  int4 a0 = __ldg(ap), a1 = __ldg(ap + 64);    // k32 steps u = 0, 1
  for (int s = 0; s < npair; ++s) {
    const int4* np = ap + 128 * min(s + 1, npair - 1);
    const int4 n0 = __ldg(np), n1 = __ldg(np + 64);
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      const int4 b = *reinterpret_cast<const int4*>(bp + 8 * n * cx.LS +
                                                    64 * s);
      mma_s8(acc[n], a0, b.x, b.y);
      mma_s8(acc[n], a1, b.z, b.w);
    }
    a0 = n0;
    a1 = n1;
  }
}

// int8 rows [B, D] from global into a tile buffer (rows past B: zeros).
template <int R>
__device__ __forceinline__ void load_i8(int8_t* buf, const int8_t* x,
                                        int row0, int B) {
  for (int i = threadIdx.x; i < R * (D / 16); i += blockDim.x) {
    const int r = i / (D / 16), q = i % (D / 16);
    int4 v = make_int4(0, 0, 0, 0);
    if (row0 + r < B)
      v = __ldg(reinterpret_cast<const int4*>(x + (size_t)(row0 + r) * D) +
                q);
    *reinterpret_cast<int4*>(buf + r * LS + 16 * q) = v;
  }
}

template <int R>
__device__ __forceinline__ void store_i8(int8_t* out, const int8_t* buf,
                                         int row0, int B) {
  for (int i = threadIdx.x; i < R * (D / 16); i += blockDim.x) {
    const int r = i / (D / 16), q = i % (D / 16);
    if (row0 + r < B)
      reinterpret_cast<int4*>(out + (size_t)(row0 + r) * D)[q] =
          *reinterpret_cast<const int4*>(buf + r * LS + 16 * q);
  }
}

// Variants of one step of the int8 product chain (P1-P3): x' =
// int8(concat(v, v)), v = (the sum of the step's lo and hi products, hi
// shifted left by 7 or 0) & 127 on the tile's 320 channels, in uint32
// (the JAX kernels' int32 sums wrap):
//   SPLIT4  four passes (pass_one) over the two [640, 320] halves of the
//           packed [640, 640]: lo + (hi << 7), twice;
//   GAP2    two ext_mma passes over the padded [640, 768] (lo | 64 zero
//           columns | hi | 64 zero columns): lo + (hi << 7), twice;
//   FUSED2  two ext_mma passes over the packed [640, 640], as B1's
//           base extension runs: lo + (hi << 7), twice;
//   WIDE1   one ext_mma pass over the padded [640, 768]: lo + (hi << 7);
//   CHAIN   one ext_mma pass over [640, 640]: lo + hi (P2, two a step);
//   DOTS    two ext_mma passes over [640, 640]: lo + hi, twice (P3).
enum Variant { SPLIT4 = 0, GAP2 = 1, FUSED2 = 2, WIDE1 = 3, CHAIN = 4,
               DOTS = 5 };

// One step of variant V: reads cur, writes nxt (channels of this warp's
// group cg); warps of the gap groups (cg >= K / 16) fold their products
// into junk.  The caller synchronises after it.
template <int R, int V>
__device__ __forceinline__ void chain_step(const Ctx& cx, const int8_t* cur,
                                           int8_t* nxt,
                                           const int4* __restrict__ ep,
                                           int cg, uint32_t& junk) {
  uint32_t v[R / 8][4];
#pragma unroll
  for (int n = 0; n < R / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[n][j] = 0u;
  if constexpr (V == SPLIT4) {
    int acc[R / 8][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      pass_one<R>(cx, cur, ep, cg, p & 1, acc);
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[n][j] += (uint32_t)acc[n][j] << (7 * (p & 1));
    }
  } else {
    constexpr int shift = V == CHAIN || V == DOTS ? 0 : 7;
    constexpr int passes = V == WIDE1 || V == CHAIN ? 1 : 2;
#pragma unroll
    for (int p = 0; p < passes; ++p) {
      int lo[R / 8][4], hi[R / 8][4];
      ext_mma<R>(cx, cur, ep, cg, lo, hi);
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[n][j] += (uint32_t)lo[n][j] + ((uint32_t)hi[n][j] << shift);
    }
  }
  if (cg < K / 16) {
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = frag_row(cx, n, j), c = frag_col(cx, cg, j);
        const int8_t d = (int8_t)(v[n][j] & 127u);
        nxt[r * LS + c] = d;
        nxt[r * LS + K + c] = d;
      }
  } else {
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) junk |= v[n][j];
  }
}

__device__ __forceinline__ void flush_junk(int* sink, uint32_t junk) {
  if (sink != nullptr && junk != 0u) atomicOr(sink, (int)junk);
}

// Launch a kernel instantiation with `threads` threads a block and `smem`
// bytes of dynamic shared memory on ceil(B / rows) blocks.
inline int launch(const void* fn, int B, int rows, int threads, size_t smem,
                  void** args, void* stream) {
  if (fn == nullptr || threads <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(fn, dim3((B + rows - 1) / rows), dim3(threads),
                         args, smem, (cudaStream_t)stream);
  return (int)err;
}

}  // namespace probes
