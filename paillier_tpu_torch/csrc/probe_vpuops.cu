// Probe P5: the cost of one pass of each elementwise op class.
//
// Replaces the v5e probe scripts/perf_vpuops.py (mk, pl.pallas_call at
// :78): `reps` repetitions of one op on x int32 [B, 320] with f f32
// [B, 320].  A block of 640 threads holds 32 rows as B1 holds its tile at
// k = 320 (a thread owns one channel of 16 rows), in registers here, and
// one instantiation per op class (V, in the order of OPS in
// paillier_tpu_torch/probes/vpuops.py) keeps each loop to its op.
//
// Folding: a chain that is affine in x, or adds a loop-invariant value of
// f, lets the compiler collapse the loop (2,000 x (x + 12345) into one
// add; shift is 0 after three steps; unrolled by 4, x * 12347 became one
// multiply by 12347^4, and an empty asm volatile did not stop it: it
// leaves no PTX behind).  So the repetition loop is not unrolled, x passes
// through a PTX move after every repetition, and f, where the op reads
// it, is XORed with a run-time zero (`zero & s`, one LOP3 a value a pass,
// part of the time of castf, fmul, floor and lanesum).
// tests/test_torch_kernels.py checks that the SASS loops hold each op
// once a value, and chip_smoke.py that no op takes less than one issue
// slot a value.  Rounding as the JAX kernel's: __int2float_rn,
// __fmul_rn, __float2int_rd for floor, __float2int_rz for astype(int32),
// no fast math; int32 products wrap, so they are computed in uint32.
// lanesum sums a row's 320 floats across the threads that hold it (a
// shuffle tree a warp, then the 10 warp partials of a row in shared
// memory); its inputs lie on a 1/256 grid in [0, 100), so every order
// of summation is exact.  Bound: the fewest instructions an op needs a
// value (probes/vpuops.py OPS) over 132 SMs x 128 lanes x 1.98 GHz.

#include <cstdint>

namespace vpuops {

constexpr int K = 320;           // columns
constexpr int ROWS = 32;         // rows of a block
constexpr int THREADS = 640;
constexpr int PER = ROWS * K / THREADS;   // values a thread holds
constexpr int NOPS = 12;

enum Op { ADD, MUL, MULVAR, SHIFT, WHERE, CASTF, FMUL, FLOOR, LANESUM, RED,
          REDFAST, REDLAZY };

__device__ __forceinline__ void fence(int& v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
}

__device__ __forceinline__ int mulu(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

template <int V>
__device__ __forceinline__ int apply(int x, float f) {
  const float C = (float)6.1e-5;           // the script's constant, as f32
  if (V == ADD) return (int)((uint32_t)x + 12345u);
  if (V == MUL) return mulu(x, 12347);
  if (V == MULVAR) return mulu(x, x | 1) & 0x3FFF;
  if (V == SHIFT) return (int)(((uint32_t)x << 7) & 0xFFFFu);
  if (V == WHERE) return x > 8192 ? x - 8192 : x;
  if (V == CASTF) return x + __float2int_rz(f);
  if (V == FMUL) return x + __float2int_rz(__fmul_rn(f, 1.5f));
  if (V == FLOOR) return x + __float2int_rd(f);
  if (V == RED || V == REDLAZY) {
    const int q = __float2int_rd(__fmul_rn(__int2float_rn(x), C));
    int r = (int)((uint32_t)x - (uint32_t)q * 16383u);
    if (V == REDLAZY) return r;
    r = r < 0 ? r + 16383 : r;
    return r >= 16383 ? r - 16383 : r;
  }
  if (V == REDFAST) {
    const int q = __float2int_rz(__fmul_rn(__int2float_rn(x - 420), C));
    return (int)((uint32_t)x - (uint32_t)q * 16383u);
  }
  return x;
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
vpu_kernel(const int* __restrict__ x, const float* __restrict__ f,
           int* __restrict__ out, int B, int reps, int zero) {
  __shared__ float part[ROWS][K / 32];      // lanesum: warp partials
  __shared__ float rowsum[ROWS];
  const int c = threadIdx.x % K, r0 = threadIdx.x / K;   // rows r0 + 2i
  const int row0 = blockIdx.x * ROWS;
  int xv[PER];
  float fv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = row0 + r0 + 2 * i;
    xv[i] = r < B ? __ldg(x + (size_t)r * K + c) : 0;
    fv[i] = r < B ? __ldg(f + (size_t)r * K + c) : 0.0f;
  }
#pragma unroll 1
  for (int s = 0; s < reps; ++s) {
    const int z = zero & s;
    if (V == CASTF || V == FMUL || V == FLOOR || V == LANESUM) {
#pragma unroll
      for (int i = 0; i < PER; ++i)
        fv[i] = __int_as_float(__float_as_int(fv[i]) ^ z);
    }
    if (V == LANESUM) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float v = fv[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        if ((threadIdx.x & 31) == 0) part[r0 + 2 * i][c / 32] = v;
      }
      __syncthreads();
      if (threadIdx.x < ROWS) {
        float v = part[threadIdx.x][0];
#pragma unroll
        for (int w = 1; w < K / 32; ++w)
          v = __fadd_rn(v, part[threadIdx.x][w]);
        rowsum[threadIdx.x] = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] += __float2int_rz(rowsum[r0 + 2 * i]);
        fence(xv[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        xv[i] = apply<V>(xv[i], fv[i]);
        fence(xv[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = row0 + r0 + 2 * i;
    if (r < B) out[(size_t)r * K + c] = xv[i];
  }
}

template <int V>
const void* kernel_of(int op) {
  if constexpr (V < NOPS)
    return op == V ? (const void*)vpu_kernel<V> : kernel_of<V + 1>(op);
  return nullptr;
}

}  // namespace vpuops

// x int32 [B, 320], f f32 [B, 320]; op: 0..11 in the order of
// probes/vpuops.py OPS.  Returns a cudaError_t (0 on success).
extern "C" int vpuops_launch(const void* x, const void* f, void* out, int B,
                             int reps, int op, void* stream) {
  using namespace vpuops;
  const void* fn = op >= 0 ? kernel_of<0>(op) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int zero = 0;
  void* args[] = {&x, &f, &out, &B, &reps, &zero};
  return (int)cudaLaunchKernel(fn, dim3((B + ROWS - 1) / ROWS),
                               dim3(THREADS), args, 0, (cudaStream_t)stream);
}
