// Kernel B4: limb-domain Montgomery fixed-window ladder, shared or
// per-row moduli and exponents.
//
// Replaces paillier_tpu/bigint/pallas_kernels.py:_modexp_kernel (the
// Pallas TPU kernel behind mont_pow_pallas, which the JAX package also
// vmaps over per-candidate moduli in keygen's Fermat batch).  It computes,
// for every row b of a batch, the canonical base_b^e_b mod n_b, with e
// given as MSB-first base-2^w digits, one string for the batch ([D]) or
// one per row ([B, D]), and n one modulus for the batch or one per row.
// The ladder is montgomery.mont_pow_digits_plain's, multiply for multiply:
//   bm = base * R^2 * R^-1; table = [1_M, bm, bm^2, .., bm^(2^w - 1)];
//   acc = 1_M; per digit d: w squarings, then acc * table[d], d = 0
//   included; exit: acc * 1.
// Every product is a canonical Montgomery product, so the output equals
// the plain version's (and Python's pow) whatever R is; R = 2^(32 nw)
// with nw = L / 2 words is the JAX package's R for even L (the wrapper
// pads an odd L with a zero limb and rebuilds the constants).
//
// Arithmetic: 32-bit words, Montgomery by the fused CIOS step (Koc et
// al.): for each word b_i, one pass over j forms t_j + a_j b_i + c1 and
// (that + m n_j + c2) with m = (t_0 + a_0 b_i) * (-n^-1) mod 2^32, two
// 64-bit carry chains interleaved, the result shifted down one word;
// then one conditional subtract.  t stays below 2n, so it needs nw + 1
// words.  2 nw^2 + nw 32x32->64 multiply-adds per product (8,256 at
// 2048 bits).
//
// Layout: one thread per row (the simplest layout that is right).  A
// block of RB <= 32 threads (RB chosen by the wrapper to fit shared
// memory) keeps every word of its rows in shared memory, laid out
// [word][RB] so that the threads of a warp touch 32 consecutive banks
// whatever their digits: the 2^w-entry table, the accumulator, the
// product t, one operand slot and the modulus, (2^w + 4) nw + 1 words per
// row (5,124 B at nw = 64, w = 4: 164 KB for 32 rows).  Nothing goes
// through device memory but the inputs and the output.
//
// What bounds it on an H100: the 32x32->64 multiply-adds on the INT32
// pipe (64 lanes per SM; an IMAD.WIDE takes two issues, so at most 32
// such multiply-adds per clock per SM).  One thread per row gives a batch
// of 4096 rows about one warp per SM, so the kernel is bound by the
// latency of its carry chains rather than by that rate; the two chains
// of the fused step give each thread two independent multiply-adds per
// word.  Several threads per row (a warp per row with carry-save words)
// are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_RB = 32;       // rows (threads) per block

// A per-thread vector in the [word][RB] layout: element j at p[j * rb].
struct Vec {
  uint32_t* p;
  int rb;
  __device__ __forceinline__ uint32_t& operator[](int j) const {
    return p[j * rb];
  }
};

// out = a * b * R^-1 mod n, canonical, for a < R, b < n (a < n for the
// t < 2n bound of every step).  out may alias a or b; t is scratch of
// nw + 1 words.
__device__ void mont_mul(Vec a, Vec b, Vec n, uint32_t n0, Vec t, Vec out,
                         int nw) {
  for (int j = 0; j <= nw; ++j) t[j] = 0;
  for (int i = 0; i < nw; ++i) {
    const uint32_t bi = b[i];
    uint64_t p = (uint64_t)a[0] * bi + t[0];
    const uint32_t s0 = (uint32_t)p;
    uint32_t c1 = (uint32_t)(p >> 32);
    const uint32_t m = s0 * n0;
    uint64_t q = (uint64_t)m * n[0] + s0;       // low word is 0
    uint32_t c2 = (uint32_t)(q >> 32);
#pragma unroll 4
    for (int j = 1; j < nw; ++j) {
      p = (uint64_t)a[j] * bi + t[j] + c1;
      c1 = (uint32_t)(p >> 32);
      q = (uint64_t)m * n[j] + (uint32_t)p + c2;
      c2 = (uint32_t)(q >> 32);
      t[j - 1] = (uint32_t)q;
    }
    const uint64_t top = (uint64_t)t[nw] + c1 + c2;
    t[nw - 1] = (uint32_t)top;
    t[nw] = (uint32_t)(top >> 32);
  }
  // t < 2n: subtract n once if t >= n
  uint32_t borrow = 0;
  for (int j = 0; j < nw; ++j) {
    const uint64_t d = (uint64_t)t[j] - n[j] - borrow;
    borrow = (uint32_t)(d >> 32) & 1u;
  }
  const bool sub = t[nw] != 0 || borrow == 0;
  borrow = 0;
  for (int j = 0; j < nw; ++j) {
    const uint64_t d = (uint64_t)t[j] - (sub ? n[j] : 0u) - borrow;
    borrow = (uint32_t)(d >> 32) & 1u;
    out[j] = (uint32_t)d;
  }
}

// 16-bit limbs (int32 [L]) -> 32-bit words [nw]; limbs past L read 0
__device__ __forceinline__ void load_words(Vec dst, const int* src, int L,
                                           int nw) {
  for (int j = 0; j < nw; ++j) {
    const uint32_t lo = 2 * j < L ? (uint32_t)src[2 * j] : 0u;
    const uint32_t hi = 2 * j + 1 < L ? (uint32_t)src[2 * j + 1] : 0u;
    dst[j] = lo | (hi << 16);
  }
}

__global__ void __launch_bounds__(MAX_RB)
limb_modexp_kernel(const int* __restrict__ base,
                   const int* __restrict__ digits, int n_digits, int per_row,
                   const int* __restrict__ nmod, const int* __restrict__ n0,
                   const int* __restrict__ r2, int ctx_per_row,
                   int* __restrict__ out, int B, int L, int nw, int window) {
  extern __shared__ uint32_t smem[];
  const int rb = blockDim.x;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * rb + tid;
  if (row >= B) return;                 // no thread reads another's words
  const int T = 1 << window;
  uint32_t* mine = smem + tid;
  auto vec = [&](int word) { return Vec{mine + (size_t)word * rb, rb}; };
  const Vec acc = vec(T * nw), t = vec((T + 1) * nw),
            aux = vec((T + 2) * nw + 1), n = vec((T + 3) * nw + 1);
  const size_t crow = ctx_per_row ? (size_t)row : 0;
  load_words(n, nmod + crow * L, L, nw);
  const uint32_t k0 = (uint32_t)n0[crow];

  // table[1] = base * R^2 * R^-1; table[0] = 1 * R^2 * R^-1 = R mod n
  load_words(acc, base + (size_t)row * L, L, nw);
  load_words(aux, r2 + crow * L, L, nw);
  mont_mul(acc, aux, n, k0, t, vec(nw), nw);
  for (int j = 0; j < nw; ++j) acc[j] = j == 0;
  mont_mul(acc, aux, n, k0, t, vec(0), nw);
  for (int v = 2; v < T; ++v)
    mont_mul(vec((v - 1) * nw), vec(nw), n, k0, t, vec(v * nw), nw);

  // acc = 1_M
  for (int j = 0; j < nw; ++j) acc[j] = vec(0)[j];
  const int* dig = per_row ? digits + (size_t)row * n_digits : digits;
  for (int step = 0; step < n_digits; ++step) {
    for (int s = 0; s < window; ++s) mont_mul(acc, acc, n, k0, t, acc, nw);
    mont_mul(vec(dig[step] * nw), acc, n, k0, t, acc, nw);
  }

  // exit: acc * 1 leaves the Montgomery domain
  for (int j = 0; j < nw; ++j) aux[j] = j == 0;
  mont_mul(acc, aux, n, k0, t, acc, nw);
  int* o = out + (size_t)row * L;
  for (int l = 0; l < L; ++l) o[l] = (int)((acc[l >> 1] >> (16 * (l & 1))) & 0xFFFFu);
}

}  // namespace

extern "C" int limb_modexp_max_rows() { return MAX_RB; }

// Shared-memory bytes of one row of a block.
extern "C" int limb_modexp_row_bytes(int nw, int window) {
  return (int)(((size_t)((1 << window) + 4) * nw + 1) * sizeof(uint32_t));
}

// Launch on `stream` with blocks of `rb` rows; returns the cudaError_t of
// the attribute call or of the launch (0 on success).  base, out: int32
// [B, L] 16-bit limbs; digits int32 [D] (per_row 0) or [B, D]; nmod, r2:
// int32 [L] (ctx_per_row 0) or [B, L]; n0: int32 [1] or [B], the low 32
// bits of -n^-1 mod R; nw = ceil(L / 2).
extern "C" int limb_modexp_launch(const void* base, const void* digits,
                                  int n_digits, int per_row, const void* nmod,
                                  const void* n0, const void* r2,
                                  int ctx_per_row, void* out, int B, int L,
                                  int nw, int window, int rb, void* stream) {
  const size_t smem = (size_t)rb * limb_modexp_row_bytes(nw, window);
  cudaError_t err = cudaFuncSetAttribute(
      limb_modexp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  limb_modexp_kernel<<<(B + rb - 1) / rb, rb, smem, (cudaStream_t)stream>>>(
      (const int*)base, (const int*)digits, n_digits, per_row,
      (const int*)nmod, (const int*)n0, (const int*)r2, ctx_per_row,
      (int*)out, B, L, nw, window);
  return (int)cudaGetLastError();
}
