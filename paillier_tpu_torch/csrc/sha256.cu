// The batched SHA-256: the Fiat-Shamir challenges of DDLEQ proofs and of
// the threshold share proofs.
//
// Replaces no Pallas kernel: the JAX package computes the batched hash as
// jnp under one jax.jit (paillier_tpu/ops/sha256.py:94).  The port's plain
// torch version (ops/sha256.py, sha256_bytes_plain) runs each round and
// each message-schedule step as elementwise launches over the batch,
// about 2,500 a 64-byte block whatever the batch: some 82,000 a call for
// DDLEQ's 33-block messages, each a few microseconds of host dispatch.
// This kernel computes the same digests in one launch.
//
// It takes the int64 [B, W] byte values that ops/sha256.concat_be builds
// (no conversion launch in front of it) and the int64 [B] message lengths
// (0..W), and writes int64 [B, 8]: the digest's big-endian 32-bit words,
// each below 2^32, as the plain version gives them.  A row hashes its
// first lengths[b] bytes; the padding (0x80, zeros, the 64-bit bit length)
// is applied in registers, so no padded buffer exists in device memory,
// and each row stops at its own last block, (len + 9 + 63) / 64.  W is any
// width: the kernel loops over blocks, not over a fixed count.
//
// Layout: one thread a message, a block of one warp (32 messages).  The
// 64 rounds of a block are one dependent chain, so a warp cannot split a
// message; the eight state words and a 16-word circular message schedule
// stay in registers (the rounds are unrolled, so every schedule index is
// known at compile time), the 64 round constants lie in __constant__
// memory.  For each 64-byte block the warp loads its 32 rows' bytes with
// coalesced loads (bytes l and l + 32 of one row in lane l: 256 contiguous
// bytes a load, the low halves of the int64 values), one block ahead, so
// that those loads are in flight during the previous block's rounds; it
// stages them in shared memory, each row 68 bytes apart so that the 32
// rows' word j fall in 32 distinct banks, and each thread reads its own
// row's 16 words.
//
// What bounds it on an H100: at a DDLEQ chunk's rank block on four cards
// (1,280 rows of 2,048 bytes, 33 blocks a row) the int64 bytes are 21 MB,
// about 6.3 us at 3.35 TB/s, and the 2,168 32-bit operations a block
// (48 schedule steps of 13, 64 rounds of 24, 8 additions) about 5.5 us on
// 132 SMs x 64 INT32 lanes.  With 40 warps on 132 SMs neither is reached:
// the time is the latency of each thread's chain of 33 x 64 rounds and of
// the 33 blocks' loads, which the one-block prefetch overlaps.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ROWS = 32;        // messages a block: one warp
constexpr int STRIDE = 68;      // staged bytes a row (64 + 4 of padding)

__constant__ uint32_t K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One 64-byte block into the state h; w: the block's 16 big-endian words,
// overwritten by the message schedule.
__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +
                        (g ^ (e & (f ^ g))) + K[t] + w[t & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +
                        ((a & b) | (c & (a | b)));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// This lane's bytes of block `blk` of the warp's 32 rows (row0 on), as
// the low 32-bit words of the int64 values: v[2r] is byte `lane` of row
// r's block, v[2r + 1] byte lane + 32; 0 past the row's `avail` bytes.
// Each load of the warp covers 256 contiguous bytes of one row.
__device__ __forceinline__ void load_block(uint32_t v[2 * ROWS],
                                           const int64_t* data,
                                           long long row0, long long W,
                                           long long avail, int blk,
                                           int lane) {
  const long long base = (long long)blk * 64;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long n = __shfl_sync(0xffffffffu, avail, r) - base;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(data + (row0 + r) * W + base);
    v[2 * r] = lane < n ? src[2 * lane] : 0u;
    v[2 * r + 1] = lane + 32 < n ? src[2 * lane + 64] : 0u;
  }
}

__global__ void __launch_bounds__(ROWS)
sha256_kernel(const int64_t* __restrict__ data,
              const int64_t* __restrict__ lengths, int64_t* __restrict__ out,
              int B, long long W) {
  __shared__ __align__(4) unsigned char stage[ROWS * STRIDE];
  const int lane = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long row = row0 + lane;
  const long long len = row < B ? lengths[row] : 0;
  const long long avail = len < W ? len : W;     // bytes of the row to read
  // this row's blocks: the message, 0x80 and the 64-bit bit length
  const int nblk = row < B ? (int)((len + 9 + 63) / 64) : 0;
  const int most = __reduce_max_sync(0xffffffffu, nblk);
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint32_t v[2 * ROWS];
  if (most > 0) load_block(v, data, row0, W, avail, 0, lane);
  for (int blk = 0; blk < most; ++blk) {
    const long long base = (long long)blk * 64;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      stage[r * STRIDE + lane] = (unsigned char)v[2 * r];
      stage[r * STRIDE + lane + 32] = (unsigned char)v[2 * r + 1];
    }
    __syncwarp();
    // the next block's loads stay in flight during this block's rounds
    if (blk + 1 < most) load_block(v, data, row0, W, avail, blk + 1, lane);
    uint32_t w[16];
    const uint32_t* mine =
        reinterpret_cast<const uint32_t*>(stage + lane * STRIDE);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __byte_perm(mine[j], 0, 0x0123);
    __syncwarp();         // the next block's staging overwrites stage
    if (blk < nblk) {
      // the padding, in registers: 0x80 after the message, the bit
      // length in the last two words of the row's last block
      const long long q = len - base;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (q >= 4 * j && q < 4 * j + 4)
          w[j] |= 0x80u << (24 - 8 * (int)(q - 4 * j));
      if (blk == nblk - 1) {
        const unsigned long long bits = (unsigned long long)len * 8;
        w[14] = (uint32_t)(bits >> 32);
        w[15] = (uint32_t)bits;
      }
      compress(h, w);
    }
  }
  if (row < B) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[row * 8 + i] = h[i];
  }
}

}  // namespace

// Launch on `stream`: data int64 [B, W] byte values, lengths int64 [B]
// (each 0..W), out int64 [B, 8].  Returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a negative B or W).
extern "C" int sha256_launch(const void* data, const void* lengths,
                             void* out, int B, long long W, void* stream) {
  if (B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  sha256_kernel<<<(B + ROWS - 1) / ROWS, ROWS, 0, (cudaStream_t)stream>>>(
      static_cast<const int64_t*>(data), static_cast<const int64_t*>(lengths),
      static_cast<int64_t*>(out), B, W);
  return (int)cudaGetLastError();
}
