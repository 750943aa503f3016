// The register-tiled f32 GEMM with the λ-mix in its epilogue, shared by
// cached_mix.cu's mix_fwd (an activation-cache entry, with the f32
// residual bw) and adapter_fuse.cu's tiled path (float taps, no residual):
//
//   out = λ·(entry @ W) + (1−λ)·a,   bw = entry @ W   (bw only when given)
//
// A block of THREADS threads owns a BM x BN output tile and loops over
// the contraction inside the block in steps of BK, staging both operand
// tiles in shared memory as f32; thread (ty, tx) of the 16 x 16 keeps a
// 4x4 register tile (rows ty+16i, cols tx+16j). The entry is read
// through a functor entry(t, k) -> float, so each caller converts or
// dequantizes the entry as it is staged. The contraction runs over ld
// entry columns; W's rows >= d read as zero (an int8 entry padded to
// whole quantization blocks needs no copy). λ is read from device memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mix_tile {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One block's tile: grid (ceil(da / BN), ceil(T / BM)), THREADS threads.
template <typename Entry, typename TW, typename TA, typename TO>
__device__ __forceinline__ void fwd_tile(const Entry& entry, const TW* __restrict__ w,
                                         const TA* __restrict__ a,
                                         const float* __restrict__ lam_p, TO* __restrict__ out,
                                         float* __restrict__ bw, int T, int ld, int d, int da) {
  __shared__ float xs[BK][BM + 1];  // entry tile, transposed, in f32
  __shared__ float ws[BK][BN];      // W tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < ld; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, kk = idx % BK;
      const int gt = t0 + m, gk = k0 + kk;
      xs[kk][m] = (gt < T && gk < ld) ? entry(gt, gk) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gn = n0 + n;
      ws[kk][n] = (gk < d && gn < da) ? to_f32(w[(size_t)gk * da + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
    __syncthreads();
  }
  const float lam = *lam_p;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gt = t0 + ty + 16 * i;
    if (gt >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= da) continue;
      const size_t o = (size_t)gt * da + gn;
      if (bw != nullptr) bw[o] = acc[i][j];
      put(out + o, lam * acc[i][j] + (1.f - lam) * to_f32(a[o]));
    }
  }
}

}  // namespace mix_tile
