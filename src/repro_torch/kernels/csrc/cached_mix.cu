// out = λ·(dequant(b) @ W_down) + (1−λ)·a and its weight gradient
// dW_down = λ·dequant(b)[:, :d]ᵀ @ g, for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/cached_step.py
// _mix_fwd_kernel (_mix_fwd_impl; public dq_adapter_mix) and
// _mix_dw_kernel (_mix_dw_impl). b is an activation-cache entry in its
// storage form, (T, ld) row-major: f32, bf16, or int8 with one f32 scale
// per (token, qblock columns) — scale (T, ld / qblock). W_down (d, da)
// f32 with d <= ld; rows >= d read as zero, so an int8 entry padded to
// whole quantization blocks (ld > d) needs no copy. a / out (T, da) f32
// or bf16; bw (T, da) f32 is the residual the backward pass reads.
// λ is read from device memory (no host round trip per period).
//
// What bounds them on the H100: at the training shape of internlm2-1.8b
// (T = 4·512 tokens, d = 2048, da = 256) each is ~2.1 GFLOP on ~10 MB,
// so f32 operations on the CUDA cores bound both (~32 µs at 67 TFLOP/s),
// not the bytes. Each kernel is one register-tiled f32 GEMM: a block
// owns a 64x64 output tile and loops over the contraction inside the
// block (the Pallas grid's sequential K axis carries nothing between
// blocks here), staging a 32-deep slice of each operand in shared
// memory (mix_fwd's loop is mix_tile.cuh's, shared with adapter_fuse.cu).
// The entry tile is dequantized as it is staged, so the entry
// crosses device memory at its storage width and the f32 tap is never
// written. mix_dw owns each dW tile in one block and loops over tokens:
// no atomics, a deterministic sum. Tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mix_tile.cuh"

namespace {

using namespace mix_tile;

// entry element (t, k) in f32: the int8 payload times its block's scale
// (the reference's exact product), or the float value
template <typename S>
__device__ __forceinline__ float entry_at(const S* __restrict__ b, const float* __restrict__ scale,
                                          int t, int k, int ld, int qblock) {
  const float v = to_f32(b[(size_t)t * ld + k]);
  if constexpr (std::is_same<S, int8_t>::value)
    return v * scale[(size_t)t * (ld / qblock) + k / qblock];
  return v;
}

template <typename S>
struct CacheEntry {
  const S* __restrict__ b;
  const float* __restrict__ scale;
  int ld, qblock;
  __device__ __forceinline__ float operator()(int t, int k) const {
    return entry_at(b, scale, t, k, ld, qblock);
  }
};

// the forward tile loop lives in mix_tile.cuh (shared with adapter_fuse.cu)
template <typename S, typename A>
__global__ void __launch_bounds__(THREADS)
mix_fwd(const S* __restrict__ b, const float* __restrict__ scale, const float* __restrict__ w,
        const A* __restrict__ a, const float* __restrict__ lam_p, A* __restrict__ out,
        float* __restrict__ bw, int T, int ld, int d, int da, int qblock) {
  mix_tile::fwd_tile(CacheEntry<S>{b, scale, ld, qblock}, w, a, lam_p, out, bw, T, ld, d, da);
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
mix_dw(const S* __restrict__ b, const float* __restrict__ scale, const float* __restrict__ g,
       const float* __restrict__ lam_p, float* __restrict__ dw, int T, int ld, int d, int da,
       int qblock) {
  __shared__ float xs[BK][BM];  // xs[tt][m] = entry(t0 + tt, k0 + m), dequantized
  __shared__ float gs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < T; t0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += THREADS) {
      const int tt = idx / BM, m = idx % BM;
      const int gt = t0 + tt, gk = k0 + m;
      xs[tt][m] = (gt < T && gk < d) ? entry_at(b, scale, gt, gk, ld, qblock) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int tt = idx / BN, n = idx % BN;
      const int gt = t0 + tt, gn = n0 + n;
      gs[tt][n] = (gt < T && gn < da) ? g[(size_t)gt * da + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int tt = 0; tt < BK; ++tt) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[tt][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = gs[tt][tx + 16 * j];
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
    const int gk = k0 + ty + 16 * i;
    if (gk >= d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < da) dw[(size_t)gk * da + gn] = lam * acc[i][j];
    }
  }
}

template <typename S, typename A>
void launch_fwd(const void* b, const void* scale, const void* w, const void* a, const void* lam,
                void* out, void* bw, int T, int ld, int d, int da, int qblock, cudaStream_t s) {
  const dim3 grid((da + BN - 1) / BN, (T + BM - 1) / BM);
  mix_fwd<S, A><<<grid, THREADS, 0, s>>>((const S*)b, (const float*)scale, (const float*)w,
                                         (const A*)a, (const float*)lam, (A*)out, (float*)bw,
                                         T, ld, d, da, qblock);
}

template <typename S>
void launch_dw(const void* b, const void* scale, const void* g, const void* lam, void* dw,
               int T, int ld, int d, int da, int qblock, cudaStream_t s) {
  const dim3 grid((da + BN - 1) / BN, (d + BM - 1) / BM);
  mix_dw<S><<<grid, THREADS, 0, s>>>((const S*)b, (const float*)scale, (const float*)g,
                                     (const float*)lam, (float*)dw, T, ld, d, da, qblock);
}

}  // namespace

extern "C" {

// storage: 0 = f32, 1 = bf16, 2 = int8 (+ scale); a_bf16: a and out are bf16, else f32
int mix_fwd_launch(const void* b, const void* scale, const void* w, const void* a,
                   const void* lam, void* out, void* bw, int T, int ld, int d, int da,
                   int qblock, int storage, int a_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int which = storage * 2 + (a_bf16 ? 1 : 0);
  switch (which) {
    case 0: launch_fwd<float, float>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    case 1: launch_fwd<float, __nv_bfloat16>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    case 2: launch_fwd<__nv_bfloat16, float>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    case 3: launch_fwd<__nv_bfloat16, __nv_bfloat16>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    case 4: launch_fwd<int8_t, float>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    case 5: launch_fwd<int8_t, __nv_bfloat16>(b, scale, w, a, lam, out, bw, T, ld, d, da, qblock, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mix_dw_launch(const void* b, const void* scale, const void* g, const void* lam, void* dw,
                  int T, int ld, int d, int da, int qblock, int storage, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: launch_dw<float>(b, scale, g, lam, dw, T, ld, d, da, qblock, s); break;
    case 1: launch_dw<__nv_bfloat16>(b, scale, g, lam, dw, T, ld, d, da, qblock, s); break;
    case 2: launch_dw<int8_t>(b, scale, g, lam, dw, T, ld, d, da, qblock, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
