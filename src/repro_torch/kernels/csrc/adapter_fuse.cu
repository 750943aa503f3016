// out = λ·(b @ W_down) + (1−λ)·a — the fused adapter mix for float taps,
// forward only, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/adapter_fuse.py (_kernel /
// adapter_fuse). b (T, d) f32 or bf16; W_down (d, da) f32 or bf16; a
// (T, da) f32 or bf16; out (T, da) in b's type; all row-major. The
// product is accumulated in f32 and the mix is applied in f32 before the
// one rounding to out's type. λ is a 0-d f32 device tensor, already
// clamped to [0, 1], read here (a host read would stall the stream once
// per period). T, d and da are ragged and masked here: no padding copies.
//
// What bounds it on the H100: on the serving path (pac_decode_step, one
// call per period of a decode step) T is the batch, 1 to 8, with d = 2048
// and da = 256. The call then reads W_down (2.1 MB in f32) once and does
// almost no arithmetic: the bytes bound it (~0.63 µs at 3.35 TB/s), and
// in practice the launch latency. At the training width (T = 2048) the
// tensor cores' operations bound it: 6 bf16 products of 2·T·d·da for f32
// taps and W (13 µs at 989 TFLOP/s; 32 µs in f32 on the CUDA cores), one
// for bf16 (2.2 µs, under the 3.4 µs its bytes take).
//
// Two paths, chosen by T:
//  * skinny (T <= 8): split-K. A block owns 128 columns (lane l reads
//    columns l, l+32, l+64, l+96 of each W row, so each warp load is
//    coalesced) and a 32-row slice of d; its 8 warps split the rows, the
//    b slice sits in shared memory, and the warps' sums meet in shared
//    memory in warp order. A second small kernel sums the slices in
//    slice order and applies the λ-mix (deterministic, no atomics). At
//    d = 2048, da = 256 that is 2 x 64 = 128 blocks for 132 SMs.
//  * tiled (T > 8): mix_tile.cuh's tensor-core loop (mixfwd::launch), the
//    one cached_mix.cu's mix_fwd runs, without its residual: b as the
//    entry (f32 split in three bf16 terms, bf16 whole), W split in three
//    when f32 and whole when bf16, so 6 products per k16 step for f32 b
//    and W, 3 for one bf16 operand, 1 for both bf16. 128 x 64 output
//    tiles with the contraction cut into slices (4 at T = 2048, d = 2048,
//    da = 256; 8 at T = 100, d = 1000, da = 200), summed in slice order
//    by the same reduce as the skinny path's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"

namespace {

using mix_tile::to_f32;

// ---------------------------------------------------------------- skinny
constexpr int SK_ROWS = 8;      // max T on this path
constexpr int SK_COLS = 128;    // columns per block, 4 per lane
constexpr int SK_WARPS = 8;     // row lanes per block
constexpr int SK_KCHUNK = 32;   // W rows per block
constexpr int SK_THREADS = 32 * SK_WARPS;

template <typename TB, typename TW>
__global__ void __launch_bounds__(SK_THREADS)
fuse_skinny(const TB* __restrict__ b, const TW* __restrict__ w, float* __restrict__ partial,
            int T, int d, int da) {
  __shared__ float xs[SK_ROWS][SK_KCHUNK];
  __shared__ float red[SK_WARPS][SK_ROWS][SK_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * SK_COLS;
  const int kbeg = blockIdx.y * SK_KCHUNK;
  for (int idx = threadIdx.x; idx < SK_ROWS * SK_KCHUNK; idx += SK_THREADS) {
    const int t = idx / SK_KCHUNK, kk = idx % SK_KCHUNK;
    xs[t][kk] = (t < T && kbeg + kk < d) ? to_f32(b[(size_t)t * d + kbeg + kk]) : 0.f;
  }
  __syncthreads();
  float acc[SK_ROWS][4];
#pragma unroll
  for (int t = 0; t < SK_ROWS; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
#pragma unroll 4
  for (int kk = warp; kk < SK_KCHUNK; kk += SK_WARPS) {
    const int k = kbeg + kk;
    if (k >= d) break;
    float wv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + lane + 32 * c;
      wv[c] = n < da ? to_f32(w[(size_t)k * da + n]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < SK_ROWS; ++t) {
      const float xv = xs[t][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] += xv * wv[c];
    }
  }
#pragma unroll
  for (int t = 0; t < SK_ROWS; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][t][lane + 32 * c] = acc[t][c];
  __syncthreads();
  for (int o = threadIdx.x; o < T * SK_COLS; o += SK_THREADS) {
    const int t = o / SK_COLS, c = o % SK_COLS;
    const int n = n0 + c;
    if (n >= da) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < SK_WARPS; ++v) s += red[v][t][c];
    partial[((size_t)blockIdx.y * T + t) * da + n] = s;
  }
}

template <typename TB, typename TW, typename TA>
int launch(const void* b, const void* w, const void* a, const void* lam, void* out,
           void* partial, int T, int d, int da, cudaStream_t s) {
  if (T > SK_ROWS) {  // tiled: b is the loop's entry, its own width d
    constexpr int KIND = sizeof(TB) == 4 ? mix_tile::F32 : mix_tile::BF16;
    return mixfwd::launch<KIND, TW, TA, TB>(b, nullptr, (const TW*)w, (const TA*)a,
                                            (const float*)lam, (TB*)out, nullptr,
                                            (float*)partial, T, d, d, da, 0, s);
  }
  const dim3 grid((da + SK_COLS - 1) / SK_COLS, (d + SK_KCHUNK - 1) / SK_KCHUNK);
  fuse_skinny<TB, TW><<<grid, SK_THREADS, 0, s>>>((const TB*)b, (const TW*)w, (float*)partial,
                                                  T, d, da);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return mixfwd::reduce((const float*)partial, (const TA*)a, (const float*)lam, (TB*)out,
                        static_cast<float*>(nullptr), (int)grid.y, (long long)T * da, s);
}

template <typename TB, typename TW>
int launch_a(int a_bf16, const void* b, const void* w, const void* a, const void* lam,
             void* out, void* partial, int T, int d, int da, cudaStream_t s) {
  return a_bf16 ? launch<TB, TW, __nv_bfloat16>(b, w, a, lam, out, partial, T, d, da, s)
                : launch<TB, TW, float>(b, w, a, lam, out, partial, T, d, da, s);
}

}  // namespace

extern "C" {

// (T, da) f32 partials one call sums: the skinny path's 32-row slices of
// d, or the tiled path's contraction slices when more than one; 0: none
int adapter_fuse_partials(int T, int d, int da) {
  if (T <= SK_ROWS) return (d + SK_KCHUNK - 1) / SK_KCHUNK;
  const int S = mixfwd::slices(T, d, da);
  return S > 1 ? S : 0;
}

// partial: (adapter_fuse_partials(T, d, da), T, da) f32 scratch when that is > 0, else unused.
// *_bf16: that operand (and, for b, out) is bf16, else f32.
int adapter_fuse_launch(const void* b, const void* w, const void* a, const void* lam, void* out,
                        void* partial, int T, int d, int da, int b_bf16, int w_bf16, int a_bf16,
                        void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (T <= 0 || d <= 0 || da <= 0) return (int)cudaErrorInvalidValue;
  switch ((b_bf16 ? 2 : 0) + (w_bf16 ? 1 : 0)) {
    case 0: return launch_a<float, float>(a_bf16, b, w, a, lam, out, partial, T, d, da, s);
    case 1: return launch_a<float, __nv_bfloat16>(a_bf16, b, w, a, lam, out, partial, T, d, da, s);
    case 2: return launch_a<__nv_bfloat16, float>(a_bf16, b, w, a, lam, out, partial, T, d, da, s);
    default:
      return launch_a<__nv_bfloat16, __nv_bfloat16>(a_bf16, b, w, a, lam, out, partial, T, d,
                                                    da, s);
  }
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
