// Per-token cross-entropy over the frozen LM head, forward (nll, lse)
// and backward (dh), without the (T, V) logits in device memory, for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/cached_step.py
// _ce_fwd_kernel (_ce_fwd_impl; public lmhead_ce) and _ce_bwd_kernel
// (_ce_bwd_impl). h (T, d) f32 row-major, W (d, V) f32 row-major,
// labels (T,) int32 in [0, V), optional tanh soft-cap (cap > 0).
//
// What bounds them on the H100: at the training shape of internlm2-1.8b
// (T = 2048, d = 2048, V = 92544) the forward is 2·T·d·V ≈ 0.78 TFLOP
// and the backward twice that (it recomputes the logits), against
// ~0.77 GB of head weights: f32 operations on the CUDA cores bound
// both (≈11.6 ms and ≈23.2 ms at 67 TFLOP/s). Every logits tile is a
// register-tiled f32 GEMM of 64 tokens x 128 vocab columns, the h and W
// slices staged 32 deep in shared memory. Tensor cores are later work.
//
// Forward: the TPU grid walks the vocab sequentially per token tile.
// Here blocks run in parallel, so the vocab is split across blocks as
// well (a token tile alone would give 32 blocks for 132 SMs): each block
// keeps an online softmax (running max, sum of exponentials, label
// logit) per (row, thread) over its vocab range, merges the 16 threads
// of a row with shuffles, and writes one partial per (split, token); a
// second kernel merges the splits in a fixed order into lse and nll.
// The logits live only in registers.
//
// Backward: dh = g · ((softmax − onehot) · (1 − tanh²)) @ Wᵀ needs, per
// token, a d-wide sum over the whole vocab. A d-wide accumulator per
// token does not fit a block for enough tokens to reuse each W tile, so
// the vocab runs in chunks of vc columns: ce_grad_chunk recomputes the
// chunk's logits tiles from lse and writes the softmax gradient of the
// chunk, (T, vc) f32 (scratch from the caller, vc ≪ V), and
// ce_dh_chunk adds that chunk times W[:, chunk]ᵀ into dh, the per-token
// d-wide f32 accumulator, as a tiled GEMM; the last chunk applies g[t].
// Chunks run in vocab order on one stream: a deterministic sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows ty+16i (i < 4), cols tx+16j (j < 8)
constexpr float NEG = -1e30f;

// acc[i][j] = sum over k < d of h[t0 + ty + 16i, k] * w[k, v0 + tx + 16j]
// (rows >= T and columns >= V read as zero)
__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ w, int T, int d, int V,
                                            int t0, int v0, float (*xs)[BM + 1],
                                            float (*ws)[BN], float acc[4][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, kk = idx % BK;
      const int gt = t0 + m, gk = k0 + kk;
      xs[kk][m] = (gt < T && gk < d) ? h[(size_t)gt * d + gk] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, n = idx % BN;
      const int gk = k0 + kk, gv = v0 + n;
      ws[kk][n] = (gk < d && gv < V) ? w[(size_t)gk * V + gv] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += x[i] * y[j];
    }
    __syncthreads();
  }
}

// one (split, token) partial (max, sum-exp, label logit) per row over
// columns [split·v_split, min(V, (split+1)·v_split))
__global__ void __launch_bounds__(THREADS)
ce_fwd_partial(const float* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ labels, float* __restrict__ pm, float* __restrict__ pl,
               float* __restrict__ pll, int T, int d, int V, int v_split, float cap) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.y * BM, split = blockIdx.x;
  const int vbeg = split * v_split, vend = min(V, vbeg + v_split);
  float m[4], l[4], ll[4];
  int lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gt = t0 + ty + 16 * i;
    m[i] = NEG;
    l[i] = 0.f;
    ll[i] = 0.f;
    lab[i] = gt < T ? labels[gt] : -1;
  }
  float acc[4][8];
  for (int v0 = vbeg; v0 < vend; v0 += BN) {
    logits_tile(h, w, T, d, V, t0, v0, xs, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + tx + 16 * j;
        float z = acc[i][j];
        if (cap > 0.f) z = cap * tanhf(z / cap);
        z = col < vend ? z : NEG;
        acc[i][j] = z;
        if (col == lab[i] && col < vend) ll[i] += z;
        tmax = fmaxf(tmax, z);
      }
      const float nm = fmaxf(m[i], tmax);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + tx + 16 * j < vend) s += expf(acc[i][j] - nm);
      l[i] = l[i] * expf(m[i] - nm) + s;
      m[i] = nm;
    }
  }
  // merge the 16 threads of each row (one half-warp: lanes differ in tx only)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float llo = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const float nm = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - nm) + lo * expf(mo - nm);
      m[i] = nm;
      ll[i] += llo;
    }
    const int gt = t0 + ty + 16 * i;
    if (tx == 0 && gt < T) {
      const size_t o = (size_t)split * T + gt;
      pm[o] = m[i];
      pl[o] = l[i];
      pll[o] = ll[i];
    }
  }
}

// lse = log-sum-exp over the splits (in split order), nll = lse - label logit
__global__ void ce_merge(const float* __restrict__ pm, const float* __restrict__ pl,
                         const float* __restrict__ pll, float* __restrict__ nll,
                         float* __restrict__ lse, int T, int n_split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float M = NEG;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[(size_t)s * T + t]);
  float L = 0.f, LL = 0.f;
  for (int s = 0; s < n_split; ++s) {
    L += pl[(size_t)s * T + t] * expf(pm[(size_t)s * T + t] - M);
    LL += pll[(size_t)s * T + t];
  }
  const float x = M + logf(L);
  lse[t] = x;
  nll[t] = x - LL;
}

// p[t, c] = (softmax − onehot)·(1 − tanh²) of column c0 + c, for c < vc
// (0 past V)
__global__ void __launch_bounds__(THREADS)
ce_grad_chunk(const float* __restrict__ h, const float* __restrict__ w,
              const int* __restrict__ labels, const float* __restrict__ lse,
              float* __restrict__ p, int T, int d, int V, int c0, int vc, float cap) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.y * BM, v0 = c0 + blockIdx.x * BN;
  float acc[4][8];
  logits_tile(h, w, T, d, V, t0, v0, xs, ws, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gt = t0 + ty + 16 * i;
    if (gt >= T) continue;
    const int lab = labels[gt];
    const float lz = lse[gt];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col - c0 >= vc) continue;
      float z = acc[i][j], slope = 1.f;
      if (cap > 0.f) {
        const float th = tanhf(z / cap);
        z = cap * th;
        slope = 1.f - th * th;
      }
      const float g = col < V ? (expf(z - lz) - (col == lab ? 1.f : 0.f)) * slope : 0.f;
      p[(size_t)gt * vc + (col - c0)] = g;
    }
  }
}

// dh[t, k] (+)= sum over c < n of p[t, c] * w[k, c0 + c]; the first
// chunk writes, the last multiplies by g[t]
__global__ void __launch_bounds__(THREADS)
ce_dh_chunk(const float* __restrict__ p, const float* __restrict__ w,
            const float* __restrict__ g, float* __restrict__ dh, int T, int d, int V, int c0,
            int vc, int n, int first, int last) {
  __shared__ float xs[BK][BM + 1];  // p tile, transposed
  __shared__ float ws[BK][BN + 1];  // ws[c][k] = w[k0 + k, c0 + v0 + c]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int v0 = 0; v0 < n; v0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, c = idx % BK;
      const int gt = t0 + m, gc = v0 + c;
      xs[c][m] = (gt < T && gc < n) ? p[(size_t)gt * vc + gc] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int k = idx / BK, c = idx % BK;
      const int gk = k0 + k, gc = v0 + c;
      ws[c][k] = (gk < d && gc < n) ? w[(size_t)gk * V + c0 + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += x[i] * y[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gt = t0 + ty + 16 * i;
    if (gt >= T) continue;
    const float gt_scale = last ? g[gt] : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gk = k0 + tx + 16 * j;
      if (gk >= d) continue;
      const size_t o = (size_t)gt * d + gk;
      const float v = first ? acc[i][j] : dh[o] + acc[i][j];
      dh[o] = v * gt_scale;
    }
  }
}

}  // namespace

extern "C" {

// Tile sizes the wrapper sizes its grid split and scratch by.
int ce_block_rows() { return BM; }
int ce_block_cols() { return BN; }

// partials: 3 arrays of n_split * T floats; v_split a multiple of the tile width
int ce_fwd_launch(const void* h, const void* w, const void* labels, void* pm, void* pl,
                  void* pll, void* nll, void* lse, int T, int d, int V, int n_split,
                  int v_split, float cap, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  ce_fwd_partial<<<dim3(n_split, (T + BM - 1) / BM), THREADS, 0, s>>>(
      (const float*)h, (const float*)w, (const int*)labels, (float*)pm, (float*)pl,
      (float*)pll, T, d, V, v_split, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_merge<<<(T + 255) / 256, 256, 0, s>>>((const float*)pm, (const float*)pl,
                                           (const float*)pll, (float*)nll, (float*)lse, T,
                                           n_split);
  return (int)cudaGetLastError();
}

// p: scratch of T * vc floats; dh (T, d) f32 is fully written
int ce_bwd_launch(const void* h, const void* w, const void* labels, const void* lse,
                  const void* g, void* p, void* dh, int T, int d, int V, int vc, float cap,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < V; c0 += vc) {
    const int n = V - c0 < vc ? V - c0 : vc;
    ce_grad_chunk<<<dim3((n + BN - 1) / BN, (T + BM - 1) / BM), THREADS, 0, s>>>(
        (const float*)h, (const float*)w, (const int*)labels, (const float*)lse, (float*)p,
        T, d, V, c0, vc, cap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ce_dh_chunk<<<dim3((d + BN - 1) / BN, (T + BM - 1) / BM), THREADS, 0, s>>>(
        (const float*)p, (const float*)w, (const float*)g, (float*)dh, T, d, V, c0, vc, n,
        c0 == 0, c0 + vc >= V);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
