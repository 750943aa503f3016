// Per-token cross-entropy over the frozen LM head, forward (nll, lse)
// and backward (dh), without the (T, V) logits in device memory, for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/cached_step.py
// _ce_fwd_kernel (_ce_fwd_impl; public lmhead_ce) and _ce_bwd_kernel
// (_ce_bwd_impl). h (T, d) f32 row-major, W (d, V) f32 row-major,
// labels (T,) int32 in [0, V), optional tanh soft-cap (cap > 0).
//
// What bounds them on the H100: at the training shape of internlm2-1.8b
// (T = 2048, d = 2048, V = 92544) the logits are 2·T·d·V ≈ 0.78 TFLOP
// against ~0.77 GB of head weights. The forward runs on the bf16 tensor
// cores with both operands split in three terms (6 products): 4.7 TFLOP,
// 4.7 ms at 989 TFLOP/s (the same work in f32 on the CUDA cores, 11.6 ms
// at 67 TFLOP/s). The backward recomputes the logits and runs on the CUDA
// cores in f32: twice the forward's f32 work, ≈23.2 ms.
//
// Forward (cefwd::launch):
//  * Split once per call. ce_split writes h as three bf16 planes, hi =
//    bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid), zero-padded
//    to whole tiles (Tp x dp: tokens to BM, d to BK), and W the same way
//    one vocab chunk at a time (dp x chunk columns, zero past V) into a
//    scratch the caller sizes (~0.1 GB at d = 2048, against 1.14 GB for
//    all of W). h is reused by every vocab tile and W by every token
//    tile, so splitting as staged would convert each value once per tile.
//    The padding is the ragged edge: rows past T, k past d and columns
//    past V are zero terms, and the main loop reads whole tiles unmasked.
//  * ce_fwd_mma: one block of 8 warps owns one BM x BN = 128 x 128 logits
//    tile (a warp 64 x 32) and runs the whole contraction, BK = 64 deep
//    a stage, the planes streaming with cp.async into two 96 KB
//    shared-memory stages (one barrier a stage; one block an SM, 253
//    registers a thread). mma.sync m16n8k16 bf16 with f32 accumulators,
//    the products of terms i + j <= 2; each k16 step's six products go
//    into a fresh f32 sum, smallest terms first, which one add puts into
//    the accumulator (the tensor core truncates its addends on the
//    largest one's grid: mix_tile.cuh's note).
//  * The epilogue stays in registers: the soft-cap, columns >= V masked,
//    each row's max, sum of exponentials and label logit over the tile's
//    128 columns (quad shuffles over a C fragment's row, then the four
//    warps along N through shared memory), one partial (m, l, ll) per
//    (token, vocab tile). ce_merge, a warp a token, sums them in a fixed
//    order: no atomics, two calls give bit-equal nll and lse.
//  * Raster: the token tile is the fastest grid index, so the token tiles
//    that share one W tile run together and W's planes are read from
//    device memory about once. A chunk is a whole number of waves of the
//    card (the caller picks its width).
//  What holds it at the training shape (chip_smoke.py, ../ce_fwd_variants.py;
//  NVIDIA H100 80GB HBM3, 700 W): ~11.3 ms a call, 10.6–10.8 of them in
//  ce_fwd_mma, 0.63 in the 12 splits, 0.012 in the merge; 2.4x its
//  tensor-core bound. The loop without its MMAs (loads, ldmatrix,
//  epilogue) takes 4.2 ms, at the SM's shared-memory rate; each of the
//  six products adds ~1.2 ms (~640 TFLOP/s, mma.sync's practical rate
//  on this card), and the two overlap little. BK 32 with 4 stages, 3
//  stages, and 64 x 64 warp tiles (a third fewer ldmatrix a product)
//  measured the same or up to 5 % slower. wgmma, which reads both
//  operands from shared memory without ldmatrix, is the next step.
//
// Backward: dh = g · ((softmax − onehot) · (1 − tanh²)) @ Wᵀ needs, per
// token, a d-wide sum over the whole vocab. A d-wide accumulator per
// token does not fit a block for enough tokens to reuse each W tile, so
// the vocab runs in chunks of vc columns: ce_grad_chunk recomputes the
// chunk's logits tiles from lse and writes the softmax gradient of the
// chunk, (T, vc) f32 (scratch from the caller, vc ≪ V), and
// ce_dh_chunk adds that chunk times W[:, chunk]ᵀ into dh, the per-token
// d-wide f32 accumulator, as a tiled GEMM; the last chunk applies g[t].
// Every logits tile is a register-tiled f32 GEMM of 64 tokens x 128
// vocab columns, the h and W slices staged 32 deep in shared memory.
// Chunks run in vocab order on one stream: a deterministic sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"

namespace {

constexpr float NEG = -1e30f;

// ------------------------------------------------------------ the forward
namespace cefwd {

using namespace mix_tile;

constexpr int WARPS_M = 2, WARPS_N = 4;  // 8 warps
constexpr int WTM = 64, WTN = 32;        // a warp's tile: tokens x vocab columns
constexpr int MI = WTM / 16, NI = WTN / 8;  // its MMA tiles
constexpr int MG = 2;                    // 16-row tiles summed together: 8 fresh sums
constexpr int BM = WTM * WARPS_M;        // tokens per tile
constexpr int BN = WTN * WARPS_N;        // vocab columns per tile
constexpr int BK = 64;                   // contraction per stage
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int TERMS = 3;                 // bf16 terms of each f32 operand
constexpr int STAGES = 2;
static_assert(MI % MG == 0 && NI % 2 == 0, "whole groups of MMA tiles");
constexpr int A_TILE = BM * BK;          // bf16 values of one staged h term
constexpr int B_TILE = BK * BN;          // bf16 values of one staged W term
constexpr int STAGE = TERMS * (A_TILE + B_TILE);
constexpr int SMEM = STAGES * STAGE * (int)sizeof(uint16_t);  // 192 KB
static_assert(3 * WARPS_N * BM * (int)sizeof(float) <= SMEM, "epilogue fits the ring");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (3, rows_p, cols_p) bf16: the hi, mid, lo terms of
// src[r·ld + c0 + c] for r < rows and c0 + c < cols, zero elsewhere;
// four values a thread (cols_p a multiple of 4)
__global__ void ce_split(const float* __restrict__ src, uint16_t* __restrict__ dst, int rows,
                         int cols, int ld, int c0, int rows_p, int cols_p, int vec) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  const long long plane = (long long)rows_p * cols_p;
  if (e >= plane) return;
  const int r = (int)(e / cols_p), c = c0 + (int)(e % cols_p);
  float v[4];
  const float* row = src + (size_t)r * ld + c;
  if (vec && r < rows && c + 4 <= cols) {
    const float4 f = *reinterpret_cast<const float4*>(row);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) v[x] = (r < rows && c + x < cols) ? row[x] : 0.f;
  }
  uint32_t w01[3], w23[3];
  split3(v[0], v[1], w01);
  split3(v[2], v[3], w23);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<uint2*>(dst + j * plane + e) = make_uint2(w01[j], w23[j]);
}

// One (token tile, vocab tile of the chunk) per block: grid (Tp / BM,
// chunk tiles). hs (3, Tp, dp) and ws (3, dp, ncp) are the split planes;
// the chunk starts at vocab column vt0·BN. Writes the partials (T, n_vt)
// of vocab tile vt0 + blockIdx.y for tokens < T.
__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_mma(const uint16_t* __restrict__ hs, const uint16_t* __restrict__ ws,
           const int* __restrict__ labels, float* __restrict__ pm, float* __restrict__ pl,
           float* __restrict__ pll, int T, int Tp, int dp, int V, int ncp, int vt0, int n_vt,
           float cap) {
  extern __shared__ __align__(16) uint16_t smem[];  // STAGES x (A terms, B terms)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const size_t hplane = (size_t)Tp * dp, wplane = (size_t)dp * ncp;
  const int steps = dp / BK;

  // global -> shared stage `slot`: the three h terms' BM x BK tile at
  // (t0, k0) and the three W terms' BK x BN tile at (k0, n0), 16 bytes a
  // copy, rows in global order with their chunks swizzled
  auto load = [&](int slot, int k0) {
    uint16_t* as = smem + slot * STAGE;
    uint16_t* bs = as + TERMS * A_TILE;
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
#pragma unroll
      for (int i = 0; i < A_TILE / 8 / THREADS; ++i) {
        const int q = tid + i * THREADS, t = q / (BK / 8), m = (q % (BK / 8)) * 8;
        cp_async16(as + j * A_TILE + swz<BK>(t, m),
                   hs + j * hplane + (size_t)(t0 + t) * dp + k0 + m);
      }
#pragma unroll
    for (int j = 0; j < TERMS; ++j)
#pragma unroll
      for (int i = 0; i < B_TILE / 8 / THREADS; ++i) {
        const int q = tid + i * THREADS, kr = q / (BN / 8), n = (q % (BN / 8)) * 8;
        cp_async16(bs + j * B_TILE + swz<BN>(kr, n),
                   ws + j * wplane + (size_t)(k0 + kr) * ncp + n0 + n);
      }
  };

  // ldmatrix row of this lane (mix_tile.cuh's forward has the layout):
  // A from h's [token][k] rows, B from W's [k][n] rows, transposed
  const int lj = lane >> 3, lr = lane & 7;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  const int a_t = wm + ((lj & 1) << 3) + lr, a_k = (lj >> 1) << 3;
  const int b_k = ((lj & 1) << 3) + lr, b_n = wn + ((lj >> 1) << 3);
  // C fragment: rows lane/4 (+8), columns 2·(lane%4) (+1) of each 16 x 8 tile
  const int gq = lane >> 2, tq = lane & 3;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto compute = [&](int slot) {
    const uint16_t* as = smem + slot * STAGE;
    const uint16_t* bs = as + TERMS * A_TILE;
#pragma unroll
    for (int sub = 0; sub < BK / 16; ++sub) {
      const int kk = 16 * sub;
      uint32_t bf[TERMS][NI][2];  // the warp's 8-column tiles, each term
#pragma unroll
      for (int np = 0; np < NI / 2; ++np)
#pragma unroll
        for (int j = 0; j < TERMS; ++j) {
          uint32_t r[4];
          ldsm_x4_t(r, smem_addr(bs + j * B_TILE + swz<BN>(kk + b_k, b_n + 16 * np)));
          bf[j][2 * np][0] = r[0];
          bf[j][2 * np][1] = r[1];
          bf[j][2 * np + 1][0] = r[2];
          bf[j][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int mp = 0; mp < MI / MG; ++mp) {  // MG 16-row tiles at a time
        uint32_t af[MG][TERMS][4];
#pragma unroll
        for (int mm = 0; mm < MG; ++mm)
#pragma unroll
          for (int i = 0; i < TERMS; ++i)
            ldsm_x4(af[mm][i],
                    smem_addr(as + i * A_TILE + swz<BK>(a_t + 16 * (MG * mp + mm), kk + a_k)));
        // the k16 step into a fresh f32 sum, smallest products first
        // (terms i + j = 2, 1, then hi·hi)
        float part[MG][NI][4];
#pragma unroll
        for (int mm = 0; mm < MG; ++mm)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mm][ni][e] = 0.f;
#pragma unroll
        for (int ord = 2; ord >= 0; --ord)
#pragma unroll
          for (int i = 0; i <= ord; ++i)
#pragma unroll
            for (int mm = 0; mm < MG; ++mm)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni) mma_bf16(part[mm][ni], af[mm][i], bf[ord - i][ni]);
#pragma unroll
        for (int mm = 0; mm < MG; ++mm)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[MG * mp + mm][ni][e] += part[mm][ni][e];
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_wait<STAGES - 2>();  // stage kt has landed (this thread's copies) ...
    __syncthreads();        // ... every thread's, and stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < steps) load(next % STAGES, next * BK);
    cp_commit();
    compute(kt % STAGES);
  }
  cp_wait<0>();
  __syncthreads();  // the ring becomes the epilogue's scratch

  // the epilogue: soft-cap, columns >= V masked, then per row the max,
  // the sum of exponentials and the label logit over the tile's columns
  float* red_m = reinterpret_cast<float*>(smem);  // [WARPS_N][BM] each
  float* red_l = red_m + WARPS_N * BM;
  float* red_ll = red_l + WARPS_N * BM;
  const int wcol = warp % WARPS_N;
  const int col0 = (vt0 + blockIdx.y) * BN + wn + 2 * tq;  // this thread's first vocab column
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float z = acc[mi][ni][e];
        if (cap > 0.f) z = cap * tanhf(z / cap);
        acc[mi][ni][e] = col0 + 8 * ni + (e & 1) < V ? z : NEG;
      }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = NEG;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) m = fmaxf(m, acc[mi][ni][2 * h + e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (tq == 0) red_m[wcol * BM + wm + 16 * mi + gq + 8 * h] = m;
    }
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + 16 * mi + gq + 8 * h;
      float m = red_m[row];
#pragma unroll
      for (int w = 1; w < WARPS_N; ++w) m = fmaxf(m, red_m[w * BM + row]);
      const int lab = t0 + row < T ? labels[t0 + row] : -1;
      float l = 0.f, ll = 0.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = acc[mi][ni][2 * h + e];
          l += expf(z - m);
          if (col0 + 8 * ni + e == lab) ll += z;
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
        ll += __shfl_xor_sync(0xffffffffu, ll, off);
      }
      if (tq == 0) {
        red_l[wcol * BM + row] = l;
        red_ll[wcol * BM + row] = ll;
      }
    }
  __syncthreads();
  if (tid < BM && t0 + tid < T) {
    float m = red_m[tid], l = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) m = fmaxf(m, red_m[w * BM + tid]);
#pragma unroll
    for (int w = 0; w < WARPS_N; ++w) {
      l += red_l[w * BM + tid];
      ll += red_ll[w * BM + tid];
    }
    const size_t o = (size_t)(t0 + tid) * n_vt + vt0 + blockIdx.y;
    pm[o] = m;
    pl[o] = l;
    pll[o] = ll;
  }
}

}  // namespace cefwd

// lse = log-sum-exp over a token's n partials, nll = lse − label logit:
// one warp a token (partials (T, n) row-major), each lane's partials in
// order, then a fixed shuffle tree, so two calls give bit-equal results
__global__ void ce_merge(const float* __restrict__ pm, const float* __restrict__ pl,
                         const float* __restrict__ pll, float* __restrict__ nll,
                         float* __restrict__ lse, int T, int n) {
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (t >= T) return;
  const size_t o = (size_t)t * n;
  float M = NEG;
  for (int s = lane; s < n; s += 32) M = fmaxf(M, pm[o + s]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f, LL = 0.f;
  for (int s = lane; s < n; s += 32) {
    L += pl[o + s] * expf(pm[o + s] - M);
    LL += pll[o + s];
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {  // every lane ends with the same sums
    L += __shfl_xor_sync(0xffffffffu, L, off);
    LL += __shfl_xor_sync(0xffffffffu, LL, off);
  }
  if (lane == 0) {
    const float x = M + logf(L);
    lse[t] = x;
    nll[t] = x - LL;
  }
}

namespace cefwd {

// the whole forward: split h, then per vocab chunk split W and run the
// tiles, then merge; returns a cudaError_t. hs: 3 * Tp * dp bf16 (Tp, dp:
// T, d rounded up to the tile); ws: 3 * dp * chunk * BN bf16; partials: 3
// arrays of T * ceil(V / BN) floats
int launch(const float* h, const float* w, const int* labels, uint16_t* hs, uint16_t* ws,
           float* pm, float* pl, float* pll, float* nll, float* lse, int T, int d, int V,
           int chunk, float cap, cudaStream_t s) {
  static bool opted = false;  // above the default 48 KB: opt in, once
  if (!opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(ce_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int Tp = (T + BM - 1) / BM * BM, dp = (d + BK - 1) / BK * BK;
  const int v_tiles = (V + BN - 1) / BN;
  const long long h_quads = (long long)Tp * dp / 4;
  ce_split<<<(unsigned)((h_quads + 255) / 256), 256, 0, s>>>(
      h, hs, T, d, d, 0, Tp, dp, d % 4 == 0 && (uintptr_t)h % 16 == 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int vt0 = 0; vt0 < v_tiles; vt0 += chunk) {
    const int nt = v_tiles - vt0 < chunk ? v_tiles - vt0 : chunk, ncp = nt * BN;
    const long long w_quads = (long long)dp * ncp / 4;
    ce_split<<<(unsigned)((w_quads + 255) / 256), 256, 0, s>>>(
        w, ws, d, V, V, vt0 * BN, dp, ncp, V % 4 == 0 && (uintptr_t)w % 16 == 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ce_fwd_mma<<<dim3(Tp / BM, nt), THREADS, SMEM, s>>>(hs, ws, labels, pm, pl, pll, T, Tp, dp,
                                                        V, ncp, vt0, v_tiles, cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ce_merge<<<(T + 7) / 8, 256, 0, s>>>(pm, pl, pll, nll, lse, T, v_tiles);
  return (int)cudaGetLastError();
}

}  // namespace cefwd

// ----------------------------------------------------------- the backward
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows ty+16i (i < 4), cols tx+16j (j < 8)

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

// The backward's tile width, which its wrapper sizes the chunk scratch by.
int ce_block_cols() { return BN; }

// The forward's tile: 0 -> tokens (BM), 1 -> vocab columns (BN), 2 -> depth (BK).
int ce_fwd_tile(int dim) { return dim == 0 ? cefwd::BM : dim == 1 ? cefwd::BN : cefwd::BK; }

// hs, ws: the split planes' scratch; partials: 3 arrays of T * ceil(V / BN)
// floats (cefwd::launch has the sizes); chunk: vocab tiles per W chunk
int ce_fwd_launch(const void* h, const void* w, const void* labels, void* hs, void* ws,
                  void* pm, void* pl, void* pll, void* nll, void* lse, int T, int d, int V,
                  int chunk, float cap, void* stream) {
  return cefwd::launch((const float*)h, (const float*)w, (const int*)labels, (uint16_t*)hs,
                       (uint16_t*)ws, (float*)pm, (float*)pl, (float*)pll, (float*)nll,
                       (float*)lse, T, d, V, chunk, cap, reinterpret_cast<cudaStream_t>(stream));
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
