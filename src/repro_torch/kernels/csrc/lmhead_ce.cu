// Per-token cross-entropy over the frozen LM head, forward (nll, lse)
// and backward (dh), without the (T, V) logits in device memory, for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/cached_step.py
// _ce_fwd_kernel (_ce_fwd_impl; public lmhead_ce) and _ce_bwd_kernel
// (_ce_bwd_impl). h (T, d) row-major, W (d, V) row-major, each f32 or
// bf16, labels (T,) int32 in [0, V), optional tanh soft-cap (cap > 0).
//
// A bf16 operand (a bf16 backbone's head W, or a bf16 h) is exact in
// bf16, so it goes to the tensor cores whole: one plane instead of three,
// and the loop takes the products of an f32 operand's three terms with
// it, 3 a k16 step instead of 6 (1 for two bf16 operands); the epilogues
// are the f32 operands' unchanged. The backward's P stays f32, three
// terms. A bf16 h is copied into its padded plane by ce_pad.
//
// Two loops. An f32 W runs on tile_mma below (mma.sync, cp.async, W split
// a chunk at a time). A bf16 W runs on Hopper's asynchronous loop
// (wgmma_loop.cuh; fwd_launch_wg, bwd_launch_wg, the kernels of namespace
// cw): TMA reads W where it lies (no copy, no chunks in the forward; a
// padded copy by ce_pad only where V is not a multiple of 8 or W's base
// is not 16-byte aligned), into a ring of stages that a producer
// warpgroup fills and two consumer warpgroups multiply with wgmma from
// shared memory, a fresh f32 sum a 64-deep stage. Tiles: 128 tokens x 256
// vocab columns (ce_fwd_wg, one launch over all of V), x 128 (ce_grad_wg,
// a chunk at a time as before), x 256 of d (ce_dh_wg, 128 blocks a chunk
// at the training shape: under one wave of 132 SMs). At the training
// shape (chip_smoke.py, ../ce_fwd_variants.py --w-bf16; NVIDIA H100 80GB
// HBM3, 700 W) ce_fwd takes ~2.9 ms (its bound 2.355, 3 bf16 products)
// and ce_bwd ~6.9 (bound 4.71), against 6.9 and 14.4 on tile_mma: the
// forward's loop issues the three products at ~815 TFLOP/s (its TMA
// stream alone 1.8 ms); ce_grad_wg is held by its stream of h's planes
// from L2 and its P stores (3.4 of 3.65 ms without wgmma), ce_dh_wg by
// the tensor cores (3.1 ms, 2.0 without wgmma).
//
// What bounds them on the H100: at the training shape of internlm2-1.8b
// (T = 2048, d = 2048, V = 92544) the logits are 2·T·d·V ≈ 0.78 TFLOP
// against ~0.77 GB of head weights. Both kernels run on the bf16 tensor
// cores with each f32 operand split in three terms (6 products a GEMM):
// the forward one GEMM, 4.7 TFLOP, 4.7 ms at 989 TFLOP/s (the same work
// in f32 on the CUDA cores, 11.6 ms at 67 TFLOP/s); the backward two
// (the logits again, and dh), 9.4 ms (23.2 in f32).
//
// The shared loop (tile_mma): one block of 8 warps owns one BM x BN =
// 128 x 128 output tile (a warp 64 x 32) and runs the whole contraction,
// BK = 64 deep a stage, three bf16 planes of each operand streaming with
// cp.async into two 96 KB shared-memory stages (one barrier a stage; one
// block an SM, ~255 registers a thread). mma.sync m16n8k16 bf16 with f32
// accumulators, the products of terms i + j <= 2; each k16 step's six
// products go into a fresh f32 sum, smallest terms first, which one add
// puts into the accumulator (the tensor core truncates its addends on the
// largest one's grid: mix_tile.cuh's note). A is row-major with k
// contiguous (ldmatrix); B is read either as stored, (K, N) with n
// contiguous (ldmatrix.trans), or as the transpose of an (N, K) plane
// with k contiguous, the MMA's own column-major B (ldmatrix).
//
// Split once per call. ce_split writes h as three bf16 planes, hi =
// bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid), zero-padded to
// whole tiles (Tp x dp: tokens to BM, d to BK in the forward and to BN in
// the backward), and W the same way one vocab chunk at a time (dp x chunk
// columns, zero past V) into a scratch the caller sizes (~0.1 GB at d =
// 2048, against 1.14 GB for all of W). h is reused by every vocab tile
// and W by every token tile, so splitting as staged would convert each
// value once per tile. The padding is the ragged edge: rows past T, k past
// d and columns past V are zero terms, and the loops read whole tiles.
// A chunk is a whole number of waves of the card (the caller picks its
// width), the token tile the fastest grid index, so the token tiles that
// share one W tile run together and W's planes are read about once.
//
// Forward (fwd_launch): ce_fwd_mma runs the loop on h @ W, one logits
// tile a block. Its epilogue stays in registers: the soft-cap, columns
// >= V masked, each row's max, sum of exponentials and label logit over
// the tile's 128 columns (quad shuffles over a C fragment's row, then the
// four warps along N through shared memory), one partial (m, l, ll) per
// (token, vocab tile). ce_merge, a warp a token, sums them in a fixed
// order: no atomics, two calls give bit-equal nll and lse.
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
// Backward (bwd_launch): dh = g · P @ Wᵀ with P = (softmax − onehot) ·
// (1 − tanh²) needs, per token, a d-wide sum over the whole vocab. A
// block holding one token tile's P would need that tile's d-wide f32
// accumulator (1 MB at d = 2048), and splitting dh by d instead would
// recompute the logits d / BN times. So the vocab runs in the forward's
// chunks, each in two kernels on the same W planes:
//  * ce_grad_mma runs the forward's loop unchanged (the logits bit for
//    bit), then computes P from lse, the label and the soft-cap's slope
//    in registers (0 at columns >= V and rows >= T), splits each value in
//    three bf16 terms and writes them, through shared memory, as three
//    (Tp, chunk) planes with vocab contiguous: no f32 gradient in device
//    memory and no separate split pass.
//  * ce_dh_mma runs the loop on P_chunk @ W_chunkᵀ: A is the P planes,
//    B the W planes read as Wᵀ (row d of a plane has the vocab
//    contiguous: ldmatrix without .trans, where the forward takes .trans).
//    Grid (Tp / BM, dp / BN), d padded to BN so the loop reads whole
//    tiles of W's rows. The first chunk writes dh, later chunks add to
//    it, the last multiplies by g[t]. Chunks run in vocab order on one
//    stream, without atomics: two calls give bit-equal dh.
// The P planes of a chunk are as large as W's (~0.1 GB): 1.14 GB written
// and read once a call at the training shape, ~0.7 ms of device memory
// traffic beside the two ~10 ms loops.
//  What holds it at the training shape (../ce_fwd_variants.py; NVIDIA H100
//  80GB HBM3, 700 W): ~23.5 ms a call, 11.5 in ce_grad_mma, 11.4 in
//  ce_dh_mma, 0.64 in the 12 splits; 2.5x its tensor-core bound. Without
//  their MMAs the two loops take 4.9 and 4.6 ms: the forward's picture,
//  twice. ce_dh_mma's 256 blocks a chunk are 1.94 waves of one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"
#include "wgmma_loop.cuh"

namespace {

constexpr float NEG = -1e30f;

namespace ce {

using namespace mix_tile;

constexpr int WARPS_M = 2, WARPS_N = 4;  // 8 warps
constexpr int WTM = 64, WTN = 32;        // a warp's tile: tokens x vocab columns (or d)
constexpr int MI = WTM / 16, NI = WTN / 8;  // its MMA tiles
constexpr int MG = 2;                    // 16-row tiles summed together: 8 fresh sums
constexpr int BM = WTM * WARPS_M;        // tokens per tile
constexpr int BN = WTN * WARPS_N;        // vocab columns (or d) per tile
constexpr int BK = 64;                   // contraction per stage
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int TERMS = 3;                 // bf16 terms of each f32 operand
constexpr int STAGES = 2;
static_assert(MI % MG == 0 && NI % 2 == 0, "whole groups of MMA tiles");
static_assert(BN % BK == 0, "d padded to BN is whole stages");
constexpr int A_TILE = BM * BK;          // bf16 values of one staged A term
constexpr int B_TILE = BK * BN;          // bf16 values of one staged B term
constexpr int STAGE = TERMS * (A_TILE + B_TILE);
constexpr int SMEM = STAGES * STAGE * (int)sizeof(uint16_t);  // 192 KB
static_assert(3 * WARPS_N * BM * (int)sizeof(float) <= SMEM, "epilogue fits the ring");
static_assert(TERMS * BM * BN * (int)sizeof(uint16_t) <= SMEM, "a P tile fits the ring");

// dst (rows_p, cols_p) bf16: src[r·ld + c0 + c] (bf16) for r < rows and
// c0 + c < cols, zero elsewhere; four values a thread (cols_p a multiple
// of 4)
__global__ void ce_pad(const uint16_t* __restrict__ src, uint16_t* __restrict__ dst, int rows,
                       int cols, int ld, int c0, int rows_p, int cols_p, int vec) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= (long long)rows_p * cols_p) return;
  const int r = (int)(e / cols_p), c = c0 + (int)(e % cols_p);
  const uint16_t* row = src + (size_t)r * ld + c;
  uint2 w = make_uint2(0u, 0u);
  if (vec && r < rows && c + 4 <= cols) {
    w = *reinterpret_cast<const uint2*>(row);
  } else {
    uint16_t v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) v[x] = (r < rows && c + x < cols) ? row[x] : (uint16_t)0;
    w = make_uint2(v[0] | ((uint32_t)v[1] << 16), v[2] | ((uint32_t)v[3] << 16));
  }
  *reinterpret_cast<uint2*>(dst + e) = w;
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

// This lane's place in the block's tile: the warp's first row (wm) and
// column (wn), and its C fragment's rows lane/4 (+8) and columns
// 2·(lane%4) (+1) of each 16 x 8 MMA tile
struct Frag {
  int wm, wn, gq, tq;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
    gq = lane >> 2, tq = lane & 3;
  }
};

// The loop of both kernels: acc (this warp's share of the block's BM x BN
// tile at rows t0, columns n0) = the sum over k < steps·BK of A[t, k] ·
// B(k, n), A in TA bf16 planes and B in TB (three for an f32 operand, one
// for a bf16 one), `a_plane` / `b_plane` values apart. A is (M, K) row-major, leading dimension lda. B is (K, N)
// row-major (ldb, n contiguous) when !BT, the forward's W; when BT it is
// the transpose of an (N, K) row-major plane (ldb, k contiguous), the
// backward's Wᵀ. Leaves the shared-memory ring free for the epilogue.
template <bool BT, int TA = TERMS, int TB = TERMS>
__device__ __forceinline__ void tile_mma(const uint16_t* __restrict__ a, size_t a_plane, int lda,
                                         const uint16_t* __restrict__ b, size_t b_plane, int ldb,
                                         int t0, int n0, int steps, uint16_t* smem,
                                         float (&acc)[MI][NI][4]) {
  const int tid = threadIdx.x, lane = tid & 31;

  // global -> shared stage `slot`: the three A terms' BM x BK tile at
  // (t0, k0) and the three B terms' BK x BN tile at (k0, n0) (stored
  // BN x BK when BT), 16 bytes a copy, rows in global order with their
  // chunks swizzled
  auto load = [&](int slot, int k0) {
    uint16_t* as = smem + slot * STAGE;
    uint16_t* bs = as + TERMS * A_TILE;
#pragma unroll
    for (int j = 0; j < TA; ++j)
#pragma unroll
      for (int i = 0; i < A_TILE / 8 / THREADS; ++i) {
        const int q = tid + i * THREADS, t = q / (BK / 8), m = (q % (BK / 8)) * 8;
        cp_async16(as + j * A_TILE + swz<BK>(t, m),
                   a + j * a_plane + (size_t)(t0 + t) * lda + k0 + m);
      }
#pragma unroll
    for (int j = 0; j < TB; ++j)
#pragma unroll
      for (int i = 0; i < B_TILE / 8 / THREADS; ++i) {
        const int q = tid + i * THREADS;
        if constexpr (BT) {
          const int n = q / (BK / 8), kc = (q % (BK / 8)) * 8;
          cp_async16(bs + j * B_TILE + swz<BK>(n, kc),
                     b + j * b_plane + (size_t)(n0 + n) * ldb + k0 + kc);
        } else {
          const int kr = q / (BN / 8), n = (q % (BN / 8)) * 8;
          cp_async16(bs + j * B_TILE + swz<BN>(kr, n),
                     b + j * b_plane + (size_t)(k0 + kr) * ldb + n0 + n);
        }
      }
  };

  // ldmatrix row of this lane (mix_tile.cuh's forward has the layout):
  // A from [row][k] rows; B from [k][n] rows, transposed, or (BT) from
  // [n][k] rows as they are. Matrix lj of an x4 load: A (rows 0-7, k
  // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15); B (k 0-7, n 0-7),
  // (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): two 8-column tiles' b0, b1.
  const Frag f;
  const int lj = lane >> 3, lr = lane & 7;
  const int a_t = f.wm + ((lj & 1) << 3) + lr, a_k = (lj >> 1) << 3;
  const int b_k = ((lj & 1) << 3) + (BT ? 0 : lr), b_n = f.wn + ((lj >> 1) << 3) + (BT ? lr : 0);

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
      uint32_t bf[TB][NI][2];  // the warp's 8-column tiles, each term
#pragma unroll
      for (int np = 0; np < NI / 2; ++np)
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          uint32_t r[4];
          if constexpr (BT)
            ldsm_x4(r, smem_addr(bs + j * B_TILE + swz<BK>(b_n + 16 * np, kk + b_k)));
          else
            ldsm_x4_t(r, smem_addr(bs + j * B_TILE + swz<BN>(kk + b_k, b_n + 16 * np)));
          bf[j][2 * np][0] = r[0];
          bf[j][2 * np][1] = r[1];
          bf[j][2 * np + 1][0] = r[2];
          bf[j][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int mp = 0; mp < MI / MG; ++mp) {  // MG 16-row tiles at a time
        uint32_t af[MG][TA][4];
#pragma unroll
        for (int mm = 0; mm < MG; ++mm)
#pragma unroll
          for (int i = 0; i < TA; ++i)
            ldsm_x4(af[mm][i],
                    smem_addr(as + i * A_TILE + swz<BK>(a_t + 16 * (MG * mp + mm), kk + a_k)));
        // the k16 step into a fresh f32 sum, smallest products first
        // (terms i + j = 2, 1, then hi·hi; i < TA, j < TB)
        float part[MG][NI][4];
#pragma unroll
        for (int mm = 0; mm < MG; ++mm)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mm][ni][e] = 0.f;
        constexpr int OMAX = TA + TB - 2 < 2 ? TA + TB - 2 : 2;
#pragma unroll
        for (int ord = OMAX; ord >= 0; --ord)
#pragma unroll
          for (int i = ord - (TB - 1) > 0 ? ord - (TB - 1) : 0; i <= ord && i < TA; ++i)
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
}

// One (token tile, vocab tile of the chunk) per block: grid (Tp / BM,
// chunk tiles). hs (3, Tp, dp) and ws (3, dp, ncp) are the split planes;
// the chunk starts at vocab column vt0·BN. Writes the partials (T, n_vt)
// of vocab tile vt0 + blockIdx.y for tokens < T.
template <int TA, int TB>
__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_mma(const uint16_t* __restrict__ hs, const uint16_t* __restrict__ ws,
           const int* __restrict__ labels, float* __restrict__ pm, float* __restrict__ pl,
           float* __restrict__ pll, int T, int Tp, int dp, int V, int ncp, int vt0, int n_vt,
           float cap) {
  extern __shared__ __align__(16) uint16_t smem[];  // STAGES x (A terms, B terms)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[MI][NI][4];
  tile_mma<false, TA, TB>(hs, (size_t)Tp * dp, dp, ws, (size_t)dp * ncp, ncp, t0, n0, dp / BK,
                          smem, acc);
  const Frag f;
  const int wm = f.wm, wn = f.wn, gq = f.gq, tq = f.tq;

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

// One (token tile, vocab tile of the chunk) per block, grid (Tp / BM,
// chunk tiles), as ce_fwd_mma: the same logits, then the softmax
// gradient P = (exp(s − lse) − onehot)·(1 − tanh²) of the tile (the
// slope only under a soft-cap; 0 at columns >= V and rows >= T), split in
// three bf16 terms into ps (3, Tp, ncp) at columns blockIdx.y·BN of the
// chunk. The terms are staged in the free ring, then stored 16 bytes a
// thread, whole rows of the tile at a time.
template <int TA, int TB>
__global__ void __launch_bounds__(THREADS, 1)
ce_grad_mma(const uint16_t* __restrict__ hs, const uint16_t* __restrict__ ws,
            const int* __restrict__ labels, const float* __restrict__ lse,
            uint16_t* __restrict__ ps, int T, int Tp, int dp, int V, int ncp, int vt0,
            float cap) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[MI][NI][4];
  tile_mma<false, TA, TB>(hs, (size_t)Tp * dp, dp, ws, (size_t)dp * ncp, ncp, t0, n0, dp / BK,
                          smem, acc);
  const Frag f;
  const int col0 = (vt0 + blockIdx.y) * BN + f.wn + 2 * f.tq;  // this thread's first vocab column
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.wm + 16 * mi + f.gq + 8 * h;
      const bool live = t0 + row < T;
      const int lab = live ? labels[t0 + row] : -1;
      const float lz = live ? lse[t0 + row] : 0.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * ni + e;
          float z = acc[mi][ni][2 * h + e], slope = 1.f;
          if (cap > 0.f) {
            const float th = tanhf(z / cap);
            z = cap * th;
            slope = 1.f - th * th;
          }
          p[e] = live && col < V ? (expf(z - lz) - (col == lab ? 1.f : 0.f)) * slope : 0.f;
        }
        uint32_t w3[TERMS];
        split3(p[0], p[1], w3);
#pragma unroll
        for (int j = 0; j < TERMS; ++j)
          *reinterpret_cast<uint32_t*>(smem + j * BM * BN +
                                       swz<BN>(row, f.wn + 8 * ni + 2 * f.tq)) = w3[j];
      }
    }
  __syncthreads();
  const size_t pplane = (size_t)Tp * ncp;
#pragma unroll
  for (int j = 0; j < TERMS; ++j)
#pragma unroll
    for (int i = 0; i < BM * BN / 8 / THREADS; ++i) {
      const int q = tid + i * THREADS, r = q / (BN / 8), c = (q % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(ps + j * pplane + (size_t)(t0 + r) * ncp + n0 + c) =
          *reinterpret_cast<const uint4*>(smem + j * BM * BN + swz<BN>(r, c));
    }
}

// dh[t0 : t0 + BM, n0 : n0 + BN] (+)= P_chunk @ W_chunkᵀ, one tile a
// block, grid (Tp / BM, dp / BN): the contraction over the chunk's ncp
// vocab columns; ps (3, Tp, ncp) the P planes, ws (3, dp, ncp) the W
// planes read as Wᵀ. The first chunk writes dh, later chunks add to it,
// the last multiplies by g[t]; rows >= T and columns >= d are not stored.
template <int TB>
__global__ void __launch_bounds__(THREADS, 1)
ce_dh_mma(const uint16_t* __restrict__ ps, const uint16_t* __restrict__ ws,
          const float* __restrict__ g, float* __restrict__ dh, int T, int Tp, int d, int dp,
          int ncp, int first, int last) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[MI][NI][4];
  tile_mma<true, TERMS, TB>(ps, (size_t)Tp * ncp, ncp, ws, (size_t)dp * ncp, ncp, t0, n0,
                            ncp / BK, smem, acc);
  const Frag f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + f.wm + 16 * mi + f.gq + 8 * h;
      if (t >= T) continue;
      const float scale = last ? g[t] : 1.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + f.wn + 8 * ni + 2 * f.tq + e;
          if (n >= d) continue;
          const size_t o = (size_t)t * d + n;
          const float v = acc[mi][ni][2 * h + e];
          dh[o] = (first ? v : dh[o] + v) * scale;
        }
    }
}

}  // namespace ce

// ---- a bf16 head W on Hopper's asynchronous loop (wgmma_loop.cuh)

namespace cw {

using namespace mix_tile;
using wgl::BK;
using wgl::BM;
// 128-column halves a consumer warpgroup owns, by kernel: two halve the
// times h's planes (or P's) stream from L2 for ce_fwd_wg and ce_dh_wg;
// ce_grad_wg keeps one (measured faster: ce_fwd_variants.py)
constexpr int NH_FWD = 2, NH_GRAD = 1, NH_DH = 2;

// this thread's place in its consumer warpgroup's C tile (wgl::mma's
// layout): its first row of the block's BM, lane/4 and lane%4
struct Place {
  int row, gq, tq;
  __device__ __forceinline__ Place() {
    const int lane = threadIdx.x & 31;
    gq = lane >> 2, tq = lane & 3;
    row = 16 * (threadIdx.x / 32) + gq;  // consumer warps 0..7, 16 rows each
  }
};

// column of acc[h][i] within the tile, less 2·(lane%4)
__device__ __forceinline__ int col_of(int h, int i) {
  return wgl::HALF * h + 8 * (i / 4) + (i & 1);
}

// One (token tile, vocab tile) a block, grid (Tp / BM, ceil(V / BN)):
// the logits tile h @ W on the loop, A = h's TA planes (hmap: (TA·Tp, dp)),
// B = W's (d, V) read in place (wmap: MN-major), then the forward's
// epilogue (ce_fwd_mma's): soft-cap, columns >= V masked, per row the
// max, the sum of exponentials and the label logit over the tile, each
// row whole in one warp's quad. Writes the partials (T, n_vt).
template <int TA, int NH>
__global__ void __launch_bounds__(wgl::THREADS, 1)
ce_fwd_wg(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
          const int* __restrict__ labels, float* __restrict__ pm, float* __restrict__ pl,
          float* __restrict__ pll, int T, int Tp, int V, int steps, int n_vt, float cap) {
  extern __shared__ uint8_t smem_raw[];
  const wgl::RingOf<TA, NH> ring(smem_raw);
  constexpr int BN = wgl::bn(NH);  // vocab columns (or d) of the tile
  const int t0 = blockIdx.x * BM, vt = blockIdx.y;
  if (wgl::producer_warp()) {
    wgl::producer_regs();
    if (wgl::producer_thread())
      wgl::produce<TA, NH, false>(ring, &hmap, t0, Tp, &wmap, vt * BN, 0, steps);
  } else {
    wgl::consumer_regs();
    float acc[NH][64];
    wgl::consume<TA, NH, false>(ring, steps, acc);
    const Place at;
    const int col0 = vt * BN + 2 * at.tq;  // this thread's first vocab column
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float z = acc[h][i];
        if (cap > 0.f) z = cap * tanhf(z / cap);
        acc[h][i] = col0 + col_of(h, i) < V ? z : NEG;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows lane/4 and lane/4 + 8: elements 2r, 2r + 1 of each 4
      const int row = at.row + 8 * r;
      float m = NEG;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) m = fmaxf(m, acc[h][4 * j + 2 * r + e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int lab = t0 + row < T ? labels[t0 + row] : -1;
      float l = 0.f, ll = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = acc[h][4 * j + 2 * r + e];
            l += expf(z - m);
            if (col0 + col_of(h, 4 * j + e) == lab) ll += z;
          }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
        ll += __shfl_xor_sync(0xffffffffu, ll, off);
      }
      if (at.tq == 0 && t0 + row < T) {
        const size_t o = (size_t)(t0 + row) * n_vt + vt;
        pm[o] = m;
        pl[o] = l;
        pll[o] = ll;
      }
    }
  }
}

// One (token tile, vocab tile of the chunk) a block, grid (Tp / BM, chunk
// tiles): the forward's logits on the same loop (bit for bit), then
// ce_grad_mma's P (0 at columns >= V and rows >= T) in three bf16 terms,
// staged a half at a time in the free ring and stored 16 bytes a thread
// into ps (3, Tp, ldp) at the chunk's column blockIdx.y·BN.
template <int TA, int NH>
__global__ void __launch_bounds__(wgl::THREADS, 1)
ce_grad_wg(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
           const int* __restrict__ labels, const float* __restrict__ lse,
           uint16_t* __restrict__ ps, int T, int Tp, int V, int ldp, int vt0, int steps,
           float cap) {
  extern __shared__ uint8_t smem_raw[];
  const wgl::RingOf<TA, NH> ring(smem_raw);
  constexpr int BN = wgl::bn(NH);  // vocab columns (or d) of the tile
  const int t0 = blockIdx.x * BM, vt = vt0 + blockIdx.y;
  if (wgl::producer_warp()) {
    wgl::producer_regs();
    if (wgl::producer_thread())
      wgl::produce<TA, NH, false>(ring, &hmap, t0, Tp, &wmap, vt * BN, 0, steps);
  } else {
    wgl::consumer_regs();
    float acc[NH][64];
    wgl::consume<TA, NH, false>(ring, steps, acc);
    const Place at;
    constexpr int H = wgl::HALF;
    static_assert(3 * BM * H * 2 <= wgl::RingOf<TA, NH>::STAGES * wgl::RingOf<TA, NH>::STAGE,
                  "a half's P tile fits the ring");
    uint16_t* stage = reinterpret_cast<uint16_t*>(ring.tiles);  // 3 x BM x HALF bf16
    const int ct = threadIdx.x;  // of the consumers'
    const size_t pplane = (size_t)Tp * ldp;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      wgl::consumers_sync();  // the ring (or the last half's stage) is free
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = at.row + 8 * r;
        const bool live = t0 + row < T;
        const int lab = live ? labels[t0 + row] : -1;
        const float lz = live ? lse[t0 + row] : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = vt * BN + H * h + 8 * j + 2 * at.tq + e;
            float z = acc[h][4 * j + 2 * r + e], slope = 1.f;
            if (cap > 0.f) {
              const float th = tanhf(z / cap);
              z = cap * th;
              slope = 1.f - th * th;
            }
            p[e] = live && col < V ? (expf(z - lz) - (col == lab ? 1.f : 0.f)) * slope : 0.f;
          }
          uint32_t w3[3];
          split3(p[0], p[1], w3);
#pragma unroll
          for (int t = 0; t < 3; ++t)
            *reinterpret_cast<uint32_t*>(stage + t * BM * H + swz<H>(row, 8 * j + 2 * at.tq)) =
                w3[t];
        }
      }
      wgl::consumers_sync();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int i = 0; i < BM * H / 8 / (128 * wgl::CONSUMERS); ++i) {
          const int q = ct + i * 128 * wgl::CONSUMERS, r = q / (H / 8), c = (q % (H / 8)) * 8;
          *reinterpret_cast<uint4*>(ps + t * pplane + (size_t)(t0 + r) * ldp + blockIdx.y * BN +
                                    H * h + c) =
              *reinterpret_cast<const uint4*>(stage + t * BM * H + swz<H>(r, c));
        }
    }
  }
}

// dh[t0 : t0 + BM, n0 : n0 + BN] (+)= P_chunk @ W_chunkᵀ, one tile a block,
// grid (Tp / BM, ceil(d / BN)): A = P's three planes (pmap: (3·Tp, ldp)),
// B = W's rows n0.. read in place as Wᵀ (wtmap: (d, V), K-major), the
// chunk's vocab from column k0, `steps` stages. The first chunk writes
// dh, later chunks add to it, the last multiplies by g[t]; rows >= T and
// columns >= d are not stored.
template <int NH>
__global__ void __launch_bounds__(wgl::THREADS, 1)
ce_dh_wg(const __grid_constant__ CUtensorMap pmap, const __grid_constant__ CUtensorMap wtmap,
         const float* __restrict__ g, float* __restrict__ dh, int T, int Tp, int d, int k0,
         int steps, int first, int last) {
  extern __shared__ uint8_t smem_raw[];
  const wgl::RingOf<3, NH> ring(smem_raw);
  constexpr int BN = wgl::bn(NH);  // vocab columns (or d) of the tile
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (wgl::producer_warp()) {
    wgl::producer_regs();
    if (wgl::producer_thread())
      wgl::produce<3, NH, true>(ring, &pmap, t0, Tp, &wtmap, n0, k0, steps);
  } else {
    wgl::consumer_regs();
    float acc[NH][64];
    wgl::consume<3, NH, true>(ring, steps, acc);
    const Place at;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + at.row + 8 * r;
      if (t >= T) continue;
      const float scale = last ? g[t] : 1.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + col_of(h, 4 * j + e) + 2 * at.tq;
            if (n >= d) continue;
            const size_t o = (size_t)t * d + n;
            const float v = acc[h][4 * j + 2 * r + e];
            dh[o] = (first ? v : dh[o] + v) * scale;
          }
    }
  }
}

}  // namespace cw

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

namespace ce {

// above the default 48 KB of shared memory: opt in, once per kernel
template <typename K>
cudaError_t opt_in(K kernel, bool& opted) {
  if (opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  opted = e == cudaSuccess;
  return e;
}

// dst (3, rows_p, cols_p) from src's rows < rows and columns [c0, c0 +
// cols_p) below cols (ld values a row): an f32 src split in three terms,
// a bf16 src (bf16) copied whole into the first plane
cudaError_t split(const void* src, int bf16, uint16_t* dst, int rows, int cols, int ld, int c0,
                  int rows_p, int cols_p, cudaStream_t s) {
  const long long quads = (long long)rows_p * cols_p / 4;
  const unsigned grid = (unsigned)((quads + 255) / 256);
  if (bf16)
    ce_pad<<<grid, 256, 0, s>>>((const uint16_t*)src, dst, rows, cols, ld, c0, rows_p, cols_p,
                                ld % 4 == 0 && (uintptr_t)src % 8 == 0);
  else
    ce_split<<<grid, 256, 0, s>>>((const float*)src, dst, rows, cols, ld, c0, rows_p, cols_p,
                                  ld % 4 == 0 && (uintptr_t)src % 16 == 0);
  return cudaGetLastError();
}

// the whole forward: split h, then per vocab chunk split W and run the
// tiles, then merge; returns a cudaError_t. hs: TA * Tp * dp bf16 (Tp, dp:
// T, d rounded up to BM, BK); ws: TB * dp * chunk * BN bf16; partials: 3
// arrays of T * ceil(V / BN) floats. TA, TB: the planes of h and W (3 for
// f32, 1 for bf16)
template <int TA, int TB>
int fwd_launch(const void* h, const void* w, const int* labels, uint16_t* hs, uint16_t* ws,
               float* pm, float* pl, float* pll, float* nll, float* lse, int T, int d, int V,
               int chunk, float cap, cudaStream_t s) {
  static bool opted = false;
  cudaError_t e = opt_in(ce_fwd_mma<TA, TB>, opted);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + BM - 1) / BM * BM, dp = (d + BK - 1) / BK * BK;
  const int v_tiles = (V + BN - 1) / BN;
  if ((e = split(h, TA == 1, hs, T, d, d, 0, Tp, dp, s)) != cudaSuccess) return (int)e;
  for (int vt0 = 0; vt0 < v_tiles; vt0 += chunk) {
    const int nt = v_tiles - vt0 < chunk ? v_tiles - vt0 : chunk, ncp = nt * BN;
    if ((e = split(w, TB == 1, ws, d, V, V, vt0 * BN, dp, ncp, s)) != cudaSuccess) return (int)e;
    ce_fwd_mma<TA, TB><<<dim3(Tp / BM, nt), THREADS, SMEM, s>>>(
        hs, ws, labels, pm, pl, pll, T, Tp, dp, V, ncp, vt0, v_tiles, cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ce_merge<<<(T + 7) / 8, 256, 0, s>>>(pm, pl, pll, nll, lse, T, v_tiles);
  return (int)cudaGetLastError();
}

// the whole backward: split h, then per vocab chunk (in order) split W,
// write the chunk's P planes and add P @ Wᵀ into dh; returns a
// cudaError_t. hs: TA * Tp * dp bf16 (Tp, dp: T, d rounded up to BM, BN);
// ws: TB * dp * chunk * BN bf16; ps: 3 * Tp * chunk * BN bf16; dh (T, d)
// f32 is fully written
template <int TA, int TB>
int bwd_launch(const void* h, const void* w, const int* labels, const float* lse,
               const float* g, uint16_t* hs, uint16_t* ws, uint16_t* ps, float* dh, int T, int d,
               int V, int chunk, float cap, cudaStream_t s) {
  static bool opted_grad = false, opted_dh = false;
  cudaError_t e = opt_in(ce_grad_mma<TA, TB>, opted_grad);
  if (e == cudaSuccess) e = opt_in(ce_dh_mma<TB>, opted_dh);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + BM - 1) / BM * BM, dp = (d + BN - 1) / BN * BN;
  const int v_tiles = (V + BN - 1) / BN;
  if ((e = split(h, TA == 1, hs, T, d, d, 0, Tp, dp, s)) != cudaSuccess) return (int)e;
  for (int vt0 = 0; vt0 < v_tiles; vt0 += chunk) {
    const int nt = v_tiles - vt0 < chunk ? v_tiles - vt0 : chunk, ncp = nt * BN;
    if ((e = split(w, TB == 1, ws, d, V, V, vt0 * BN, dp, ncp, s)) != cudaSuccess) return (int)e;
    ce_grad_mma<TA, TB><<<dim3(Tp / BM, nt), THREADS, SMEM, s>>>(hs, ws, labels, lse, ps, T, Tp,
                                                                 dp, V, ncp, vt0, cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ce_dh_mma<TB><<<dim3(Tp / BM, dp / BN), THREADS, SMEM, s>>>(ps, ws, g, dh, T, Tp, d, dp, ncp,
                                                               vt0 == 0, vt0 + nt >= v_tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}


// above the default 48 KB of shared memory: opt in, once per kernel
template <typename K>
cudaError_t opt_in_wg(K kernel, int bytes, bool& opted) {
  if (opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  opted = e == cudaSuccess;
  return e;
}

// W (d, V) bf16 as the wgmma loop reads it: in place where TMA can (V a
// multiple of 8, a 16-byte-aligned base), else copied once into ws (d x
// Vp, Vp = V rounded up to 8) by ce_pad; sets *src and *ld
cudaError_t w_source(const void* w, uint16_t* ws, int d, int V, const void** src, int* ld,
                     cudaStream_t s) {
  if (wgl::tma_readable(w, V)) {
    *src = w, *ld = V;
    return cudaSuccess;
  }
  const int vp = (V + 7) / 8 * 8;
  *src = ws, *ld = vp;
  return split(w, 1, ws, d, V, V, 0, d, vp, s);
}

// the forward with a bf16 W on the wgmma loop: split h (TA planes, Tp x
// dp, dp = d rounded up to BK), one launch over every (token tile, vocab
// tile), token tiles fastest, then merge; ws: the padded W where V or
// W's base does not suit TMA (lmhead_ce.py's ce_fwd_scratch), else unused
template <int TA>
int fwd_launch_wg(const void* h, const void* w, const int* labels, uint16_t* hs, uint16_t* ws,
                  float* pm, float* pl, float* pll, float* nll, float* lse, int T, int d, int V,
                  int /* chunk: one launch */, float cap, cudaStream_t s) {
  constexpr int NH = cw::NH_FWD, BN = wgl::bn(NH), SMEM = wgl::RingOf<TA, NH>::SMEM;
  static bool opted = false;
  cudaError_t e = opt_in_wg(cw::ce_fwd_wg<TA, NH>, SMEM, opted);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + wgl::BM - 1) / wgl::BM * wgl::BM, dp = (d + wgl::BK - 1) / wgl::BK * wgl::BK;
  const int v_tiles = (V + BN - 1) / BN;
  if ((e = split(h, TA == 1, hs, T, d, d, 0, Tp, dp, s)) != cudaSuccess) return (int)e;
  const void* wsrc;
  int ldw;
  if ((e = w_source(w, ws, d, V, &wsrc, &ldw, s)) != cudaSuccess) return (int)e;
  CUtensorMap hmap, wmap;
  if ((e = wgl::tensor_map(&hmap, hs, (long long)TA * Tp, dp, dp, wgl::BM)) != cudaSuccess ||
      (e = wgl::tensor_map(&wmap, wsrc, d, V, ldw, wgl::BK)) != cudaSuccess)
    return (int)e;
  cw::ce_fwd_wg<TA, NH><<<dim3(Tp / wgl::BM, v_tiles), wgl::THREADS, SMEM, s>>>(
      hmap, wmap, labels, pm, pl, pll, T, Tp, V, dp / wgl::BK, v_tiles, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ce_merge<<<(T + 7) / 8, 256, 0, s>>>(pm, pl, pll, nll, lse, T, v_tiles);
  return (int)cudaGetLastError();
}

// the backward with a bf16 W on the wgmma loop: split h as the forward,
// then per vocab chunk (in order) write the chunk's P planes (ps: 3 x Tp
// x chunk·BN) and add P @ Wᵀ into dh, W read in place (or from ws, as
// the forward); dh (T, d) f32 is fully written
template <int TA>
int bwd_launch_wg(const void* h, const void* w, const int* labels, const float* lse,
                  const float* g, uint16_t* hs, uint16_t* ws, uint16_t* ps, float* dh, int T,
                  int d, int V, int chunk, float cap, cudaStream_t s) {
  constexpr int NG = cw::NH_GRAD, ND = cw::NH_DH, BN_G = wgl::bn(NG), BN_D = wgl::bn(ND);
  constexpr int SMEM_G = wgl::RingOf<TA, NG>::SMEM, SMEM_D = wgl::RingOf<3, ND>::SMEM;
  static bool opted_grad = false, opted_dh = false;
  cudaError_t e = opt_in_wg(cw::ce_grad_wg<TA, NG>, SMEM_G, opted_grad);
  if (e == cudaSuccess) e = opt_in_wg(cw::ce_dh_wg<ND>, SMEM_D, opted_dh);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + wgl::BM - 1) / wgl::BM * wgl::BM, dp = (d + wgl::BK - 1) / wgl::BK * wgl::BK;
  const int v_tiles = (V + BN_G - 1) / BN_G, ldp = chunk * BN_G;
  if ((e = split(h, TA == 1, hs, T, d, d, 0, Tp, dp, s)) != cudaSuccess) return (int)e;
  const void* wsrc;
  int ldw;
  if ((e = w_source(w, ws, d, V, &wsrc, &ldw, s)) != cudaSuccess) return (int)e;
  CUtensorMap hmap, wmap, pmap, wtmap;
  if ((e = wgl::tensor_map(&hmap, hs, (long long)TA * Tp, dp, dp, wgl::BM)) != cudaSuccess ||
      (e = wgl::tensor_map(&wmap, wsrc, d, V, ldw, wgl::BK)) != cudaSuccess ||
      (e = wgl::tensor_map(&pmap, ps, 3LL * Tp, ldp, ldp, wgl::BM)) != cudaSuccess ||
      (e = wgl::tensor_map(&wtmap, wsrc, d, V, ldw, BN_D)) != cudaSuccess)
    return (int)e;
  for (int vt0 = 0; vt0 < v_tiles; vt0 += chunk) {
    const int nt = v_tiles - vt0 < chunk ? v_tiles - vt0 : chunk;
    cw::ce_grad_wg<TA, NG><<<dim3(Tp / wgl::BM, nt), wgl::THREADS, SMEM_G, s>>>(
        hmap, wmap, labels, lse, ps, T, Tp, V, ldp, vt0, dp / wgl::BK, cap);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cw::ce_dh_wg<ND><<<dim3(Tp / wgl::BM, (d + BN_D - 1) / BN_D), wgl::THREADS, SMEM_D, s>>>(
        pmap, wtmap, g, dh, T, Tp, d, vt0 * BN_G, nt * BN_G / wgl::BK, vt0 == 0,
        vt0 + nt >= v_tiles);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// 1: a bf16 W runs on the wgmma loop (fwd_launch_wg, bwd_launch_wg), an
// f32 W on tile_mma; 0: both on tile_mma (the loop a bf16 W took before)
constexpr int BF16_W_ON_WGMMA = 1;

}  // namespace ce

}  // namespace

extern "C" {

// 1 where a W of this type runs on the wgmma loop, whose scratch differs
// (lmhead_ce.py's ce_fwd_scratch, ce_bwd_scratch)
int ce_wgmma(int w_bf16) { return w_bf16 && ce::BF16_W_ON_WGMMA; }

// A kernel's tile: dim 0 -> tokens (BM), 1 -> vocab columns (BN), 2 -> depth
// (BK); kernel 0 -> tile_mma's (ce_fwd_mma, ce_grad_mma), 1 -> ce_fwd_wg's,
// 2 -> ce_grad_wg's (the backward's vocab chunks are whole tiles of it)
int ce_tile(int dim, int kernel) {
  if (kernel == 0) return dim == 0 ? ce::BM : dim == 1 ? ce::BN : ce::BK;
  const int bn = wgl::bn(kernel == 1 ? cw::NH_FWD : cw::NH_GRAD);
  return dim == 0 ? wgl::BM : dim == 1 ? bn : wgl::BK;
}

// hs, ws: the split planes' scratch; partials: 3 arrays of T * ceil(V / BN)
// floats (ce::fwd_launch has the sizes); chunk: vocab tiles per W chunk;
// h_bf16, w_bf16: that operand is bf16, else f32
int ce_fwd_launch(const void* h, const void* w, const void* labels, void* hs, void* ws,
                  void* pm, void* pl, void* pll, void* nll, void* lse, int T, int d, int V,
                  int chunk, float cap, int h_bf16, int w_bf16, void* stream) {
  auto run = [&](auto fn) {
    return fn(h, w, (const int*)labels, (uint16_t*)hs, (uint16_t*)ws, (float*)pm, (float*)pl,
              (float*)pll, (float*)nll, (float*)lse, T, d, V, chunk, cap,
              reinterpret_cast<cudaStream_t>(stream));
  };
  if (ce_wgmma(w_bf16)) return h_bf16 ? run(ce::fwd_launch_wg<1>) : run(ce::fwd_launch_wg<3>);
  if (h_bf16) return w_bf16 ? run(ce::fwd_launch<1, 1>) : run(ce::fwd_launch<1, 3>);
  return w_bf16 ? run(ce::fwd_launch<3, 1>) : run(ce::fwd_launch<3, 3>);
}

// hs, ws, ps: the split planes' scratch (ce::bwd_launch has the sizes);
// chunk: vocab tiles per W chunk; dh (T, d) f32 is fully written;
// h_bf16, w_bf16: that operand is bf16, else f32
int ce_bwd_launch(const void* h, const void* w, const void* labels, const void* lse,
                  const void* g, void* hs, void* ws, void* ps, void* dh, int T, int d, int V,
                  int chunk, float cap, int h_bf16, int w_bf16, void* stream) {
  auto run = [&](auto fn) {
    return fn(h, w, (const int*)labels, (const float*)lse, (const float*)g, (uint16_t*)hs,
              (uint16_t*)ws, (uint16_t*)ps, (float*)dh, T, d, V, chunk, cap,
              reinterpret_cast<cudaStream_t>(stream));
  };
  if (ce_wgmma(w_bf16)) return h_bf16 ? run(ce::bwd_launch_wg<1>) : run(ce::bwd_launch_wg<3>);
  if (h_bf16) return w_bf16 ? run(ce::bwd_launch<1, 1>) : run(ce::bwd_launch<1, 3>);
  return w_bf16 ? run(ce::bwd_launch<3, 1>) : run(ce::bwd_launch<3, 3>);
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
