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
// Both kernels run on the bf16 tensor cores (mma.sync m16n8k16, f32
// accumulators). An f32 operand is split into three bf16 terms as it is
// staged, hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid), and
// the products of terms i + j <= 2 are kept; int8 codes (|q| <= 127) and
// bf16 values are exact in bf16 and go to the MMA whole. The MMA helpers
// (swizzle, ldmatrix, mma, split3, codes) are mix_tile.cuh's.
//
// mix_fwd is mix_tile.cuh's forward loop (mixfwd::launch, shared with
// adapter_fuse.cu's tiled path; its note has the design). Per storage:
//  * int8 entry, qblock a multiple of 16 (the training path's 128): the
//    codes whole, W_down split in three: 3 products per k16 step. The
//    scale changes along the contraction, so it cannot fold into W_down:
//    each k16 step's fresh sum is multiplied by its row's scale as it is
//    added to the accumulator. (The reference rounds q·s in f32, the
//    kernel scales the partial sum.)
//  * bf16 entry: whole, W_down split in three: 3 products.
//  * f32 entry: both split, the 6 products with i + j <= 2.
//  * int8 entry, any other qblock: dequantized to f32 as it is staged,
//    then the f32 entry's path.
// Its error model, emulated on the CPU with float64 products
// (tests/test_torch_kernels.py::test_mix_fwd_bf16_split_error_model) at
// the training contraction d = 2048: against the exact product three
// terms err 1.2e-7–1.6e-7, under the plain version's own f32 sum
// (1.3e-6–1.9e-6), and two terms 8.8e-6–2.0e-5. Both would meet the
// forward's tolerance, atol 1e-4 + rtol 1e-4 for out and bw (the
// reference's dq_adapter_mix check, tests/test_cached_step.py:53-56);
// three keep it at f32 accuracy, which bw carries into the backward's dλ.
// On the card (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W) the kernel
// differs from the plain version by at most 2.0e-6 at the training shape,
// every storage. What bounds it at the training shape (T = 4·512,
// d = 2048, da = 256, int8 entries): 3 terms x 2·T·d·da = 6.4 GFLOP of
// bf16 work, 6.5 µs at 989 TFLOP/s; ~12.4 MB of bytes (entry and scales,
// W_down, a, out, bw), 3.7 µs at 3.35 TB/s; the same work in f32 on the
// CUDA cores, 32 µs. What the redesign does about the four things that
// held the scalar f32 kernel it replaced (a 4x4 register tile a thread)
// at 0.34 ms:
//  * CUDA cores, 8 shared loads for 16 FMAs: bf16 MMAs, fragments read
//    by ldmatrix from XOR-swizzled rows, no bank conflicts.
//  * 128 blocks of 256 threads for 132 SMs, each walking all of d: the
//    contraction is cut into S slices (S = 4 at the training shape: 256
//    blocks, two on each SM), summed by mixfwd::mix_fwd_reduce in slice
//    order, so reruns stay bit-equal (no atomics).
//  * one byte a thread through a functor, two integer divisions and a
//    transposed store an element: 16-byte loads a thread, int8 codes
//    converted four at a time by byte permutes, one scale a thread a
//    step, rows stored in their global order.
//  * one buffer, loads and math serialized: the next step's loads go to
//    registers before this step's MMAs, into the other of two buffers.
//
// mix_dw's operand split, per storage:
//  * int8 entry, qblock a multiple of BM (the training path's 128): the
//    codes (|q| <= 127) are exact in bf16. A block's BM dW rows lie in
//    one quantization block, so the scale is one number per token for
//    the tile and is folded into the other operand, g' = s·g in f32,
//    before the split: 3 products per k16 step. (The reference rounds
//    q·s in f32, the kernel s·g.)
//  * bf16 entry: exact in bf16, g split in three: 3 products.
//  * f32 entry: both operands split in three, the 6 products with
//    i + j <= 2.
//  * int8 entry whose qblock is not a multiple of BM: dequantized to f32
//    as it is staged, then the f32-entry path.
// Why three terms: two (hi + mid, ~16 significant bits) miss the check
// chip_smoke.py holds mix_dw to, max(|Δ| − 1e-3·|want|) <= 2e-4 against
// the plain version. Emulated on the CPU with float64 products
// (tests/test_torch_kernels.py::test_mix_dw_bf16_split_error_model's
// arithmetic) at the training shape T = 2048, d = 2048, da = 256: two
// terms give 2.2e-4 (int8 entries), 2.8e-4 (bf16), 4.5e-4 (f32); three
// give 2.5e-5, 2.7e-5, 2.4e-5, most of it the plain version's own f32
// sum (against the exact product their max error is 1.2e-5–1.5e-5,
// two terms' 3.6e-4–7.3e-4).
// The MMA adds its 16 products and C on the grid of the largest addend,
// truncating. With the running sum as C that grid is the sum's, and each
// of a step's three MMAs cut the small terms' products on it: at the
// training shape the f32 entry's check came to 1.6e-4 (first chip run,
// NVIDIA H100 80GB HBM3, 700 W). So each k16 step's products go into a
// fresh f32 sum, smallest terms first, which one rounded add then puts
// into the accumulator: 2.6e-5 on the same inputs. mix_fwd does the same.
//
// What bounds mix_dw on the H100 at the training shape: 3 terms x 2·T·d·da
// = 6.4 GFLOP of bf16 work, 6.5 µs at 989 TFLOP/s; ~8.4 MB of bytes,
// 2.5 µs at 3.35 TB/s. (The same work in f32 on the CUDA cores: 32 µs.)
// Design: a block of 8 warps owns a 128 (d) x 64 (da) dW tile, each warp
// 32 x 32 (2 x 4 MMA tiles), and steps the tokens 32 at a time. (4 warps
// on 64 x 64 split each g tile for half as many MMAs: 0.044 against
// 0.038 ms at the training shape, int8 entry, same chip run.) The global
// loads of step i+1 (16 bytes a thread where the row allows) go to
// registers before the MMAs of step i; the conversion and split then
// store them to the other of two shared-memory buffers, rows in their
// global order with 16-byte chunks XOR-swizzled by row, and
// ldmatrix.trans reads the fragments (the transpose happens there; no
// cp.async, which cannot convert in flight). To give the 132 SMs enough
// blocks, the tokens are cut into S slices (S = 4 at the training shape:
// 256 blocks, two on each SM); each writes its f32 partial dW to a
// scratch (S, d, da) and a second small kernel sums the slices in slice
// order and applies λ: no atomics, two calls give bit-equal dW. Ragged
// T, d, da are masked. Times on the card: PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"

namespace {

// ---------------------------------------------------------------- mix_dw
namespace mixdw {

using namespace mix_tile;

constexpr int WARPS_M = 4, WARPS_N = 2;  // 8 warps of 32 x 32
constexpr int BM = 32 * WARPS_M;    // dW rows (of d) per block
constexpr int BN = 32 * WARPS_N;    // dW columns (of da) per block
constexpr int BK = 32;              // tokens per step
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int A_TILE = BK * BM;     // bf16 values of one staged entry term
constexpr int B_TILE = BK * BN;     // bf16 values of one staged g term
constexpr int B_TERMS = 3;          // g (or s·g) in three bf16 terms
constexpr int MIN_BLOCKS = 2;       // per SM, so <= 128 registers a thread
constexpr int TARGET_BLOCKS = 256;  // 2 blocks of 8 warps on each of 132 SMs
constexpr int MIN_STEPS = 4;        // token steps a slice keeps at least

template <int KIND>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_dw_mma(const void* __restrict__ b_, const float* __restrict__ scale,
           const float* __restrict__ g, const float* __restrict__ lam_p,
           float* __restrict__ out, int T, int ld, int d, int da, int qblock, int vec_b,
           int vec_g) {
  using U = typename Entry<KIND>::U;
  constexpr int A_TERMS = Entry<KIND>::A_TERMS;
  constexpr int EPC = 16 / sizeof(U);            // entry elements per 16-byte chunk
  constexpr int CPR = BM / EPC;                  // chunks per staged row
  constexpr int A_CH = BK * CPR / THREADS;       // entry chunks per thread per step
  constexpr int G_CH = BK * (BN / 4) / THREADS;  // g chunks (4 floats) per thread per step
  constexpr bool FOLD = KIND == I8;
  static_assert(A_CH >= 1 && G_CH >= 1, "tile too small for the block");

  extern __shared__ __align__(16) uint16_t smem[];  // 2 x (A_TERMS A_TILEs, B_TERMS B_TILEs)
  const U* __restrict__ b = static_cast<const U*>(b_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nqb = FOLD || KIND == I8_DEQ ? ld / qblock : 0;
  const int kb = FOLD ? m0 / qblock : 0;  // the tile's one quantization block

  const int steps = (T + BK - 1) / BK, S = gridDim.z;
  const int s_begin = (int)((long long)blockIdx.z * steps / S);
  const int s_end = (int)((long long)(blockIdx.z + 1) * steps / S);

  uint4 ar[A_CH], gr[G_CH];
  float gs[G_CH];

  // global -> registers: the entry's BK x BM tile at (t0, m0) and g's at (t0, n0)
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * THREADS, gt = t0 + q / CPR;
      ar[i] = gt < T ? load_chunk(b + (size_t)gt * ld, m0 + (q % CPR) * EPC, ld, vec_b)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < G_CH; ++i) {
      const int q = tid + i * THREADS, gt = t0 + q / (BN / 4);
      gr[i] = gt < T ? load_chunk(reinterpret_cast<const uint32_t*>(g) + (size_t)gt * da,
                                  n0 + (q % (BN / 4)) * 4, da, vec_g)
                     : make_uint4(0, 0, 0, 0);
      if constexpr (FOLD) gs[i] = gt < T ? scale[(size_t)gt * nqb + kb] : 0.f;
    }
  };

  // registers -> shared buffer `buf`: converted, split, in swizzled rows
  auto store = [&](int buf, int t0) {
    uint16_t* as = smem + buf * (A_TERMS * A_TILE + B_TERMS * B_TILE);
    uint16_t* bs = as + A_TERMS * A_TILE;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * THREADS, t = q / CPR, m = (q % CPR) * EPC;
      const uint4 v = ar[i];
      if constexpr (KIND == BF16) {
        *reinterpret_cast<uint4*>(as + swz<BM>(t, m)) = v;
      } else if constexpr (KIND == I8) {
        uint4 lo, hi;
        codes_bf16(v, lo, hi);
        *reinterpret_cast<uint4*>(as + swz<BM>(t, m)) = lo;
        *reinterpret_cast<uint4*>(as + swz<BM>(t, m + 8)) = hi;
      } else if constexpr (KIND == F32) {
        uint32_t w01[3], w23[3];
        split3(__uint_as_float(v.x), __uint_as_float(v.y), w01);
        split3(__uint_as_float(v.z), __uint_as_float(v.w), w23);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<uint2*>(as + j * A_TILE + swz<BM>(t, m)) = make_uint2(w01[j], w23[j]);
      } else {  // I8_DEQ: q·s in f32 (the reference's product), then split
        const int gt = t0 + t;
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t p[3][8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float f[4];
          codes_f32(w[h], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gm = m0 + m + 4 * h + e;
            f[e] = (gt < T && gm < ld) ? f[e] * scale[(size_t)gt * nqb + gm / qblock] : 0.f;
          }
          uint32_t lo[3], hi[3];
          split3(f[0], f[1], lo);
          split3(f[2], f[3], hi);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            p[j][2 * h] = lo[j];
            p[j][2 * h + 1] = hi[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          *reinterpret_cast<uint4*>(as + j * A_TILE + swz<BM>(t, m)) =
              make_uint4(p[j][0], p[j][1], p[j][2], p[j][3]);
          *reinterpret_cast<uint4*>(as + j * A_TILE + swz<BM>(t, m + 8)) =
              make_uint4(p[j][4], p[j][5], p[j][6], p[j][7]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G_CH; ++i) {
      const int q = tid + i * THREADS, t = q / (BN / 4), n = (q % (BN / 4)) * 4;
      float x[4] = {__uint_as_float(gr[i].x), __uint_as_float(gr[i].y),
                    __uint_as_float(gr[i].z), __uint_as_float(gr[i].w)};
      if constexpr (FOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = gs[i] * x[e];
      }
      uint32_t w01[3], w23[3];
      split3(x[0], x[1], w01);
      split3(x[2], x[3], w23);
#pragma unroll
      for (int j = 0; j < B_TERMS; ++j)
        *reinterpret_cast<uint2*>(bs + j * B_TILE + swz<BN>(t, n)) = make_uint2(w01[j], w23[j]);
    }
  };

  // ldmatrix row of this lane: matrix j = lane / 8, row lane % 8.
  // A (dW rows x tokens) from the entry's [token][m] rows: matrices
  // (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15).
  // B (tokens x dW columns) from g's [token][n] rows: matrices
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
  const int lj = lane >> 3, lr = lane & 7;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 32;
  const int a_k = ((lj >> 1) << 3) + lr, a_m = wm + ((lj & 1) << 3);
  const int b_k = ((lj & 1) << 3) + lr, b_n = wn + ((lj >> 1) << 3);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto compute = [&](int buf) {
    const uint16_t* as = smem + buf * (A_TERMS * A_TILE + B_TERMS * B_TILE);
    const uint16_t* bs = as + A_TERMS * A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // a pair of 8-column tiles
        uint32_t bf[B_TERMS][2][2];
#pragma unroll
        for (int j = 0; j < B_TERMS; ++j) {
          uint32_t r[4];
          ldsm_x4_t(r, smem_addr(bs + j * B_TILE + swz<BN>(kk + b_k, b_n + 16 * np)));
          bf[j][0][0] = r[0];
          bf[j][0][1] = r[1];
          bf[j][1][0] = r[2];
          bf[j][1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t af[A_TERMS][4];
#pragma unroll
          for (int i = 0; i < A_TERMS; ++i)
            ldsm_x4_t(af[i], smem_addr(as + i * A_TILE + swz<BM>(kk + a_k, a_m + 16 * mi)));
          // the k16 step into a fresh f32 sum, smallest products first
          // (i + j = 2, 1, then hi·hi), then one rounded add into the
          // accumulator: the MMA truncates its addends to the grid of the
          // largest, and a fresh sum keeps that grid the step's, not the
          // running total's
          float part[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][e] = 0.f;
#pragma unroll
          for (int ord = B_TERMS - 1; ord >= 0; --ord)
#pragma unroll
            for (int i = 0; i < A_TERMS && i <= ord; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) mma_bf16(part[h], af[i], bf[ord - i][h]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][2 * np + h][e] += part[h][e];
        }
      }
  };

  if (s_begin < s_end) {
    load(s_begin * BK);
    store(0, s_begin * BK);
    __syncthreads();
    for (int st = s_begin; st < s_end; ++st) {
      const int buf = (st - s_begin) & 1;
      const bool more = st + 1 < s_end;
      if (more) load((st + 1) * BK);  // in flight during the MMAs
      compute(buf);
      if (more) store(buf ^ 1, (st + 1) * BK);
      __syncthreads();
    }
  }

  // C fragment: rows lane/4 (+8), columns 2·(lane%4) (+1) of each 16 x 8 tile
  const float mul = S == 1 ? *lam_p : 1.f;
  float* __restrict__ o = out + (size_t)blockIdx.z * d * da;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * mi + gq + 8 * h;
      if (row >= d) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + 8 * ni + 2 * tq;
        if (col < da) o[(size_t)row * da + col] = mul * acc[mi][ni][2 * h];
        if (col + 1 < da) o[(size_t)row * da + col + 1] = mul * acc[mi][ni][2 * h + 1];
      }
    }
}

// dw[i] = λ·Σ_s partial[s][i], the slices summed in slice order
__global__ void dw_reduce(const float* __restrict__ partial, const float* __restrict__ lam_p,
                          float* __restrict__ dw, int S, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += partial[j * n + i];
  dw[i] = *lam_p * s;
}

int slices(int T, int d, int da) {
  const int tiles = ((d + BM - 1) / BM) * ((da + BN - 1) / BN);
  const int steps = (T + BK - 1) / BK;
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (s > steps / MIN_STEPS) s = steps / MIN_STEPS;
  return s < 1 ? 1 : s;
}

template <int KIND>
int launch(const void* b, const void* scale, const void* g, const void* lam, void* dw,
           void* partial, int T, int ld, int d, int da, int qblock, cudaStream_t s) {
  using U = typename Entry<KIND>::U;
  constexpr int A_TERMS = Entry<KIND>::A_TERMS;
  constexpr int smem = 2 * (A_TERMS * A_TILE + B_TERMS * B_TILE) * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {  // above the default: opt in, once per instantiation
    static bool opted = false;
    if (!opted) {
      const cudaError_t e = cudaFuncSetAttribute(
          mix_dw_mma<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      opted = true;
    }
  }
  const int S = slices(T, d, da);
  const int vec_b = (ld * sizeof(U)) % 16 == 0 && (uintptr_t)b % 16 == 0;
  const int vec_g = da % 4 == 0 && (uintptr_t)g % 16 == 0;
  const dim3 grid((da + BN - 1) / BN, (d + BM - 1) / BM, S);
  mix_dw_mma<KIND><<<grid, THREADS, smem, s>>>(b, (const float*)scale, (const float*)g,
                                               (const float*)lam, S == 1 ? (float*)dw
                                                                         : (float*)partial,
                                               T, ld, d, da, qblock, vec_b, vec_g);
  if (S == 1) return (int)cudaGetLastError();
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)d * da;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>((const float*)partial,
                                                        (const float*)lam, (float*)dw, S, n);
  return (int)cudaGetLastError();
}

}  // namespace mixdw

template <int KIND, typename TA>
int launch_fwd(const void* b, const void* scale, const void* w, const void* a, const void* lam,
               void* out, void* bw, void* partial, int T, int ld, int d, int da, int qblock,
               cudaStream_t s) {
  return mixfwd::launch<KIND, float, TA, TA>(b, (const float*)scale, (const float*)w,
                                             (const TA*)a, (const float*)lam, (TA*)out,
                                             (float*)bw, (float*)partial, T, ld, d, da, qblock,
                                             s);
}

template <int KIND>
int launch_fwd_a(int a_bf16, const void* b, const void* scale, const void* w, const void* a,
                 const void* lam, void* out, void* bw, void* partial, int T, int ld, int d,
                 int da, int qblock, cudaStream_t s) {
  return a_bf16 ? launch_fwd<KIND, __nv_bfloat16>(b, scale, w, a, lam, out, bw, partial, T, ld,
                                                  d, da, qblock, s)
                : launch_fwd<KIND, float>(b, scale, w, a, lam, out, bw, partial, T, ld, d, da,
                                          qblock, s);
}

}  // namespace

extern "C" {

// contraction slices of one mix_fwd call: its scratch is (slices, T, da) f32 when > 1
int mix_fwd_slices(int T, int d, int da) { return mixfwd::slices(T, d, da); }

// storage: 0 = f32, 1 = bf16, 2 = int8 (+ scale); a_bf16: a and out are bf16, else f32;
// partial: (mix_fwd_slices(T, d, da), T, da) f32 scratch when that is > 1, else unused
int mix_fwd_launch(const void* b, const void* scale, const void* w, const void* a,
                   const void* lam, void* out, void* bw, void* partial, int T, int ld, int d,
                   int da, int qblock, int storage, int a_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch_fwd_a<mix_tile::F32>(a_bf16, b, scale, w, a, lam, out, bw, partial, T, ld, d,
                                         da, qblock, s);
    case 1:
      return launch_fwd_a<mix_tile::BF16>(a_bf16, b, scale, w, a, lam, out, bw, partial, T, ld,
                                          d, da, qblock, s);
    case 2:
      if (qblock % 16 == 0)  // a k16 step lies in one block: its sum is scaled
        return launch_fwd_a<mix_tile::I8>(a_bf16, b, scale, w, a, lam, out, bw, partial, T, ld,
                                          d, da, qblock, s);
      return launch_fwd_a<mix_tile::I8_DEQ>(a_bf16, b, scale, w, a, lam, out, bw, partial, T, ld,
                                            d, da, qblock, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// token slices of one mix_dw call: its scratch is (slices, d, da) f32 when > 1
int mix_dw_slices(int T, int d, int da) { return mixdw::slices(T, d, da); }

// partial: (mix_dw_slices(T, d, da), d, da) f32 scratch when that is > 1, else unused
int mix_dw_launch(const void* b, const void* scale, const void* g, const void* lam, void* dw,
                  void* partial, int T, int ld, int d, int da, int qblock, int storage,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return mixdw::launch<mix_tile::F32>(b, scale, g, lam, dw, partial, T, ld, d, da, qblock, s);
    case 1: return mixdw::launch<mix_tile::BF16>(b, scale, g, lam, dw, partial, T, ld, d, da, qblock, s);
    case 2:
      if (qblock % mixdw::BM == 0)
        return mixdw::launch<mix_tile::I8>(b, scale, g, lam, dw, partial, T, ld, d, da, qblock, s);
      return mixdw::launch<mix_tile::I8_DEQ>(b, scale, g, lam, dw, partial, T, ld, d, da, qblock, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
