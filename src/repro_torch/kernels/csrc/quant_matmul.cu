// y = x @ dequant(Wq): block-dequant INT8 / packed-INT4 matmul for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py (_kernel /
// quant_matmul). x (M, K) f32 row-major; q (K, N) int8, or (K, N/2) with
// two sign-extended nibbles per byte (low nibble = even column); scale
// (K, N/128) f32, one per (row k, 128-column block); y (M, N) f32.
// N is a multiple of 128 (whole quantization blocks); M and K are ragged
// and masked here (no padding by the caller).
//
// Two paths, chosen by M:
//  * skinny (M <= 8, the decode step): a GEMV bound by the int8 weight
//    bytes, skinny.cuh's, in one launch. Each weight is dequantized as
//    float(q) * scale, the reference's product, and accumulated in f32 on
//    the CUDA cores. A column tile lies in one quantization block (so one
//    scale a weight row); its contraction slices are one thread block
//    cluster, a lane loads 16 codes of a row (16 bytes; 8 codes at M > 4,
//    and 32, 16 or 8 int4 codes), several rows a lane in flight, and the
//    slices are summed in a fixed order through distributed shared memory
//    (deterministic, no scratch, no atomics). At K = 2048, N = 2048 the
//    plan (../skinny.py) is 16 tiles of 128 columns x 8 ranks (3 ranks at
//    N = 8192). One layer's seven projections at M = 1: 0.064–0.068 ms on
//    an H100 at 700 W, against torch.matmul's 0.115–0.120 on the f32
//    weight and the 0.0194 ms byte bound (PERF.md).
//  * tiled (M > 8: prefill, and the epoch-1 training step at M = 2048),
//    qmm_mma on the bf16 tensor cores, below.
//
// The tiled path. What bounds it at the serving prefill (M = 4096) over
// one internlm2-1.8b layer's seven projections, (K, N) = (2048, 2048) x2,
// (2048, 1024) x2, (2048, 8192) x2, (8192, 2048): 0.515 TFLOP of
// products. On the bf16 tensor cores with three products a weight (below)
// that is 1.563 ms at 989 TFLOP/s; the same work in f32 on the CUDA
// cores, which the scalar kernel before this one ran, 7.69 ms at 67
// TFLOP/s. The bytes (x, codes, scales, y: ~0.8 GB) take 0.24 ms at
// 3.35 TB/s. Per shape at M = 4096 the tensor-core bound is 0.104 / 0.052 /
// 0.417 / 0.417 ms for (2048, 2048) / (2048, 1024) / (2048, 8192) /
// (8192, 2048).
//
// The scale is per (row k, 128-column block nb), so along the contraction
// it changes at every k: it cannot scale a k16 step's sum (cached_mix.cu's
// mix_fwd can, its scale holds over 16 k), and it cannot fold into the
// codes (q·s is not exact in bf16). It folds into x, once per
// quantization block: a[m, k] = f32(x[m, k]·s[k, nb]), and then
// y[:, block nb] = a @ codes[:, block nb], with the codes exact in bf16
// (int8 and int4 alike) and a split in three bf16 terms as it is staged,
// hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid): 3 products a
// k16 step. a depends on nb, so it cannot be split once per call (at
// M = 4096, N = 8192 its planes would be 3.2 GB); the split serves one
// block's 128 columns, so the tile is exactly one quantization block
// wide, BN = 128.
//  * Tile: a block of 4 warps owns BM x BN = 64 x 128 outputs, a warp 32
//    x 64 (2 x 8 MMA tiles: 6 ldmatrix of A and 4 of B a k16 step for 48
//    MMAs), and walks the whole contraction, BK = 32 a step. Each output
//    is written once, with no split-K and no atomics: reruns are
//    bit-equal. A thread holds 64 accumulators and 32 fresh sums (255
//    registers), so an SM runs 2 blocks (40 KB of shared memory each):
//    while one block converts and stores its next step, the other's MMAs
//    run. 128-row tiles of 8 warps, one block an SM, measured 6–12 %
//    slower (../qmm_variants.py). Blocks and waves of 2 x 132 block slots
//    for (K, N) = (2048, 2048) / (2048, 1024) / (2048, 8192) / (8192,
//    2048): M = 2048 (training) 512 / 256 / 2048 / 512 blocks, 1.94 /
//    0.97 / 7.76 / 1.94 waves; M = 4096 (serving) 1024 / 512 / 4096 /
//    1024 blocks, 3.88 / 1.94 / 15.52 / 3.88 waves. Column blocks are the
//    fastest grid index, so the blocks that share an x row block run
//    together.
//  * A = x·s: x rows are row-major with k contiguous, the MMA's A layout.
//    16 bytes a thread where the row allows (K % 4 == 0, x aligned), else
//    element by element; masked at M and K. Each lane loads one of the
//    step's 32 scales s[k, nb] and a warp shuffle hands every thread the
//    four of its k; the product is rounded to f32 (__fmul_rn: no
//    contraction into the split), split (mix_tile.cuh's split3) and
//    stored to XOR-swizzled rows, read by ldmatrix without .trans.
//  * B = the codes, whole: q (K, N) row-major, 16 codes a thread (8 bytes
//    at int4), converted to exact bf16 by byte permutes (codes_bf16,
//    nibbles_bf16), stored in swizzled [k][n] rows and read by
//    ldmatrix.trans. Rows >= K are zero.
//  * MMA: mma.sync m16n8k16, bf16 operands, f32 accumulators. Each k16
//    step's three products (lo, mid, then hi) go into a fresh f32 sum,
//    which one add puts into the accumulator: the tensor core truncates
//    its addends to the grid of the largest one (mix_tile.cuh's note).
//  * Overlap: the global loads of step i+1 go to registers before the
//    MMAs of step i, and are scaled, split, converted and stored to the
//    other of two shared-memory buffers after them; one barrier a step.
//  What holds it (chip_smoke.py, ../qmm_variants.py; NVIDIA H100 80GB
//  HBM3, 700 W): 0.40–0.41 ms at M = 4096, K = N = 2048, 3.9x its
//  tensor-core bound and 0.60x torch.matmul on the dequantized f32
//  weight; one layer's seven projections 6.00 ms at M = 4096 (3.02 at
//  M = 2048). Without its MMAs the loop takes 0.20 ms (the loads, the
//  split, the code conversion and ldmatrix: a = x·s is written to shared
//  memory as three terms and read by both warps of a row, 36 of the 60
//  KB a block moves through shared memory a step); the hi product adds
//  0.11 and the two others ~0.05 each, overlapping little, as in
//  lmhead_ce.cu's loop. wgmma with TMA is the next step.
// The loop is its own, not mix_tile.cuh's mixfwd loop with two more
// operand kinds: that loop's tile is 64 columns wide (half a quantization
// block, so the split would be made twice per x tile), scales by token
// row, and cuts the contraction into slices; this one needs none of it,
// and leaves the header, and so the other libraries, unchanged.
//
// Tolerance. The reference dequantizes in f32 (f32(q·s)) and sums x·w in
// f32; the kernel rounds x·s in f32 instead, and its three terms carry
// that f32 value whole (~24 significant bits) to the tensor cores.
// Emulated on the CPU with float64 sums
// (tests/test_torch_kernels.py::test_quant_matmul_bf16_split_error_model;
// K = 8192, M = 64, N = 256, and M = 37, K = 1000, N = 384; int8 and
// int4): three terms err 1.7e-7–2.0e-7 against the exact product, under
// the plain f32 version's own 1.5e-6–2.0e-6; two terms 9.4e-6–1.0e-5
// (5x the plain version); one term 6.5e-3–7.7e-3, which misses the
// check. So the kernel takes three, and is held to the reference's f32
// atol 1e-3 + rtol 1e-4 (tests/test_kernels.py:38).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"
#include "skinny.cuh"

namespace {

constexpr int QBLOCK = 128;

// ----------------------------------------------------------------- tiled
namespace tiled {

using namespace mix_tile;

constexpr int WARPS_M = 2, WARPS_N = 2;     // 4 warps
constexpr int WTM = 32, WTN = 64;           // a warp's tile: rows of x x columns
constexpr int MI = WTM / 16, NI = WTN / 8;  // its MMA tiles
constexpr int BM = WTM * WARPS_M;           // rows of x per block
constexpr int BN = WTN * WARPS_N;           // columns per block: one quantization block
constexpr int BK = 32;                      // contraction per step: one scale a lane
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int TERMS = 3;                    // bf16 terms of a = x·s
constexpr int A_TILE = BM * BK;             // bf16 values of one staged A term
constexpr int B_TILE = BK * BN;             // bf16 values of the staged codes
constexpr int STAGE = TERMS * A_TILE + B_TILE;
constexpr int SMEM = 2 * STAGE * (int)sizeof(uint16_t);  // two buffers, 40 KB
constexpr int XPR = BK / 4;                 // 16-byte x chunks per staged row
constexpr int X_CH = BM * XPR / THREADS;    // x chunks per thread per step
constexpr int QPR = BN / 16;                // 16-code chunks per staged row
constexpr int Q_CH = BK * QPR / THREADS;    // code chunks per thread per step
constexpr int MIN_BLOCKS = 256 / THREADS;   // per SM, at 255 registers a thread
static_assert(BN == QBLOCK, "a tile is one quantization block wide");
static_assert(BK == 32, "one scale a lane");
static_assert(THREADS % XPR == 0 && THREADS % QPR == 0, "a thread's chunks share their columns");
static_assert(X_CH * THREADS == BM * XPR && Q_CH * THREADS == BK * QPR && NI % 2 == 0,
              "whole tiles");

// sixteen int4 codes (two a byte, the low nibble the even column) -> their
// exact bf16 values in column order, in two 16-byte chunks
__device__ __forceinline__ void nibbles_bf16(uint32_t w0, uint32_t w1, uint4& lo, uint4& hi) {
  const uint32_t w[2] = {w0, w1};
  uint32_t p[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t ev = (w[h] & 0x0F0F0F0Fu) ^ 0x08080808u;         // code + 8, even columns
    const uint32_t od = ((w[h] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // code + 8, odd columns
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float e = __uint_as_float(__byte_perm(ev, 0x4B000000u, 0x7650 + b)) - 8388616.f;
      const float o = __uint_as_float(__byte_perm(od, 0x4B000000u, 0x7650 + b)) - 8388616.f;
      p[4 * h + b] = pack_hi(e, o);
    }
  }
  lo = make_uint4(p[0], p[1], p[2], p[3]);
  hi = make_uint4(p[4], p[5], p[6], p[7]);
}

// One BM x BN output tile per block, the whole contraction: grid
// (N / BN, ceil(M / BM)). vec_x: x rows take 16-byte loads; vec_q: code
// rows take 16-byte (int8) or 8-byte (int4) loads.
template <int BITS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
qmm_mma(const float* __restrict__ x, const int8_t* __restrict__ q,
        const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
        int vec_x, int vec_q) {
  extern __shared__ __align__(16) uint16_t smem[];  // 2 x (A terms, codes)
  const uint32_t* __restrict__ xw = reinterpret_cast<const uint32_t*>(x);
  const uint8_t* __restrict__ qb = reinterpret_cast<const uint8_t*>(q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = blockIdx.x, n0 = nb * BN, m0 = blockIdx.y * BM;
  const int nsb = N / QBLOCK;
  const int ldq = BITS == 8 ? N : N / 2;      // bytes of a code row
  const int xk = (tid % XPR) * 4;             // the k columns of this thread's x chunks
  const int qk = tid / QPR, qn = (tid % QPR) * 16;  // its first code chunk: row, column

  uint4 xr[X_CH], qr[Q_CH];
  float sr;

  // global -> registers: x's BM x BK tile at (m0, k0), the codes' BK x BN
  // tile at (k0, n0), and the scale s[k0 + lane, nb]
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_CH; ++i) {
      const int gm = m0 + tid / XPR + i * (THREADS / XPR);
      xr[i] = gm < M ? load_chunk(xw + (size_t)gm * K, k0 + xk, K, vec_x) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < Q_CH; ++i) {
      const int gk = k0 + qk + i * (THREADS / QPR);
      qr[i] = make_uint4(0, 0, 0, 0);
      if (gk >= K) continue;
      const uint8_t* row = qb + (size_t)gk * ldq;
      if constexpr (BITS == 8) {
        qr[i] = load_chunk(row, n0 + qn, N, vec_q);
      } else {
        const uint8_t* p = row + (n0 + qn) / 2;
        if (vec_q) {
          const uint2 v = *reinterpret_cast<const uint2*>(p);
          qr[i].x = v.x, qr[i].y = v.y;
        } else {
          qr[i].x = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
          qr[i].y = p[4] | (p[5] << 8) | (p[6] << 16) | ((uint32_t)p[7] << 24);
        }
      }
    }
    sr = k0 + lane < K ? scale[(size_t)(k0 + lane) * nsb + nb] : 0.f;
  };

  // registers -> shared buffer `buf`: a = x·s split in three terms, the
  // codes as exact bf16, in swizzled rows
  auto store = [&](int buf) {
    uint16_t* as = smem + buf * STAGE;
    uint16_t* bs = as + TERMS * A_TILE;
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = __shfl_sync(0xffffffffu, sr, xk + e);
#pragma unroll
    for (int i = 0; i < X_CH; ++i) {
      const int t = tid / XPR + i * (THREADS / XPR);
      uint32_t w01[3], w23[3];
      split3(__fmul_rn(__uint_as_float(xr[i].x), s[0]), __fmul_rn(__uint_as_float(xr[i].y), s[1]),
             w01);
      split3(__fmul_rn(__uint_as_float(xr[i].z), s[2]), __fmul_rn(__uint_as_float(xr[i].w), s[3]),
             w23);
#pragma unroll
      for (int j = 0; j < TERMS; ++j)
        *reinterpret_cast<uint2*>(as + j * A_TILE + swz<BK>(t, xk)) = make_uint2(w01[j], w23[j]);
    }
#pragma unroll
    for (int i = 0; i < Q_CH; ++i) {
      const int kr = qk + i * (THREADS / QPR);
      uint4 lo, hi;
      if constexpr (BITS == 8)
        codes_bf16(qr[i], lo, hi);
      else
        nibbles_bf16(qr[i].x, qr[i].y, lo, hi);
      *reinterpret_cast<uint4*>(bs + swz<BN>(kr, qn)) = lo;
      *reinterpret_cast<uint4*>(bs + swz<BN>(kr, qn + 8)) = hi;
    }
  };

  // ldmatrix row of this lane (mix_tile.cuh's forward has the layout):
  // A from [row][k] rows; B from [k][n] rows, transposed
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

  auto compute = [&](int buf) {
    const uint16_t* as = smem + buf * STAGE;
    const uint16_t* bs = as + TERMS * A_TILE;
#pragma unroll
    for (int sub = 0; sub < BK / 16; ++sub) {
      const int kk = 16 * sub;
      uint32_t bf[NI][2];  // the warp's 8-column tiles of codes
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, smem_addr(bs + swz<BN>(kk + b_k, b_n + 16 * np)));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[TERMS][4];
#pragma unroll
        for (int i = 0; i < TERMS; ++i)
          ldsm_x4(af[i], smem_addr(as + i * A_TILE + swz<BK>(a_t + 16 * mi, kk + a_k)));
        // the k16 step into a fresh f32 sum, smallest term first
        float part[NI][4];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[ni][e] = 0.f;
#pragma unroll
        for (int i = TERMS - 1; i >= 0; --i)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(part[ni], af[i], bf[ni]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[ni][e];
      }
    }
  };

  const int steps = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < steps;
    if (more) load((st + 1) * BK);  // in flight during the MMAs
    compute(buf);
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * mi + gq + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        *reinterpret_cast<float2*>(out + (size_t)row * N + n0 + wn + 8 * ni + 2 * tq) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// returns a cudaError_t
template <int BITS>
int launch(const float* x, const int8_t* q, const float* scale, float* out, int M, int K, int N,
           cudaStream_t stream) {
  static bool opted = false;  // above 48 KB of shared memory: opt in, once per instantiation
  if (SMEM > 48 * 1024 && !opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(qmm_mma<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int vec_x = K % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int vec_q = (uintptr_t)q % (BITS == 8 ? 16 : 8) == 0;
  qmm_mma<BITS><<<dim3(N / BN, (M + BM - 1) / BM), THREADS, SMEM, stream>>>(
      x, q, scale, out, M, K, N, vec_x, vec_q);
  return (int)cudaGetLastError();
}

}  // namespace tiled

template <int BITS>
int launch(const float* x, const int8_t* q, const float* scale, float* out, int M, int K, int N,
           int ranks, int cols, cudaStream_t stream) {
  if (M > skinny::MAX_ROWS) return tiled::launch<BITS>(x, q, scale, out, M, K, N, stream);
  return skinny::launch<BITS == 8 ? skinny::I8 : skinny::I4>(x, q, scale, skinny::Store{out}, M,
                                                             K, N, ranks, cols, stream);
}

}  // namespace

extern "C" {

// ranks, cols: the skinny path's plan (M <= 8; ../skinny.py), else unused
int qmm_launch(const void* x, const void* q, const void* scale, void* out, int M, int K, int N,
               int bits, int ranks, int cols, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 8)
    return launch<8>((const float*)x, (const int8_t*)q, (const float*)scale, (float*)out, M, K,
                     N, ranks, cols, s);
  if (bits == 4)
    return launch<4>((const float*)x, (const int8_t*)q, (const float*)scale, (float*)out, M, K,
                     N, ranks, cols, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
