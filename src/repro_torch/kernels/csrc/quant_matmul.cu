// y = x @ dequant(Wq): block-dequant INT8 / packed-INT4 matmul for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py (_kernel /
// quant_matmul). x (M, K) f32 row-major; q (K, N) int8, or (K, N/2) with
// two sign-extended nibbles per byte (low nibble = even column); scale
// (K, N/128) f32, one per (row k, 128-column block); y (M, N) f32.
// N is a multiple of 128 (whole quantization blocks); M and K are ragged
// and masked here (no padding by the caller).
//
// Each weight is dequantized as float(q) * scale, the reference's exact
// product, and accumulated in f32 on the CUDA cores.
//
// Two paths, chosen by M:
//  * skinny (M <= 8, the decode step): a GEMV bound by the int8 weight
//    bytes. A block owns 128 columns (one quantization block, so one
//    scale per weight row) and a 128-row slice of K; each warp reads
//    whole 128-byte weight rows (4 bytes a lane), x sits in shared
//    memory. The K slices are summed in a fixed order by a second small
//    kernel (deterministic, no atomics).
//  * tiled (M > 8, prefill): 64x128 output tiles, K in steps of 32; the
//    x tile and the dequantized weight tile are staged in shared memory,
//    each thread accumulates a 4x8 register tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 128;

// ---------------------------------------------------------------- skinny
constexpr int SK_ROWS = 8;     // max M on this path
constexpr int SK_COLS = 128;   // columns per block (= QBLOCK)
constexpr int SK_WARPS = 8;    // k-lanes per block
constexpr int SK_KCHUNK = 128; // weight rows per block
constexpr int SK_THREADS = 32 * SK_WARPS;

template <int BITS>
__device__ __forceinline__ void load4(const int8_t* __restrict__ q, size_t row, int N, int col,
                                      float w[4]) {
  if (BITS == 8) {
    char4 v = *reinterpret_cast<const char4*>(q + row * N + col);
    w[0] = (float)v.x; w[1] = (float)v.y; w[2] = (float)v.z; w[3] = (float)v.w;
  } else {
    // two bytes hold columns col..col+3: lo/hi nibble of byte 0, then byte 1
    const uint8_t* p = reinterpret_cast<const uint8_t*>(q) + row * (N / 2) + col / 2;
    uchar2 v = *reinterpret_cast<const uchar2*>(p);
    int b0 = v.x, b1 = v.y;
    int n0 = b0 & 0xF, n1 = (b0 >> 4) & 0xF, n2 = b1 & 0xF, n3 = (b1 >> 4) & 0xF;
    w[0] = (float)(n0 >= 8 ? n0 - 16 : n0);
    w[1] = (float)(n1 >= 8 ? n1 - 16 : n1);
    w[2] = (float)(n2 >= 8 ? n2 - 16 : n2);
    w[3] = (float)(n3 >= 8 ? n3 - 16 : n3);
  }
}

template <int BITS>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, float* __restrict__ partial,
           int M, int K, int N) {
  __shared__ float xs[SK_ROWS][SK_KCHUNK];
  __shared__ float red[SK_WARPS][SK_ROWS][SK_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * SK_COLS;
  const int kbeg = blockIdx.y * SK_KCHUNK;
  const int nsb = N / QBLOCK;
  for (int idx = threadIdx.x; idx < SK_ROWS * SK_KCHUNK; idx += SK_THREADS) {
    int m = idx / SK_KCHUNK, kk = idx % SK_KCHUNK;
    xs[m][kk] = (m < M && kbeg + kk < K) ? x[(size_t)m * K + kbeg + kk] : 0.f;
  }
  __syncthreads();
  float acc[SK_ROWS][4];
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  const int col = n0 + lane * 4;
#pragma unroll 4
  for (int kk = warp; kk < SK_KCHUNK; kk += SK_WARPS) {
    const int k = kbeg + kk;
    if (k >= K) break;
    const float s = scale[(size_t)k * nsb + blockIdx.x];
    float w[4];
    load4<BITS>(q, (size_t)k, N, col, w);
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = w[c] * s;
#pragma unroll
    for (int m = 0; m < SK_ROWS; ++m) {
      const float xv = xs[m][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] += xv * w[c];
    }
  }
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int o = threadIdx.x; o < M * SK_COLS; o += SK_THREADS) {
    const int m = o / SK_COLS, c = o % SK_COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) s += red[w][m][c];
    partial[((size_t)blockIdx.y * M + m) * N + n0 + c] = s;
  }
}

// out[m, n] = sum over K slices, in slice order
__global__ void qmm_reduce(const float* __restrict__ partial, float* __restrict__ out,
                           int splits, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[(size_t)j * MN + i];
  out[i] = s;
}

// ----------------------------------------------------------------- tiled
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int TILE_THREADS = 256;  // 16 x 16; thread (ty, tx) owns rows ty+16i, cols tx+16j

template <int BITS>
__global__ void __launch_bounds__(TILE_THREADS)
qmm_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, float* __restrict__ out,
          int M, int K, int N) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed
  __shared__ float ws[BK][BN];      // dequantized weight tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nsb = N / QBLOCK;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += TILE_THREADS) {
      const int m = idx / BK, kk = idx % BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * (BN / 4); idx += TILE_THREADS) {
      const int kk = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
      const int gk = k0 + kk;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < K) {
        load4<BITS>(q, (size_t)gk, N, n0 + c4, w);
        const float s = scale[(size_t)gk * nsb + (n0 + c4) / QBLOCK];
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = w[c] * s;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) ws[kk][c4 + c] = w[c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(size_t)gm * N + n0 + tx + 16 * j] = acc[i][j];
  }
}

template <int BITS>
void launch(const float* x, const int8_t* q, const float* scale, float* out, float* partial,
            int M, int K, int N, cudaStream_t stream) {
  if (M <= SK_ROWS) {
    const int splits = (K + SK_KCHUNK - 1) / SK_KCHUNK;
    qmm_skinny<BITS><<<dim3(N / SK_COLS, splits), SK_THREADS, 0, stream>>>(
        x, q, scale, partial, M, K, N);
    const int MN = M * N;
    qmm_reduce<<<(MN + 255) / 256, 256, 0, stream>>>(partial, out, splits, MN);
  } else {
    qmm_tiled<BITS><<<dim3(N / BN, (M + BM - 1) / BM), TILE_THREADS, 0, stream>>>(
        x, q, scale, out, M, K, N);
  }
}

}  // namespace

extern "C" {

// Rows of x at or below which the skinny path runs; its K-slice count
// sizes the caller's partial-sum scratch (splits * M * N floats).
int qmm_skinny_rows() { return SK_ROWS; }
int qmm_kchunk() { return SK_KCHUNK; }

int qmm_launch(const void* x, const void* q, const void* scale, void* out, void* partial,
               int M, int K, int N, int bits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 8)
    launch<8>((const float*)x, (const int8_t*)q, (const float*)scale, (float*)out,
              (float*)partial, M, K, N, s);
  else if (bits == 4)
    launch<4>((const float*)x, (const int8_t*)q, (const float*)scale, (float*)out,
              (float*)partial, M, K, N, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
