// The decode path's GEMV, out = epilogue(x @ W) for at most 8 rows of x,
// in one launch: adapter_fuse.cu's T <= 8 path (f32 or bf16 W, the λ-mix
// epilogue) and quant_matmul.cu's M <= 8 path (int8 or packed int4 codes
// with one f32 scale per (row k, 128-column block), y = s).
//
// What bounds it on the H100: the weight's bytes. At M <= 8 each weight
// is used by at most 8 FMAs, so the call reads W once at 3.35 TB/s at
// best (adapter_fuse at d = 2048, d_a = 256 in f32: 2.1 MB, 0.63 µs;
// one internlm2-1.8b layer's seven int8 projections: 65 MB, 19.4 µs),
// and a small call is bound by its latency. Timed on an H100 at 700 W
// in a CUDA graph (../skinny_variants.py, PERF.md): an empty kernel takes
// 1.4–1.7 µs a call, a cluster barrier adds 0.4–0.6 µs, and a plain read
// of 2 / 4 / 16 MB with 16-byte loads takes 3.4 / 4.6 / 8.5 µs; this
// kernel takes 5.0–5.3 µs at the adapter_fuse shape. So one launch, one
// wave of blocks and no cluster-wide wait matter as much as the bytes.
//
// Grid: (ranks, column tiles). The ranks of one column tile are one
// thread block cluster (cudaLaunchKernelEx with a cluster dimension;
// ranks <= 8, the portable size), and each owns a contiguous slice of the
// contraction, ceil(K / ranks) rows.
//  * A block of 8 warps stages its slice of x (f32, or bf16 taps) into
//    shared memory, X_FLOATS values at a time, and streams its weight
//    rows: a lane loads one vector of Lane::COLS columns of a row, 16
//    bytes (4 f32, 8 bf16, 16 int8 or 32 int4 codes), fewer where ROWS x
//    Lane::COLS would pass MAX_ACC accumulators (int8 at ROWS = 8, int4
//    at ROWS >= 4). cols / Lane::COLS lanes cover a row of the tile; the other
//    lanes of the block take the next rows, BATCH rows a lane whose loads
//    are all issued before their FMAs (64–128 bytes a lane in flight). A
//    second batch in flight during the FMAs (two in registers) measured no
//    faster at M = 1 and slower at M = 8 (PERF.md).
//  * Each weight is dequantized as float(q) * s, the reference's product
//    rounded to f32, and accumulated in f32 on the CUDA cores: no tensor
//    cores, since at M <= 8 the bytes bound the call.
//  * A row of a weight that is not 16-byte aligned (adapter_fuse's d_a %
//    4 != 0 in f32 or % 8 != 0 in bf16, or a misaligned base) is read
//    element by element into the same vector (the kernel's VEC = false).
//  * The first batch of a lane's weight rows is in flight while x is
//    staged, and a thread's x loads (X_FLOATS / THREADS at most) are all
//    in flight at once; x's rows past M are never staged (they feed
//    accumulators that are never stored).
// Reduce, in a fixed order: a warp's row lanes by a butterfly of shuffles,
// then the block's warps in warp order; rank r owns a 1/ranks share of the
// tile's outputs, and every rank stores its sums for that share into rank
// r's shared memory (distributed shared memory, st.async, in the sender's
// slot), each store counted by rank r's transaction barrier (mbarrier).
// Rank r waits on its own barrier alone, not on the cluster's, then sums
// the slots in rank order 0..ranks-1 and the epilogue writes the output.
// A cluster barrier's arrive at the start (after each block has set its
// transaction barrier), waited on before the first store, makes sure every
// block of the cluster runs; a block exits only once what it awaits has
// landed, and stores nothing after that. One rank (a tile's whole
// contraction in one block) skips all of it. No global scratch, no
// atomics, no counters: two calls are bit-equal, and a call can be
// captured in a CUDA graph and run on any stream.
//
// The tile and rank counts are the caller's (../skinny.py: `plan`, which
// the CPU tests use to model this order); `launch` checks them.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal to each library that includes it (two of them load into one
// process).
namespace {

namespace skinny {

namespace cg = cooperative_groups;

constexpr int MAX_ROWS = 8;    // rows of x at most
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_COLS = 128;  // a tile's columns at most: one quantization block
constexpr int MAX_RANKS = 8;   // the portable cluster size
constexpr int MAX_ACC = 64;    // f32 accumulators a lane holds
constexpr int BATCH = 8;       // rows a lane loads before their FMAs
constexpr int X_FLOATS = 2048; // staged x values a block holds (ROWS x X_FLOATS / ROWS)

// weight element kinds, by their bits
constexpr int F32 = 32, BF16 = 16, I8 = 8, I4 = 4;

template <int KIND, int ROWS>
struct Lane {
  static constexpr int VEC_COLS = 128 / KIND;  // one 16-byte vector
  static constexpr int COLS = VEC_COLS < MAX_ACC / ROWS ? VEC_COLS : MAX_ACC / ROWS;
  static constexpr int BYTES = COLS * KIND / 8;  // 16, 8 or 4
  static constexpr int WORDS = BYTES / 4;
  static constexpr bool SCALED = KIND == I8 || KIND == I4;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int WORDS>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&r)[WORDS]) {
  if constexpr (WORDS == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (WORDS == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// the bits of element n of row k (row-major, N elements a row) — the
// scalar path's load; an int4 element is its nibble (low = even column)
template <int KIND>
__device__ __forceinline__ uint32_t elem_bits(const void* w, size_t k, int N, int n) {
  if constexpr (KIND == F32) {
    return __ldg(reinterpret_cast<const unsigned int*>(w) + k * N + n);
  } else if constexpr (KIND == BF16) {
    return __ldg(reinterpret_cast<const unsigned short*>(w) + k * N + n);
  } else if constexpr (KIND == I8) {
    return (uint8_t)__ldg(reinterpret_cast<const char*>(w) + k * N + n);
  } else {
    const uint32_t b = (uint8_t)__ldg(reinterpret_cast<const char*>(w) + k * (N / 2) + n / 2);
    return (n & 1) ? b >> 4 : b & 0xF;
  }
}

// a vector's words to its COLS values, in column order
template <int KIND, int COLS, int WORDS>
__device__ __forceinline__ void decode(const uint32_t (&r)[WORDS], float (&w)[COLS]) {
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    if constexpr (KIND == F32) {
      w[i] = __uint_as_float(r[i]);
    } else if constexpr (KIND == BF16) {
      w[2 * i] = __uint_as_float(r[i] << 16);
      w[2 * i + 1] = __uint_as_float(r[i] & 0xFFFF0000u);
    } else if constexpr (KIND == I8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[4 * i + j] = (float)((int)(r[i] << (24 - 8 * j)) >> 24);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[8 * i + j] = (float)((int)(r[i] << (28 - 4 * j)) >> 28);
    }
  }
}

// The cluster barrier in its two halves (PTX barrier.cluster): every
// thread of every block of the cluster arrives, then waits for all.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A shared-memory transaction barrier (PTX mbarrier) that completes once
// `bytes` have landed through st.async, from any block of the cluster.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(  // the labels are local to the braces' scope
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      " @!p bra WAIT;\n}\n" ::"r"(a)
      : "memory");
}
// v into block `rank`'s copy of *dst, counted by its copy of *bar
__device__ __forceinline__ void push(float* dst, uint64_t* bar, int rank, float v) {
  uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(d) : "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(b) : "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               ::"r"(d), "f"(v), "r"(b) : "memory");
}

// The epilogues. pre() is called at the kernel's start for the outputs a
// thread will write, so that what the epilogue reads from device memory is
// in flight with the weights and not after the reduce.

// y[m, n] = s
struct Store {
  float* out;
  struct Pre {};
  __device__ __forceinline__ Pre pre(int, int, int) const { return {}; }
  __device__ __forceinline__ void operator()(int m, int n, int N, float s, Pre) const {
    out[(size_t)m * N + n] = s;
  }
};

// out[m, n] = λ·s + (1−λ)·a[m, n], rounded once to out's type; λ read
// from device memory
template <typename TO>
struct Mix {
  const void* a;
  int a_bf16;
  const float* lam;
  TO* out;
  struct Pre {
    float l, av;
  };
  __device__ __forceinline__ Pre pre(int m, int n, int N) const {
    const size_t i = (size_t)m * N + n;
    return {*lam, a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i])
                         : static_cast<const float*>(a)[i]};
  }
  __device__ __forceinline__ void operator()(int m, int n, int N, float s, Pre p) const {
    const float v = p.l * s + (1.f - p.l) * p.av;
    if constexpr (sizeof(TO) == 4) out[(size_t)m * N + n] = v;
    else out[(size_t)m * N + n] = __float2bfloat16(v);
  }
};

// x (M, K) row-major, TX = float or bf16; w (K, N) row-major of KIND (int4:
// (K, N / 2) bytes); scale (K, N / 128) f32 for the scaled kinds, else
// unused; M <= ROWS. cols: the tile's columns; VEC: rows load as vectors.
template <int KIND, int ROWS, bool VEC, typename TX, typename Out>
__global__ void __launch_bounds__(THREADS, 2)
gemv(const TX* __restrict__ x, const void* __restrict__ w, const float* __restrict__ scale,
     Out out, int M, int K, int N, int cols) {
  using L = Lane<KIND, ROWS>;
  constexpr int XCH = X_FLOATS / ROWS;
  __shared__ float xs[ROWS][XCH];
  __shared__ float red[WARPS][ROWS][MAX_COLS];
  __shared__ float recv[ROWS * MAX_COLS + MAX_RANKS];  // the ranks' sums of this rank's share
  __shared__ uint64_t landed;                          // counts recv's bytes as they land
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lpr = cols / L::COLS;  // lanes a row: a power of two <= 32
  const int per_warp = 32 / lpr;   // row lanes a warp
  const int rl = warp * per_warp + lane / lpr;
  const int row_lanes = WARPS * per_warp;
  const int c0 = (lane % lpr) * L::COLS;  // this lane's first column in the tile
  const int n0 = blockIdx.y * cols;
  const int n = n0 + c0;
  const int ks = (K + ranks - 1) / ranks;
  const int kbeg = rank * ks;
  const int kend = min(K, kbeg + ks);
  const int nsb = N / 128;
  const int sb = n0 / 128;
  const size_t row_bytes = (size_t)N * KIND / 8;
  const char* wb = static_cast<const char*>(w) + (size_t)n * KIND / 8;

  // this rank owns the tile's outputs [rank * share, (rank + 1) * share)
  const int total = M * cols;
  const int share = (total + ranks - 1) / ranks;
  if (ranks > 1) {
    // recv expects every rank's sums of this rank's share; the barrier's
    // arrive (waited on before the first push) says it is ready for them
    if (threadIdx.x == 0)
      bar_init(&landed, 4u * ranks * max(0, min(total, (rank + 1) * share) - rank * share));
    cluster_arrive_relaxed();
  }
  // what the epilogue of this rank's share reads, loaded now
  constexpr int PRE = (ROWS * MAX_COLS + THREADS - 1) / THREADS;
  typename Out::Pre pre[PRE];
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int j = threadIdx.x + i * THREADS, o = rank * share + j;
    if (j < share && o < total && n0 + o % cols < N) pre[i] = out.pre(o / cols, n0 + o % cols, N);
  }

  float acc[ROWS][L::COLS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int c = 0; c < L::COLS; ++c) acc[m][c] = 0.f;

  // BATCH of this lane's rows (j0, j0 + row_lanes, ...) of the chunk at
  // k0: their loads all issue before any FMA uses them
  uint32_t raw[BATCH][L::WORDS];
  float sc[BATCH];
  auto load_batch = [&](int k0, int nr, int j0) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int kk = j0 + u * row_lanes;
      const size_t k = (size_t)(k0 + kk);
#pragma unroll
      for (int i = 0; i < L::WORDS; ++i) raw[u][i] = 0u;
      sc[u] = 1.f;
      if (kk < nr && n < N) {
        if constexpr (VEC) {
          load_words<L::WORDS>(wb + k * row_bytes, raw[u]);
        } else {
#pragma unroll
          for (int c = 0; c < L::COLS; ++c)
            if (n + c < N)
              raw[u][c * KIND / 32] |= elem_bits<KIND>(w, k, N, n + c) << ((c * KIND) % 32);
        }
        if constexpr (L::SCALED) sc[u] = __ldg(scale + k * nsb + sb);
      }
    }
  };
  // the FMAs of the loaded batch, rows in order
  auto fma_batch = [&](int nr, int j0) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int kk = j0 + u * row_lanes;
      if (kk < nr) {
        float wv[L::COLS];
        decode<KIND, L::COLS, L::WORDS>(raw[u], wv);
        if constexpr (L::SCALED) {
#pragma unroll
          for (int c = 0; c < L::COLS; ++c) wv[c] = __fmul_rn(wv[c], sc[u]);
        }
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < L::COLS; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
    }
  };

  for (int k0 = kbeg; k0 < kend; k0 += XCH) {
    const int nr = min(XCH, kend - k0);
    load_batch(k0, nr, rl);           // in flight while x is staged
    if (k0 != kbeg) __syncthreads();  // the last chunk's x is read
    // all of a thread's x loads in flight at once; rows m >= M of xs stay
    // unset: they feed only accumulators that are never stored
    float xl[ROWS][XCH / THREADS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int j = 0; j < XCH / THREADS; ++j) {
        const int kk = threadIdx.x + j * THREADS;
        if (m < M && kk < nr) xl[m][j] = to_f32(x[(size_t)m * K + k0 + kk]);
      }
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int j = 0; j < XCH / THREADS; ++j) {
        const int kk = threadIdx.x + j * THREADS;
        if (m < M && kk < nr) xs[m][kk] = xl[m][j];
      }
    __syncthreads();
    for (int j0 = rl; j0 < nr; j0 += BATCH * row_lanes) {
      if (j0 != rl) load_batch(k0, nr, j0);
      fma_batch(nr, j0);
    }
  }

  // a warp's row lanes, by a butterfly; lanes < lpr hold the warp's sums
  for (int off = lpr; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int c = 0; c < L::COLS; ++c)
        acc[m][c] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][c], off);
  if (lane < lpr) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int c = 0; c < L::COLS; ++c) red[warp][m][c0 + c] = acc[m][c];
  }
  __syncthreads();
  if (ranks == 1) {  // one block a tile: its warps' sums, in warp order, are the output
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int o = threadIdx.x + i * THREADS;
      if (o >= total || n0 + o % cols >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) v += red[q][o / cols][o % cols];
      out(o / cols, n0 + o % cols, N, v, pre[i]);
    }
    return;
  }
  // the block's warps in warp order, each sum pushed into the shared memory
  // of the rank that owns its output (rank r owns the tile's outputs
  // [r * share, (r + 1) * share)), in this rank's slot
  cluster_wait();  // every block of the cluster runs, its barrier set
  for (int o = threadIdx.x; o < total; o += THREADS) {
    const int m = o / cols, c = o % cols, owner = o / share;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) v += red[q][m][c];
    push(&recv[rank * share + (o - owner * share)], &landed, owner, v);
  }
  bar_wait(&landed);  // every rank's sums of this share have landed
  // this rank's share: the ranks' sums in rank order, then the epilogue.
  // No block touches another's shared memory after its own pushes, and
  // none exits before what it awaits has landed.
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int j = threadIdx.x + i * THREADS, o = rank * share + j;
    if (j >= share || o >= total || n0 + o % cols >= N) continue;
    float v = 0.f;
    for (int q = 0; q < ranks; ++q) v += recv[q * share + j];
    out(o / cols, n0 + o % cols, N, v, pre[i]);
  }
}

// One launch at (M, K, N) with the caller's ranks and tile columns (see
// the header note); returns a cudaError_t.
template <int KIND, int ROWS, typename TX, typename Out>
int launch_rows(const TX* x, const void* w, const float* scale, Out out, int M, int K, int N,
                int ranks, int cols, cudaStream_t stream) {
  using L = Lane<KIND, ROWS>;
  const int lpr = cols / L::COLS;
  if (ranks < 1 || ranks > MAX_RANKS || cols < L::COLS || cols > MAX_COLS ||
      cols % L::COLS != 0 || lpr > 32 || (lpr & (lpr - 1)) != 0 ||
      (L::SCALED && (128 % cols != 0 || N % 128 != 0)))
    return (int)cudaErrorInvalidValue;
  const bool vec = N % L::COLS == 0 && (uintptr_t)w % L::BYTES == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + cols - 1) / cols, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1;  // one rank: no cluster, no barrier
  const cudaError_t e =
      vec ? cudaLaunchKernelEx(&cfg, gemv<KIND, ROWS, true, TX, Out>, x, w, scale, out, M, K, N,
                               cols)
          : cudaLaunchKernelEx(&cfg, gemv<KIND, ROWS, false, TX, Out>, x, w, scale, out, M, K, N,
                               cols);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ROWS: the power of two at or above M (1, 2, 4, 8)
template <int KIND, typename TX, typename Out>
int launch(const TX* x, const void* w, const float* scale, Out out, int M, int K, int N,
           int ranks, int cols, cudaStream_t stream) {
  if (M < 1 || M > MAX_ROWS || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (M == 1) return launch_rows<KIND, 1>(x, w, scale, out, M, K, N, ranks, cols, stream);
  if (M == 2) return launch_rows<KIND, 2>(x, w, scale, out, M, K, N, ranks, cols, stream);
  if (M <= 4) return launch_rows<KIND, 4>(x, w, scale, out, M, K, N, ranks, cols, stream);
  return launch_rows<KIND, 8>(x, w, scale, out, M, K, N, ranks, cols, stream);
}

}  // namespace skinny

}  // namespace
