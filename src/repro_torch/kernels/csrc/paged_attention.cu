// Paged-KV decode attention for sm_90a (one decode step, grouped GQA).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py (_kernel /
// _paged_attention_call, public paged_attention). q, out: (B, Hkv, n_rep,
// HD), q f32 or bf16, out f32; k/v pages: (n_pages, page, Hkv, HD) int8 with f32 scales
// (n_pages, page, Hkv), or plain f32 / bf16; block_tables (B, max_pages)
// int32 (page 0 is the null page); lengths (B,) int32 — the index the new
// token was written at, attended (kpos <= lengths[b]). Options: sliding
// window (window > 0: kpos > lengths[b] - window) and tanh softcap
// (cap > 0).
//
// What bounds it on the H100: bytes at long contexts — every attended K/V
// row is read once (int8: 2 * (HD + 4) bytes per token and kv head)
// against 4 * n_rep * HD FLOPs on it, so f32 FMAs on the CUDA cores keep
// up and no tensor core is needed. At the serving shape (8 requests of
// <= 544 tokens, ~3 MB) the bytes take ~1 µs and latency rules: a launch
// (~1.5 µs), the dependent loads of a length, a block-table entry and the
// rows, and any wait across blocks. The design keeps that chain short and
// the card full:
//  * Grid: one thread block cluster per (request b, group of `heads` kv
//    heads), its `ranks` blocks (<= 8, the portable size) each a
//    contiguous run of `pages` pages of the request's block table. The
//    plan (../paged_attention.py: `plan`, which the CPU tests use to
//    model this order) depends on shapes and the SM count only, never on
//    lengths, and fills the card in about one wave.
//  * A block reads its row's length, its run of block-table entries and
//    its query rows at once, clips its token range to [lo, hi] (window,
//    length and the table's end), and stages the rows of that range into
//    a ring of STAGES shared-memory stages with asynchronous copies
//    (cp.async, 16 bytes a thread; token t's `heads` kv heads are one
//    contiguous run of heads * HD elements in a page), so that the whole
//    range is in flight at the serving shape. A rank whose range is empty
//    issues no loads; its partial state is (m = -1e30, l = 0, acc = 0).
//  * A stage's rows are scored at once: 8 lanes a (token, kv head) row,
//    each dotting HD / 8 dims with the query rows of that head, a 3-step
//    shuffle sum; the softcap; then one warp per query row takes the
//    stage's max, one expf a score and the new (m, l) of the online
//    softmax; then warp w accumulates P·V over the stage's rows w, w + 8,
//    ... (always one kv head, since heads divides 8), a lane HD / 32 dims.
//    INT8 rows are dequantized as float(q) * scale, the reference's
//    product.
//  * The block's warps are summed in warp order, and every rank stores
//    its (m, l, acc) into rank 0's shared memory (distributed shared
//    memory, st.async), counted by rank 0's transaction barrier
//    (mbarrier). Rank 0 merges in rank order 0..ranks-1 with
//    c = exp(m_r - M) and writes acc / max(l, 1e-30). An empty rank adds
//    exactly 0 (its l and acc are 0), and a row with no attended position
//    at all is 0, as in the TPU kernel. No global scratch, no atomics:
//    two calls are bit-equal, and a call can be captured in a CUDA graph.
//
// Timed on an H100 at 700 W (../paged_variants.py, PERF.md): ~11 µs at
// chip_smoke.py's check shape (8 requests of <= 511 tokens, 4 ranks), of
// which ~9.5 remain without any K/V load; the launch (~1.5 µs), the
// cluster merge (~0.5 µs) and the longest rank's stages (dequantize, dot,
// softmax, P·V: instruction-bound at two blocks an SM) hold it, not bytes.
// A deeper ring and bulk copies measured no faster (so did, in probe runs,
// a per-warp softmax without the stage's two block barriers).
//
// HD = 256 (gemma2-2b): a stage holds STAGE_BYTES / (256 · sizeof(T))
// rows (8 f32, 16 bf16, 32 int8), a scoring lane dots 32 dims (8 loads of
// 16 bytes, f32) and a P·V lane 8, so the warps' P·V sums are 8 x 8 f32
// registers a thread, twice HD = 128's. At two blocks an SM a thread may
// hold 128 registers, which those sums and a scoring lane's 32 staged
// values nearly fill; so HD = 256 runs one block an SM
// (__launch_bounds__(256, 1)), and ../paged_attention.py's plan counts a
// wave as one block an SM there (RESIDENT). Shared memory at HD = 256,
// heads x n_rep = 8 query rows and 8 ranks: the ring or the warps' sums
// 64 KB, q 8 KB, the cluster's recv buffer 8 · 8 · 258 · 4 = 66 KB, the
// rest < 4 KB: ~141 KB of the 227 KB a block may take; at gemma2's serving
// shape (n_rep 2, one head a block) ~74 KB.
//
// HD = 112 (kimi-k2): a row is 112 int8 (7 16-byte chunks), 224 bf16 B
// (14) or 448 f32 B (28), which 8 scoring lanes cannot split evenly into
// loads of one size. So at 112 a scoring lane takes the row's 16-byte
// chunks sub, sub + 8, ... (int8: lanes 0-6 one chunk, lane 7 none; bf16:
// two or one; f32: four or three), and the permuted query rows are padded
// to 8 lanes x the most chunks a lane takes (128 floats), zeros in the
// padding. P·V: HD / 32 = 3.5 dims a lane would not be whole, so 28 lanes
// take 4 dims each (one 4-, 8- or 16-byte load a row) and lanes 28-31 sit
// P·V out. Two blocks an SM, as at 64 and 128. Other widths keep their
// geometry: HD * sizeof(T) / 8 bytes a scoring lane in equal loads, HD / 32
// dims a P·V lane.
//
// A bf16 q (a bf16 backbone's decode, at every HD): its rows are widened to
// f32 as they are staged, exactly (q_at: one 16-bit load a value, at any
// element offset, so 112's padded slots and 256's rows alike), and
// everything after is the f32 q's path, over int8, f32 and bf16 pages
// alike: the staged query rows are f32 whatever q's dtype, so the shared
// memory (Layout) and the plan do not depend on it. Out stays f32, as the
// reference's kernel returns it whatever q's dtype.
//
// Limits: HD in {64, 112, 128, 256}, heads * n_rep <= 8 query rows a block,
// heads in {1, 2, 4, 8} dividing Hkv; any page size and number of kv
// heads. Page pools whose base is not 16-byte aligned are staged by plain
// loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 8;         // query rows a block: heads x n_rep
constexpr int MAX_RANKS = 8;        // the portable cluster size
constexpr int STAGE_BYTES = 8192;   // K (and V) bytes a stage holds at most
constexpr int MAX_CHUNK = 64;       // (token, kv head) rows a stage at most
constexpr int STAGES = 3;           // the ring's depth
constexpr bool BULK = false;        // stage rows by cp.async.bulk instead of cp.async
constexpr int BT_CACHE = 512;       // block-table entries a block keeps in shared memory
constexpr float NEG_INF = -1e30f;

// blocks an SM holds at head width HD (the plan's RESIDENT)
template <int HD>
constexpr int min_blocks() { return HD > 128 ? 1 : 2; }

template <typename T, int HD>
struct Geo {
  static constexpr int ROW_BYTES = HD * (int)sizeof(T);  // one (token, kv head) row
  static constexpr int CHUNK =                            // rows a stage
      STAGE_BYTES / ROW_BYTES < MAX_CHUNK ? STAGE_BYTES / ROW_BYTES : MAX_CHUNK;
  static constexpr int TB = ROW_BYTES / 8;  // bytes of a row a scoring lane reads, if even
  // whether 8 scoring lanes split a row into equal loads (not at HD = 112)
  static constexpr bool EVEN =
      ROW_BYTES % 8 == 0 && (TB >= 16 ? TB % 16 == 0 : (TB / (int)sizeof(T)) % 4 == 0);
  static constexpr int LU = EVEN ? (TB < 16 ? TB : 16) : 16;  // bytes a load
  static constexpr int EU = LU / (int)sizeof(T);              // elements a load
  static constexpr int CH = ROW_BYTES / LU;                   // loads of a row
  static constexpr int NV = (CH + 7) / 8;                     // loads a lane, at most
  static constexpr int QLD = NV * 8 * EU;  // a permuted query row's floats (HD where EVEN)
  static constexpr int DPL = HD % 32 == 0 ? HD / 32 : 4;      // dims a lane in P·V
  static constexpr int PV_LANES = HD / DPL;                   // lanes in P·V
  static constexpr bool SCALED = sizeof(T) == 1;
  static_assert(EVEN || ROW_BYTES % 16 == 0, "whole 16-byte chunks");
  static_assert(HD % DPL == 0 && PV_LANES <= 32, "P·V's lanes");
};

// Byte offsets into the dynamic shared memory, for the kernel and its
// launch alike.
struct Layout {
  int kscale, vscale, qs, sc, state, bt, recv, bars, total;
};

template <typename T, int HD>
__host__ __device__ inline Layout layout(int n_rep, int heads, int ranks, int pages) {
  using G = Geo<T, HD>;
  const int qr = heads * n_rep;
  const int ring = 2 * STAGES * G::CHUNK * G::ROW_BYTES;
  const int red = WARPS * n_rep * HD * 4;  // the warps' sums, after the ring is done
  Layout L;
  L.kscale = ((ring > red ? ring : red) + 15) / 16 * 16;
  L.vscale = L.kscale + STAGES * G::CHUNK * 4;
  L.qs = L.vscale + STAGES * G::CHUNK * 4;
  L.sc = L.qs + MAX_ROWS * G::QLD * 4;
  L.state = L.sc + MAX_ROWS * G::CHUNK * 4;     // m, l, alpha of each query row
  L.bt = L.state + 3 * MAX_ROWS * 4;
  L.recv = L.bt + ((pages < BT_CACHE ? pages : BT_CACHE) * 4 + 15) / 16 * 16;
  L.bars = L.recv + (ranks > 1 ? ranks * qr * (HD + 2) * 4 : 0);
  L.bars = (L.bars + 7) / 8 * 8;
  L.total = L.bars + (STAGES + 1) * 8;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// N elements of T from shared memory at p (aligned to their size), as f32
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES < 4) {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = to_f32(p[e]);
  } else {
    uint32_t w[BYTES / 4];
    if constexpr (BYTES % 16 == 0) {  // 16 or 32 bytes
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else if constexpr (sizeof(T) == 2) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
      }
    }
  }
}

// asynchronous copies into shared memory
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Shared-memory barriers (PTX mbarrier). A stage's barrier completes once
// its bulk copies' bytes have landed; rank 0's `landed` once every rank's
// partial state has (st.async, from any block of the cluster).
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(  // the labels are local to the braces' scope
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// The cluster barrier in its two halves (PTX barrier.cluster).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// v into rank 0's copy of *dst, counted by its copy of *bar
__device__ __forceinline__ void push(float* dst, uint64_t* bar, float v) {
  uint32_t d = smem_u32(dst), b = smem_u32(bar);
  const uint32_t owner = 0;
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(d) : "r"(owner));
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(b) : "r"(owner));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               ::"r"(d), "f"(v), "r"(b) : "memory");
}

// one query value as f32: a bf16 one widened exactly
__device__ __forceinline__ float q_at(const float* __restrict__ q, size_t i) { return __ldg(q + i); }
__device__ __forceinline__ float q_at(const __nv_bfloat16* __restrict__ q, size_t i) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(q) + i) << 16);
}

template <typename T, int HD, bool ALIGNED, typename TQ>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>())
paged_attn(const TQ* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
           const float* __restrict__ ks, const float* __restrict__ vs,
           const int* __restrict__ block_tables, const int* __restrict__ lengths,
           float* __restrict__ out, int Hkv, int n_rep, int page, int max_pages, int window,
           float cap, float scale, int ranks, int pages, int heads) {
  using G = Geo<T, HD>;
  constexpr int CHUNK = G::CHUNK, EU = G::EU, NV = G::NV, DPL = G::DPL, QLD = G::QLD;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T, HD>(n_rep, heads, ranks, pages);
  T* kring = reinterpret_cast<T*>(smem);  // [STAGES][CHUNK][HD]
  T* vring = kring + STAGES * CHUNK * HD;
  float* kss = reinterpret_cast<float*>(smem + L.kscale);  // [STAGES][CHUNK]
  float* vss = reinterpret_cast<float*>(smem + L.vscale);
  float* qs = reinterpret_cast<float*>(smem + L.qs);       // query rows, permuted (below)
  float* sc = reinterpret_cast<float*>(smem + L.sc);       // [n_rep][CHUNK] scores, then p
  float* st_m = reinterpret_cast<float*>(smem + L.state);  // [MAX_ROWS] each
  float* st_l = st_m + MAX_ROWS;
  float* st_a = st_l + MAX_ROWS;
  int* bts = reinterpret_cast<int*>(smem + L.bt);
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [ranks][qr][HD], m [ranks][qr], l
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [STAGES], bulk copies
  uint64_t* landed = full + STAGES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = blockIdx.x % ranks, pair = blockIdx.x / ranks;
  const int groups = Hkv / heads;
  const int b = pair / groups, g0 = (pair % groups) * heads;
  const int qr = heads * n_rep;
  const int p0 = rank * pages;
  const int np = min(pages, max_pages - p0);
  const size_t obase = ((size_t)b * Hkv + g0) * n_rep * HD;
  const int* btrow = block_tables + (size_t)b * max_pages + p0;

  // rank 0's barrier expects every rank's (acc, m, l); the cluster
  // barrier's arrive (waited on before the first store) says it is set
  if (tid == 0) {
    if (ranks > 1 && rank == 0) {
      bar_init(landed);
      bar_expect(landed, 4u * ranks * qr * (HD + 2));
    }
    if constexpr (BULK && ALIGNED) {
      for (int s = 0; s < STAGES; ++s) bar_init(&full[s]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ranks > 1) cluster_arrive_relaxed();

  // the length, this rank's block-table entries and the query rows, all in
  // flight at once; q is kept as [row][i][e / 4][sub][4] so that the 8
  // lanes of a scored row read 128 contiguous bytes
  const int pos = __ldg(lengths + b);
  for (int i = tid; i < min(np, BT_CACHE); i += THREADS) bts[i] = __ldg(btrow + i);
  if constexpr (G::EVEN) {
    for (int i = tid; i < qr * HD; i += THREADS) {
      const int row = i / HD, d = i % HD;
      const int u = d / (8 * EU), rem = d % (8 * EU), sub = rem / EU, e = rem % EU;
      qs[row * HD + ((u * (EU / 4) + e / 4) * 8 + sub) * 4 + e % 4] = q_at(q, obase + i);
    }
  } else {  // each padded slot from its dim, zero past HD
    for (int i = tid; i < qr * QLD; i += THREADS) {
      const int row = i / QLD, x = i % QLD, t = x / 4;
      const int sub = t % 8, e = (t / 8) % (EU / 4) * 4 + x % 4, u = t / 8 / (EU / 4);
      const int d = u * 8 * EU + sub * EU + e;
      qs[i] = d < HD ? q_at(q, obase + row * HD + d) : 0.f;
    }
  }
  if (tid < MAX_ROWS) {
    st_m[tid] = NEG_INF;
    st_l[tid] = 0.f;
  }
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, max_pages * page - 1);
  const int t0 = max(lo, p0 * page);
  const int t1 = min(hi, (p0 + np) * page - 1);
  const int tc = CHUNK / heads;  // tokens a stage
  const int nchunks = t1 >= t0 ? (t1 - t0 + tc) / tc : 0;
  __syncthreads();

  // the first element of token t's kv head g0 in a page pool
  auto row_of = [&](int t) -> size_t {
    const int pi = t / page - p0;
    const int pid = pi < BT_CACHE ? bts[pi] : __ldg(btrow + pi);
    return (((size_t)pid * page + t % page) * Hkv + g0) * HD;
  };
  // stage chunk c (if it exists) into ring stage c % STAGES; one commit
  // group a call either way
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int s = c % STAGES, tb = t0 + c * tc;
      const int n = min(tc, t1 - tb + 1);
      const int run = heads * HD;  // elements of a token's rows
      T* kd = kring + s * CHUNK * HD;
      T* vd = vring + s * CHUNK * HD;
      if constexpr (BULK && ALIGNED) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (tid == 0) bar_expect(&full[s], 2u * n * run * sizeof(T));
#pragma unroll 1
        for (int i = tid; i < 2 * n; i += THREADS) {
          const int tk = i / 2;
          const size_t src = row_of(tb + tk);
          if (i % 2 == 0) bulk(kd + tk * run, kp + src, run * sizeof(T), &full[s]);
          else bulk(vd + tk * run, vp + src, run * sizeof(T), &full[s]);
        }
      } else if constexpr (ALIGNED) {
        constexpr int E16 = 16 / (int)sizeof(T);
        const int units = run / E16;  // 16-byte units a token
#pragma unroll 1
        for (int i = tid; i < n * units; i += THREADS) {
          const int tk = i / units, u = (i % units) * E16;
          const size_t src = row_of(tb + tk) + u;
          cp16(kd + tk * run + u, kp + src);
          cp16(vd + tk * run + u, vp + src);
        }
      } else {
#pragma unroll 1
        for (int i = tid; i < n * run; i += THREADS) {
          const int tk = i / run, e = i % run;
          const size_t src = row_of(tb + tk) + e;
          kd[tk * run + e] = kp[src];
          vd[tk * run + e] = vp[src];
        }
      }
      if constexpr (G::SCALED) {
#pragma unroll 1
        for (int i = tid; i < n * heads; i += THREADS) {
          const size_t src = row_of(tb + i / heads) / HD + i % heads;
          cp4(kss + s * CHUNK + i, ks + src);
          cp4(vss + s * CHUNK + i, vs + src);
        }
      }
    }
    cp_commit();
  };

  float acc[MAX_ROWS][DPL];  // this warp's P·V sums, one kv head's n_rep rows
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  const int gw = warp % heads;  // the kv head of every row this warp accumulates

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % STAGES;
    if constexpr (BULK && ALIGNED) bar_wait(&full[s], (c / STAGES) & 1);
    cp_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
    issue(c + STAGES - 1);
    const int n = min(tc, t1 - (t0 + c * tc) + 1);
    const int rows = n * heads;
    const T* kc = kring + s * CHUNK * HD;
    const T* vc = vring + s * CHUNK * HD;

    // scores: 8 lanes a row, HD / 8 dims a lane; a lane's rows are one kv head
    {
      const int sub = tid % 8, jr = tid / 8, gq = jr % heads;
#pragma unroll
      for (int p = 0; p < (CHUNK + 31) / 32; ++p) {
        const int j = jr + 32 * p;
        const bool ok = j < rows;
        float kv[NV][EU];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (ok && (G::EVEN || i * 8 + sub < G::CH)) {
            load_vals<T, EU>(kc + j * HD + (i * 8 + sub) * EU, kv[i]);
            if constexpr (G::SCALED) {
              const float sk = kss[s * CHUNK + j];
#pragma unroll
              for (int e = 0; e < EU; ++e) kv[i][e] = __fmul_rn(kv[i][e], sk);
            }
          } else {
#pragma unroll
            for (int e = 0; e < EU; ++e) kv[i][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) {
          if (r >= n_rep) break;
          const float* qrow = qs + (gq * n_rep + r) * QLD;
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e4 = 0; e4 < EU / 4; ++e4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qrow + ((i * (EU / 4) + e4) * 8 + sub) * 4);
              d = fmaf(qv.x, kv[i][4 * e4], d);
              d = fmaf(qv.y, kv[i][4 * e4 + 1], d);
              d = fmaf(qv.z, kv[i][4 * e4 + 2], d);
              d = fmaf(qv.w, kv[i][4 * e4 + 3], d);
            }
          d += __shfl_xor_sync(0xFFFFFFFFu, d, 1);
          d += __shfl_xor_sync(0xFFFFFFFFu, d, 2);
          d += __shfl_xor_sync(0xFFFFFFFFu, d, 4);
          if (ok && sub == 0) {
            float v = d * scale;
            if (cap > 0.f) v = cap * tanhf(v / cap);
            sc[r * CHUNK + j] = v;
          }
        }
      }
    }
    __syncthreads();

    // the online softmax: one warp a query row (head g, rep r)
    if (warp < qr) {
      const int g = warp / n_rep, r = warp % n_rep;
      float mx = NEG_INF;
      // (loops over the stage's tokens keep a constant trip count: nvcc's
      // optimizer does not finish on this loop with a runtime one)
#pragma unroll
      for (int k = 0; k < (CHUNK + 31) / 32; ++k) {
        const int tk = lane + 32 * k;
        if (tk < n) mx = fmaxf(mx, sc[r * CHUNK + tk * heads + g]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_old = st_m[warp], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < (CHUNK + 31) / 32; ++k) {
        const int tk = lane + 32 * k;
        if (tk >= n) break;
        const int idx = r * CHUNK + tk * heads + g;
        const float p = expf(sc[idx] - m_new);
        sc[idx] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        st_a[warp] = a;
        st_l[warp] = st_l[warp] * a + sum;
        st_m[warp] = m_new;
      }
    }
    __syncthreads();

    // P·V: warp w takes the stage's rows w, w + 8, ...; a lane DPL dims
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r >= n_rep) break;
      const float a = st_a[gw * n_rep + r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= a;
    }
    if (G::PV_LANES == 32 || lane < G::PV_LANES)
    for (int j = warp; j < rows; j += WARPS) {
      float v[DPL];
      load_vals<T, DPL>(vc + j * HD + lane * DPL, v);
      if constexpr (G::SCALED) {
        const float sv = vss[s * CHUNK + j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) v[e] = __fmul_rn(v[e], sv);
      }
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r >= n_rep) break;
        const float p = sc[r * CHUNK + j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, v[e], acc[r][e]);
      }
    }
  }

  // the block's warps in warp order (the ring's memory, now free, holds them)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][n_rep][HD]
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r >= n_rep || (G::PV_LANES < 32 && lane >= G::PV_LANES)) break;
#pragma unroll
    for (int e = 0; e < DPL; ++e) red[(warp * n_rep + r) * HD + lane * DPL + e] = acc[r][e];
  }
  __syncthreads();
  if (ranks > 1) cluster_wait();  // every block of the cluster runs, rank 0's barrier set
  for (int i = tid; i < qr * HD; i += THREADS) {
    const int row = i / HD, d = i % HD, r = row % n_rep;
    float o = 0.f;
    for (int w = row / n_rep; w < WARPS; w += heads) o += red[(w * n_rep + r) * HD + d];
    if (ranks == 1) out[obase + i] = o / fmaxf(st_l[row], 1e-30f);
    else push(&recv[rank * qr * HD + i], landed, o);
  }
  if (ranks == 1) return;
  float* recv_m = recv + ranks * qr * HD;
  float* recv_l = recv_m + ranks * qr;
  if (tid < qr) {
    push(&recv_m[rank * qr + tid], landed, st_m[tid]);
    push(&recv_l[rank * qr + tid], landed, st_l[tid]);
  }
  if (rank != 0) return;  // rank 0 alone waits; no block touches another's memory later
  bar_wait(landed, 0);
  for (int i = tid; i < qr * HD; i += THREADS) {
    const int row = i / HD;
    float M = NEG_INF;
    for (int k = 0; k < ranks; ++k) M = fmaxf(M, recv_m[k * qr + row]);
    float l = 0.f, o = 0.f;
    for (int k = 0; k < ranks; ++k) {
      const float c = expf(recv_m[k * qr + row] - M);
      l += recv_l[k * qr + row] * c;
      o += recv[k * qr * HD + i] * c;
    }
    out[obase + i] = o / fmaxf(l, 1e-30f);
  }
}

template <typename T, int HD, bool ALIGNED, typename TQ>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* bt, const void* lengths, void* out, int B, int Hkv, int n_rep, int page,
           int max_pages, int window, float cap, float scale, int ranks, int pages, int heads,
           cudaStream_t stream) {
  const Layout L = layout<T, HD>(n_rep, heads, ranks, pages);
  auto kernel = paged_attn<T, HD, ALIGNED, TQ>;
  static int smem_allowed = 48 * 1024;  // per instantiation
  if (L.total > smem_allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = L.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * B * (Hkv / heads), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1;  // one rank: no cluster, no merge
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const TQ*)q, (const T*)kp, (const T*)vp, (const float*)ks,
      (const float*)vs, (const int*)bt, (const int*)lengths, (float*)out, Hkv, n_rep, page,
      max_pages, window, cap, scale, ranks, pages, heads);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, typename TQ = float>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const void* bt, const void* lengths, void* out, int B, int Hkv,
              int n_rep, int page, int max_pages, int window, float cap, float scale, int ranks,
              int pages, int heads, int chunk, cudaStream_t stream) {
  const bool aligned = (uintptr_t)kp % 16 == 0 && (uintptr_t)vp % 16 == 0;
#define PAGED_LAUNCH(HD_)                                                                      \
  if (hd == HD_) {                                                                             \
    if (chunk != Geo<T, HD_>::CHUNK / heads) return (int)cudaErrorInvalidValue;                \
    return aligned ? launch<T, HD_, true, TQ>(q, kp, vp, ks, vs, bt, lengths, out, B, Hkv,     \
                                              n_rep, page, max_pages, window, cap, scale,      \
                                              ranks, pages, heads, stream)                     \
                   : launch<T, HD_, false, TQ>(q, kp, vp, ks, vs, bt, lengths, out, B, Hkv,    \
                                               n_rep, page, max_pages, window, cap, scale,     \
                                               ranks, pages, heads, stream);                   \
  }
  PAGED_LAUNCH(64)
  PAGED_LAUNCH(112)
  PAGED_LAUNCH(128)
  PAGED_LAUNCH(256)
#undef PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_q(int q_bf16, int hd, const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* bt, const void* lengths, void* out, int B, int Hkv,
             int n_rep, int page, int max_pages, int window, float cap, float scale, int ranks,
             int pages, int heads, int chunk, cudaStream_t stream) {
  if (q_bf16)
    return launch_hd<T, __nv_bfloat16>(hd, q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep,
                                       page, max_pages, window, cap, scale, ranks, pages, heads,
                                       chunk, stream);
  return launch_hd<T>(hd, q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep, page, max_pages,
                      window, cap, scale, ranks, pages, heads, chunk, stream);
}

}  // namespace

extern "C" {

// kind: 0 = int8 pages with scales, 1 = f32 pages, 2 = bf16 pages; q_bf16:
// q is bf16, else f32. The plan (ranks, pages, heads, chunk)
// is the caller's (../paged_attention.py `plan`); it is checked here.
int paged_launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const void* bt, const void* lengths, void* out, int B, int Hkv, int n_rep,
                 int hd, int page, int max_pages, int kind, int window, float cap, float scale,
                 int ranks, int pages, int heads, int chunk, int q_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || Hkv < 1 || page < 1 || max_pages < 1 || n_rep < 1 || heads < 1 ||
      heads > WARPS || WARPS % heads != 0 || Hkv % heads != 0 || heads * n_rep > MAX_ROWS ||
      ranks < 1 || ranks > MAX_RANKS || pages < 1 || (long long)ranks * pages < max_pages ||
      (ranks - 1) * pages >= max_pages)
    return (int)cudaErrorInvalidValue;
  if (kind == 0)
    return launch_q<int8_t>(q_bf16, hd, q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep, page,
                            max_pages, window, cap, scale, ranks, pages, heads, chunk, s);
  if (kind == 1)
    return launch_q<float>(q_bf16, hd, q, kp, vp, nullptr, nullptr, bt, lengths, out, B, Hkv,
                           n_rep, page, max_pages, window, cap, scale, ranks, pages, heads,
                           chunk, s);
  if (kind == 2)
    return launch_q<__nv_bfloat16>(q_bf16, hd, q, kp, vp, nullptr, nullptr, bt, lengths, out, B,
                                   Hkv, n_rep, page, max_pages, window, cap, scale, ranks, pages,
                                   heads, chunk, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
