// The adapter mix's forward on the bf16 tensor cores, and the MMA helpers
// that cached_mix.cu's two kernels share with it:
//
//   out = λ·(entry @ W) + (1−λ)·a,   bw = entry @ W   (bw only when given)
//
// Two callers run mixfwd::launch: cached_mix.cu's mix_fwd (an activation-
// cache entry in its storage form, f32 W, with the f32 residual bw) and
// adapter_fuse.cu's tiled path (f32 or bf16 taps and W, no residual).
// cached_mix.cu's mix_dw, lmhead_ce.cu's ce_fwd and ce_bwd, quant_matmul.cu's
// qmm_mma and flash_attention.cu's flash_fwd_mma run their own loops on the
// helpers of mix_tile.
//
// entry (T, ld) row-major: f32, bf16, or int8 with one f32 scale per
// (token, qblock columns), scale (T, ld / qblock). W (d, da) row-major,
// f32 or bf16, d <= ld; the contraction runs over k < d, so an int8 entry
// padded to whole quantization blocks needs no copy. a / out (T, da) f32
// or bf16. λ is read from device memory.
//
// The loop (mma.sync m16n8k16, bf16 operands, f32 accumulators): M is
// tokens, N is da, K is d. A block of 8 warps owns a BM x BN = 128 x 64
// output tile, each warp 32 x 32 (2 x 4 MMA tiles), and steps the
// contraction BK = 32 at a time over its slice of d.
//  * The entry (A) is row-major with k contiguous, the MMA's own A
//    layout: rows staged in global order, 16-byte chunks XOR-swizzled by
//    row, read by ldmatrix without .trans. int8 codes and bf16 values are
//    exact in bf16 and go to the MMA whole; an f32 entry is split in three
//    bf16 terms as it is staged (split3).
//  * W (B) is (d, da) row-major: rows staged in global order, read by
//    ldmatrix.trans. f32 W is split in three bf16 terms as it is staged;
//    bf16 W goes whole. The products kept are those of terms i + j <= 2:
//    6 for f32 x f32, 3 for one exact operand, 1 for bf16 x bf16.
//  * Each k16 step's products go into a fresh f32 sum, smallest terms
//    first, which one add then puts into the accumulator: the MMA adds its
//    16 products and C truncated to the grid of the largest addend, and a
//    fresh sum keeps that grid the step's, not the running total's
//    (cached_mix.cu's note has the measurement).
//  * int8 scales (Kind I8, qblock % 16 == 0): the scale varies along the
//    contraction per token, so it cannot fold into W. A k16 step lies in
//    one quantization block, so the step's fresh sum (codes @ W) is
//    multiplied by each row's scale[t, k / qblock] as it is added to the
//    accumulator. The reference rounds q·s in f32 before its product; the
//    kernel scales the partial sum instead. A thread's C fragment holds 4
//    token rows; their scales for the step's two k16 halves are staged in
//    shared memory beside the entry. Any other qblock takes I8_DEQ: q·s in
//    f32 as staged (the reference's product), then the f32 entry's split.
//  * The global loads of step i+1 (16 bytes a thread where the row allows,
//    else element by element; masked at T, d and da) go to registers
//    before the MMAs of step i, and are converted, split and stored to the
//    other of two shared-memory buffers after them.
//  * The contraction is cut into S slices (whole BK steps; a k16 step
//    never straddles a quantization block, so no slice needs to align to
//    one) so that the grid reaches ~2 blocks per SM: S = 4 at the training
//    shape T = 2048, d = 2048, da = 256 (64 tiles, 256 blocks). Each slice
//    writes its f32 partial to a scratch (S, T, da); mix_fwd_reduce sums
//    the slices in slice order and applies the epilogue. S = 1 writes the
//    epilogue directly. No atomics: two calls give bit-equal out and bw.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal to each library that includes it: two of them load into one
// process, and an external template's static local (launch's `opted`)
// would be one object shared by both, opting in only one library's kernel.
namespace {

namespace mix_tile {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// element (r, c) of a staged tile whose rows hold W bf16 values (32, or a
// multiple of 64): the 16-byte chunks XOR-swizzled by row, so the 8 rows
// one ldmatrix matrix reads (one chunk column) sit in 8 different bank
// groups (a 32-wide row is half a 128-byte line: two rows share one)
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(W == 32 || W % 64 == 0, "staged rows of 32 or a multiple of 64 bf16");
  const int x = W == 32 ? (r >> 1) & 3 : r & 7;
  return r * W + ((((c >> 3) ^ x) << 3) | (c & 7));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices: lane l gives the row address of matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes global -> shared without registers (L2 only), in commit groups
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> three packed bf16 pairs, hi, mid, lo (x0 in the low half)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&w)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    w[j] = bits(h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// four int8 codes -> their exact f32 values (2^23 + 128 + q, less 2^23 + 128)
__device__ __forceinline__ void codes_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // q + 128 as unsigned bytes
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// the upper halves of two exact small integers' f32 bits are their bf16
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 16 codes -> 16 exact bf16 values in two 16-byte chunks
__device__ __forceinline__ void codes_bf16(const uint4& v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t p[8];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float f[4];
    codes_f32(w[h], f);
    p[2 * h] = pack_hi(f[0], f[1]);
    p[2 * h + 1] = pack_hi(f[2], f[3]);
  }
  lo = make_uint4(p[0], p[1], p[2], p[3]);
  hi = make_uint4(p[4], p[5], p[6], p[7]);
}

// 16 bytes of a row from column m: one vector load where the row allows,
// else element by element; columns >= n read as zero
template <typename U>
__device__ __forceinline__ uint4 load_chunk(const U* __restrict__ row, int m, int n, bool vec) {
  constexpr int EPC = 16 / sizeof(U);
  if (vec && m + EPC <= n) return *reinterpret_cast<const uint4*>(row + m);
  union {
    uint4 v;
    U e[EPC];
  } r;
#pragma unroll
  for (int e = 0; e < EPC; ++e) r.e[e] = (m + e < n) ? row[m + e] : U(0);
  return r.v;
}

// An entry's storage and how it reaches the MMA: F32 split in three
// terms; BF16 whole; I8 codes whole, the scale applied outside the MMA
// (mix_dw folds it into g, the forward scales each k16 step's sum);
// I8_DEQ dequantized to f32 as staged, then split in three.
enum Kind { F32 = 0, BF16 = 1, I8 = 2, I8_DEQ = 3 };

template <int K> struct Entry;
template <> struct Entry<F32> { using U = uint32_t; static constexpr int A_TERMS = 3; };
template <> struct Entry<BF16> { using U = uint16_t; static constexpr int A_TERMS = 1; };
template <> struct Entry<I8> { using U = uint8_t; static constexpr int A_TERMS = 1; };
template <> struct Entry<I8_DEQ> { using U = uint8_t; static constexpr int A_TERMS = 3; };

}  // namespace mix_tile

// ------------------------------------------------------------ the forward
namespace mixfwd {

using namespace mix_tile;

constexpr int WARPS_M = 4, WARPS_N = 2;  // 8 warps of 32 x 32
constexpr int BM = 32 * WARPS_M;    // tokens per block
constexpr int BN = 32 * WARPS_N;    // output columns (of da) per block
constexpr int BK = 32;              // contraction per step
constexpr int SUB = BK / 16;        // k16 steps per step
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int A_TILE = BM * BK;     // bf16 values of one staged entry term
constexpr int B_TILE = BK * BN;     // bf16 values of one staged W term
constexpr int MIN_BLOCKS = 2;       // per SM, so <= 128 registers a thread
constexpr int TARGET_BLOCKS = 256;  // 2 blocks of 8 warps on each of 132 SMs
constexpr int MIN_STEPS = 4;        // contraction steps a slice keeps at least

template <typename TW>
__host__ __device__ constexpr int w_terms() { return sizeof(TW) == 4 ? 3 : 1; }

// one buffer's staged terms (and int8 scales), in bf16 units
template <int KIND, typename TW>
__host__ __device__ constexpr int buf_elems() {
  return Entry<KIND>::A_TERMS * A_TILE + w_terms<TW>() * B_TILE + (KIND == I8 ? 2 * BM * SUB : 0);
}

// One (BM x BN output tile, contraction slice) per block: grid
// (ceil(da / BN), ceil(T / BM), S). S == 1 writes bw (when given) and out;
// else the slice's f32 partial to partial (S, T, da).
template <int KIND, typename TW, typename TA, typename TO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_fwd_mma(const void* __restrict__ b_, const float* __restrict__ scale,
            const TW* __restrict__ w_, const TA* __restrict__ a,
            const float* __restrict__ lam_p, TO* __restrict__ out, float* __restrict__ bw,
            float* __restrict__ partial, int T, int ld, int d, int da, int qblock, int vec_b,
            int vec_w) {
  using U = typename Entry<KIND>::U;
  using WU = std::conditional_t<sizeof(TW) == 4, uint32_t, uint16_t>;
  constexpr int A_TERMS = Entry<KIND>::A_TERMS;
  constexpr int B_TERMS = w_terms<TW>();
  constexpr bool SCALED = KIND == I8;
  constexpr int EPC = 16 / sizeof(U);         // entry elements per 16-byte chunk
  constexpr int CPR = BK / EPC;               // entry chunks per staged row
  constexpr int A_CH = BM * CPR / THREADS;    // entry chunks per thread per step
  constexpr int WPC = 16 / sizeof(TW);        // W elements per chunk
  constexpr int WCR = BN / WPC;               // W chunks per staged row
  constexpr int W_CH = BK * WCR / THREADS;    // W chunks per thread per step
  constexpr int BUF = buf_elems<KIND, TW>();
  static_assert(A_CH >= 1 && W_CH >= 1, "tile too small for the block");
  static_assert(BM * SUB == THREADS, "one staged scale per thread");

  extern __shared__ __align__(16) uint16_t smem[];  // 2 x (A terms, B terms, scales)
  const U* __restrict__ b = static_cast<const U*>(b_);
  const WU* __restrict__ w = reinterpret_cast<const WU*>(w_);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int nqb = SCALED || KIND == I8_DEQ ? ld / qblock : 0;

  const int steps = (d + BK - 1) / BK, S = gridDim.z;
  const int s_begin = (int)((long long)blockIdx.z * steps / S);
  const int s_end = (int)((long long)(blockIdx.z + 1) * steps / S);

  uint4 ar[A_CH], wr[W_CH];
  float sr = 0.f;

  // global -> registers: the entry's BM x BK tile at (t0, k0), W's BK x BN
  // at (k0, n0), and (I8) the scale of row tid / SUB at k0 + 16·(tid % SUB)
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * THREADS, gt = t0 + q / CPR;
      ar[i] = gt < T ? load_chunk(b + (size_t)gt * ld, k0 + (q % CPR) * EPC, d, vec_b)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < W_CH; ++i) {
      const int q = tid + i * THREADS, gk = k0 + q / WCR;
      wr[i] = gk < d ? load_chunk(w + (size_t)gk * da, n0 + (q % WCR) * WPC, da, vec_w)
                     : make_uint4(0, 0, 0, 0);
    }
    if constexpr (SCALED) {
      const int gt = t0 + tid / SUB, gk = k0 + 16 * (tid % SUB);
      sr = (gt < T && gk < d) ? scale[(size_t)gt * nqb + gk / qblock] : 0.f;
    }
  };

  // registers -> shared buffer `buf`: converted, split, in swizzled rows
  auto store = [&](int buf, int k0) {
    uint16_t* as = smem + buf * BUF;
    uint16_t* bs = as + A_TERMS * A_TILE;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * THREADS, t = q / CPR, m = (q % CPR) * EPC;
      const uint4 v = ar[i];
      if constexpr (KIND == BF16) {
        *reinterpret_cast<uint4*>(as + swz<BK>(t, m)) = v;
      } else if constexpr (KIND == I8) {
        uint4 lo, hi;
        codes_bf16(v, lo, hi);
        *reinterpret_cast<uint4*>(as + swz<BK>(t, m)) = lo;
        *reinterpret_cast<uint4*>(as + swz<BK>(t, m + 8)) = hi;
      } else if constexpr (KIND == F32) {
        uint32_t w01[3], w23[3];
        split3(__uint_as_float(v.x), __uint_as_float(v.y), w01);
        split3(__uint_as_float(v.z), __uint_as_float(v.w), w23);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<uint2*>(as + j * A_TILE + swz<BK>(t, m)) = make_uint2(w01[j], w23[j]);
      } else {  // I8_DEQ: q·s in f32 (the reference's product), then split
        const int gt = t0 + t;
        const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
        uint32_t p[3][8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float f[4];
          codes_f32(wv[h], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gk = k0 + m + 4 * h + e;
            f[e] = (gt < T && gk < d) ? f[e] * scale[(size_t)gt * nqb + gk / qblock] : 0.f;
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
          *reinterpret_cast<uint4*>(as + j * A_TILE + swz<BK>(t, m)) =
              make_uint4(p[j][0], p[j][1], p[j][2], p[j][3]);
          *reinterpret_cast<uint4*>(as + j * A_TILE + swz<BK>(t, m + 8)) =
              make_uint4(p[j][4], p[j][5], p[j][6], p[j][7]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < W_CH; ++i) {
      const int q = tid + i * THREADS, kr = q / WCR, n = (q % WCR) * WPC;
      if constexpr (B_TERMS == 1) {
        *reinterpret_cast<uint4*>(bs + swz<BN>(kr, n)) = wr[i];
      } else {
        uint32_t w01[3], w23[3];
        split3(__uint_as_float(wr[i].x), __uint_as_float(wr[i].y), w01);
        split3(__uint_as_float(wr[i].z), __uint_as_float(wr[i].w), w23);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<uint2*>(bs + j * B_TILE + swz<BN>(kr, n)) = make_uint2(w01[j], w23[j]);
      }
    }
    if constexpr (SCALED) reinterpret_cast<float*>(bs + B_TERMS * B_TILE)[tid] = sr;
  };

  // ldmatrix row of this lane: matrix j = lane / 8, row lane % 8.
  // A (tokens x k) from the entry's [token][k] rows: matrices
  // (t 0-7, k 0-7), (t 8-15, k 0-7), (t 0-7, k 8-15), (t 8-15, k 8-15).
  // B (k x da columns) from W's [k][n] rows, transposed: matrices
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
  const int lj = lane >> 3, lr = lane & 7;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 32;
  const int a_t = wm + ((lj & 1) << 3) + lr, a_k = (lj >> 1) << 3;
  const int b_k = ((lj & 1) << 3) + lr, b_n = wn + ((lj >> 1) << 3);
  // C fragment: rows lane/4 (+8), columns 2·(lane%4) (+1) of each 16 x 8 tile
  const int gq = lane >> 2, tq = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto compute = [&](int buf) {
    const uint16_t* as = smem + buf * BUF;
    const uint16_t* bs = as + A_TERMS * A_TILE;
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const int kk = 16 * sub;
      float sc[2][2];  // (I8) the scales of this thread's 4 rows for the k16 step
      if constexpr (SCALED) {
        const float* ss = reinterpret_cast<const float*>(bs + B_TERMS * B_TILE);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) sc[mi][h] = ss[(wm + 16 * mi + gq + 8 * h) * SUB + sub];
      }
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
            ldsm_x4(af[i], smem_addr(as + i * A_TILE + swz<BK>(a_t + 16 * mi, kk + a_k)));
          // the k16 step into a fresh f32 sum, smallest products first
          // (terms i + j = 2, 1, then hi·hi)
          float part[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][e] = 0.f;
#pragma unroll
          for (int ord = 2; ord >= 0; --ord)
#pragma unroll
            for (int i = 0; i < A_TERMS; ++i) {
              if (ord - i < 0 || ord - i >= B_TERMS) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) mma_bf16(part[h], af[i], bf[ord - i][h]);
            }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& c = acc[mi][2 * np + h][e];
              if constexpr (SCALED)
                c = fmaf(sc[mi][e >> 1], part[h][e], c);
              else
                c += part[h][e];
            }
        }
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

  const float lam = S == 1 ? *lam_p : 0.f;
  float* __restrict__ p = partial + (size_t)blockIdx.z * T * da;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t0 + wm + 16 * mi + gq + 8 * h;
      if (row >= T) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + 8 * ni + 2 * tq + e;
          if (col >= da) continue;
          const size_t o = (size_t)row * da + col;
          const float v = acc[mi][ni][2 * h + e];
          if (S > 1) {
            p[o] = v;
          } else {
            if (bw != nullptr) bw[o] = v;
            put(out + o, lam * v + (1.f - lam) * to_f32(a[o]));
          }
        }
    }
}

// the epilogue over slice partials (S, n): s = Σ_j partial[j][i] in slice
// order; bw[i] = s (when given); out[i] = λ·s + (1−λ)·a[i]
template <typename TA, typename TO>
__global__ void mix_fwd_reduce(const float* __restrict__ partial, const TA* __restrict__ a,
                               const float* __restrict__ lam_p, TO* __restrict__ out,
                               float* __restrict__ bw, int S, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += partial[j * n + i];
  if (bw != nullptr) bw[i] = s;
  const float lam = *lam_p;
  put(out + i, lam * s + (1.f - lam) * to_f32(a[i]));
}

template <typename TA, typename TO>
int reduce(const float* partial, const TA* a, const float* lam, TO* out, float* bw, int S,
           long long n, cudaStream_t s) {
  mix_fwd_reduce<TA, TO><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, a, lam, out, bw,
                                                                     S, n);
  return (int)cudaGetLastError();
}

// contraction slices of one call (T, da > 0): its scratch is (slices, T, da) f32 when > 1
inline int slices(int T, int d, int da) {
  const int tiles = ((T + BM - 1) / BM) * ((da + BN - 1) / BN);
  const int steps = (d + BK - 1) / BK;
  int s = (TARGET_BLOCKS + tiles - 1) / tiles;
  if (s > steps / MIN_STEPS) s = steps / MIN_STEPS;
  return s < 1 ? 1 : s;
}

// the whole forward: the MMA loop, then (S > 1) the reduce; returns a cudaError_t
template <int KIND, typename TW, typename TA, typename TO>
int launch(const void* b, const float* scale, const TW* w, const TA* a, const float* lam,
           TO* out, float* bw, float* partial, int T, int ld, int d, int da, int qblock,
           cudaStream_t s) {
  using U = typename Entry<KIND>::U;
  constexpr int smem = 2 * buf_elems<KIND, TW>() * (int)sizeof(uint16_t);
  if (smem > 48 * 1024) {  // above the default: opt in, once per instantiation
    static bool opted = false;
    if (!opted) {
      const cudaError_t e = cudaFuncSetAttribute(
          mix_fwd_mma<KIND, TW, TA, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      opted = true;
    }
  }
  const int S = slices(T, d, da);
  const int vec_b = (ld * sizeof(U)) % 16 == 0 && (uintptr_t)b % 16 == 0;
  const int vec_w = (da * sizeof(TW)) % 16 == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid((da + BN - 1) / BN, (T + BM - 1) / BM, S);
  mix_fwd_mma<KIND, TW, TA, TO><<<grid, THREADS, smem, s>>>(b, scale, w, a, lam, out, bw, partial,
                                                            T, ld, d, da, qblock, vec_b, vec_w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  return reduce(partial, a, lam, out, bw, S, (long long)T * da, s);
}

}  // namespace mixfwd

}  // namespace
