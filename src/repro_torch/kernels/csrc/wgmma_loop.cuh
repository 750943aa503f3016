// Hopper's asynchronous GEMM loop, for sm_90a: TMA loads into a ring of
// shared-memory stages guarded by mbarriers, one producer thread, and two
// consumer warpgroups issuing wgmma.mma_async (m64n128k16, bf16 operands,
// f32 accumulators) straight from shared memory, without ldmatrix.
//
// The block: two consumer warpgroups (warps 0-7) and a producer
// warpgroup (warps 8-11), 384 threads, one block an SM. The launch bounds
// cap every thread at 168 registers (three warps share each of the SM's
// four 16K-register partitions); setmaxnreg moves the producer's to the
// consumers, 40 and 232, which ptxas honours only when each kernel splits
// the roles in one if / else (an early return spilled 612 bytes). One
// producer thread, per BK = 64 step of the contraction, waits for the
// stage's empty barrier, announces the stage's bytes on its full barrier
// and issues the TMA loads. Each consumer warpgroup owns 64 rows of the
// block's BM x bn(NH) = 128 x 128·NH output tile, NH 128-column halves
// (acc[NH][64] a thread): per stage it waits on the full barrier, then
// per half issues the stage's wgmma into a fresh sum, waits for them and
// adds it to the half's f32 running sum in registers; the last half
// releases the stage (one arrive a warp on its empty barrier). Two
// consumers keep the tensor cores fed while the other waits and adds.
// NH = 2 halves the times every A tile is streamed from L2 (once per
// 256-column tile), at 192 accumulator registers a thread and two stages.
//
// Operands, both bf16 in 128-byte swizzled tiles (TMA's SWIZZLE_128B,
// the descriptors' layout 1: a row of 64 values, 8-row atoms 1024 bytes
// apart, so every tile sits on a 1024-byte boundary):
//  * A, K-major: TA terms (planes) of a BM x 64 tile, one TMA box of 128
//    rows each, read from an (TA·rows, cols) map whose planes are `plane`
//    rows apart. Each consumer's 64 rows start 8 KB into a term.
//  * B, MN-major (B_KMAJOR false): a 64 x bn tile of a (K, N) map with N
//    contiguous, boxes of 64 k rows x 64 columns, 8 KB apart (the
//    descriptor's leading byte offset), wgmma's imm-trans-b = 1. K-major
//    (B_KMAJOR true): a bn x 64 tile of an (N, K) map with K contiguous,
//    one box of bn rows, trans-b = 0. Either way a half is 16 KB on.
// A k16 step moves an A or K-major B descriptor 32 bytes along its rows,
// and an MN-major B descriptor 16 rows (2 KB) down its tile.
// Out-of-bounds boxes read as zeros (TMA's fill): the ragged edges of K,
// N and the rows need no padding in device memory.
//
// The order of the sums (the tensor core adds a wgmma's 16 products and
// its C truncated on the grid of the largest addend; mix_tile.cuh): a
// stage's products go into a fresh f32 sum, the A terms smallest first
// (lo, mid, then hi, each over the stage's four k16 steps), which one
// rounded add puts into the running sum. A stage's fresh sum keeps its
// own grid, not the running total's.
//
// Host side: tensor_map encodes a 2-D bf16 map through the CUDA driver's
// cuTensorMapEncodeTiled, fetched at run time with
// cudaGetDriverEntryPointByVersion (no link against libcuda); tensor_map3
// a 3-D one over (heads, rows, cols), whose boxes stop at a head's last row
// (zeros past it). A map needs a 16-byte-aligned base and a row stride that
// is a multiple of 16 bytes; kernels take maps as __grid_constant__
// parameters.
//
// Beside the loop, the pieces flash_attention.cu's bf16 kernel builds its
// own loop from: tma_load3, mma_n64 (N = 64, both operands from shared
// memory) and mma_rs (A from registers: mma.sync's A fragment per warp, so
// a C fragment of one product is the A of the next without a round trip
// through shared memory).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal to each library that includes it (see mix_tile.cuh)
namespace {

namespace wgl {

constexpr int CONSUMERS = 2;              // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int BM = 64 * CONSUMERS;        // rows of the output tile
constexpr int HALF = 128;                 // columns of one wgmma (a half)
constexpr int BK = 64;                    // contraction per stage: one 128-byte row
// columns of the output tile, NH halves
__host__ __device__ constexpr int bn(int nh) { return HALF * nh; }

// ---- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// True where TMA can read a bf16 (rows, cols) matrix of `ld` values a row
// at `base` in place: the base 16-byte aligned, the row stride a multiple
// of 16 bytes
inline bool tma_readable(const void* base, long long ld) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ld % 8 == 0;
}

// m: a map of the bf16 (rows, cols) matrix at `base`, `ld` values a row,
// read in boxes of box_rows x 64 columns with the 128-byte swizzle; reads
// outside it give zeros
inline cudaError_t tensor_map(CUtensorMap* m, const void* base, long long rows, long long cols,
                              long long ld, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (!tma_readable(base, ld)) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// m: the same over a contiguous bf16 (heads, rows, cols) tensor, a box
// box_rows x 64 columns of one head (tma_load3 at (column, row, head)):
// rows past a head's last read as zeros, never as the next head's
inline cudaError_t tensor_map3(CUtensorMap* m, const void* base, long long heads,
                               long long rows, long long cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (!tma_readable(base, cols)) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)(rows * cols) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: barriers, TMA, wgmma

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}

// arrive and expect `bytes` of TMA transactions in the barrier's phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of this parity has completed; a phase that
// never completes (a lost arrive or byte count) traps after ~2^28 polls,
// seconds, rather than hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = saddr(b);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// the box at (column c0, row c1) of `map` into shared memory at dst,
// completing its bytes on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the box at (column c0, row c1, head c2) of a tensor_map3 map
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the producer warpgroup (after the consumers'); its first thread issues
// the loads
__device__ __forceinline__ bool producer_warp() { return threadIdx.x >= 128 * CONSUMERS; }
__device__ __forceinline__ bool producer_thread() { return threadIdx.x == 128 * CONSUMERS; }

// each role's first act (setmaxnreg, sm_90a): the producer warpgroup
// gives registers away, the consumers take them; a kernel's roles must be
// one if / else for ptxas to allot the consumers' 232
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// consumer warpgroups only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// shared-memory matrix descriptors, 128-byte swizzle (layout type 1);
// strides in bytes: sbo between 8-row atoms, lbo between 64-wide blocks
// of an MN-major operand (unused by a K-major one)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of d across an
// asynchronous wgmma's issue or wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for a register A operand: its registers stay as they are until
// the wgmma that reads them has completed (call after the wait)
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (+)= A · B over one k16 step, the warpgroup's 64 x 128 f32 tile (the
// mma.sync m16n8 C layout per warp: warp w of the group rows 16w..16w+15,
// d[4j + e] at row lane/4 + 8·(e/2), column 8j + 2·(lane%4) + e%2);
// accumulate = 0 overwrites d. TRANS_B: B is MN-major.
template <int TRANS_B>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// the same at N = 64: a warpgroup's 64 x 64 f32 tile (d[4j + e] as above,
// j < 8), A and B from shared memory
template <int TRANS_B>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// mma with A from registers: a is this thread's A fragment of the k16 step
// (mma.sync's m16n8k16 A layout per warp, rows as d's: a[0] row lane/4,
// columns 2·(lane%4) and +1; a[1] row +8; a[2], a[3] the same 8 columns on),
// which must not change until the wgmma has completed (pin after the wait)
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// ---- the loop

// The ring in dynamic shared memory: STAGES stages of the A terms' and
// B's tiles (1024-byte aligned), then a full and an empty barrier a stage
template <int TA, int NH, int STAGES_>
struct Ring {
  static constexpr int STAGES = STAGES_;
  static constexpr int A_TERM = BM * BK * 2;  // bytes of one A term's tile
  static constexpr int A_BYTES = TA * A_TERM;
  static constexpr int B_HALF = HALF * BK * 2;
  static constexpr int STAGE = A_BYTES + NH * B_HALF;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  uint8_t* tiles;
  uint64_t* full;
  uint64_t* empty;

  // every thread of the block, before the roles split
  __device__ explicit Ring(uint8_t* raw) {
    tiles = raw + ((1024 - saddr(raw) % 1024) % 1024);
    full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE);
    empty = full + STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        bar_init(&full[s], 1);               // the producer's arrive, plus the bytes
        bar_init(&empty[s], 4 * CONSUMERS);  // one arrive a consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The stages that fit in ~200 KB, at most 4
template <int TA, int NH>
__host__ __device__ constexpr int stages() {
  return (200 * 1024) / (TA * BM * BK * 2 + NH * HALF * BK * 2) < 4
             ? (200 * 1024) / (TA * BM * BK * 2 + NH * HALF * BK * 2)
             : 4;
}

template <int TA, int NH>
using RingOf = Ring<TA, NH, stages<TA, NH>()>;

// The producer thread: `steps` stages. A: TA boxes at (k, plane·j + a_row);
// B MN-major: 2·NH boxes at (b_n + 64·i, b_k + k); K-major: one at
// (b_k + k, b_n)
template <int TA, int NH, bool B_KMAJOR, int STAGES>
__device__ __forceinline__ void produce(const Ring<TA, NH, STAGES>& r, const CUtensorMap* amap,
                                        int a_row, int plane, const CUtensorMap* bmap, int b_n,
                                        int b_k, int steps) {
  using R = Ring<TA, NH, STAGES>;
  prefetch_map(amap);
  prefetch_map(bmap);
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % STAGES;
    bar_wait(&r.empty[s], ((kt / STAGES) & 1) ^ 1);
    bar_expect(&r.full[s], R::STAGE);
    uint8_t* a = r.tiles + s * R::STAGE;
#pragma unroll
    for (int j = 0; j < TA; ++j)
      tma_load(a + j * R::A_TERM, amap, kt * BK, plane * j + a_row, &r.full[s]);
    uint8_t* b = a + R::A_BYTES;
    if constexpr (B_KMAJOR) {
      tma_load(b, bmap, b_k + kt * BK, b_n, &r.full[s]);
    } else {
#pragma unroll
      for (int i = 0; i < 2 * NH; ++i)
        tma_load(b + i * 64 * BK * 2, bmap, b_n + 64 * i, b_k + kt * BK, &r.full[s]);
    }
  }
}

// A consumer warpgroup's share: acc[h] = its 64 rows of the tile's half
// h, summed over `steps` stages, each stage's products into a fresh sum
// (see the note)
template <int TA, int NH, bool B_KMAJOR, int STAGES>
__device__ __forceinline__ void consume(const Ring<TA, NH, STAGES>& r, int steps,
                                        float (&acc)[NH][64]) {
  using R = Ring<TA, NH, STAGES>;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % STAGES;
    bar_wait(&r.full[s], (kt / STAGES) & 1);
    const uint32_t a = saddr(r.tiles + s * R::STAGE) + wg * 64 * BK * 2;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint32_t b = saddr(r.tiles + s * R::STAGE + R::A_BYTES + h * R::B_HALF);
      pin(part);
      mma_fence();
#pragma unroll
      for (int j = TA - 1; j >= 0; --j)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc(a + j * R::A_TERM + 32 * kk, 16, 1024);
          const uint64_t db = B_KMAJOR ? desc(b + 32 * kk, 16, 1024)
                                       : desc(b + 16 * 128 * kk, 64 * BK * 2, 1024);
          mma<B_KMAJOR ? 0 : 1>(part, da, db, j < TA - 1 || kk > 0);
        }
      mma_commit();
      mma_wait<0>();
      pin(part);
      if (h == NH - 1 && (threadIdx.x & 31) == 0) bar_arrive(&r.empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] += part[i];
    }
  }
}

}  // namespace wgl

}  // namespace
