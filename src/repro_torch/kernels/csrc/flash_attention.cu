// Causal online-softmax ("flash") attention forward for sm_90a, f32 in and
// out on flash_fwd_mma (mma.sync), or bf16 in and out on flash_fwd_wg (TMA +
// wgmma: the bf16 branch below), on the bf16 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel /
// flash_attention_tpu). q, o: (BH, Sq, HD); k, v: (BH / n_rep, Sk, HD),
// all f32 row-major — query row bh reads kv row bh / n_rep, i.e. grouped
// GQA heads read directly instead of the repeated-KV copy the TPU path
// builds. Options: causal mask, sliding window (window > 0), tanh softcap
// (cap > 0). Positions are 0..S-1 for both queries and keys. HD is 64,
// 112, 128 or 256.
//
// What bounds it on the H100: at the prefill shape (BH = 8·16 over 8·8 KV
// heads, S = 512, HD = 128, causal) the two products are 8.6 GFLOP on
// ~101 MB. In f32 on the CUDA cores that is 0.128 ms at 67 TFLOP/s; here
// each f32 operand is split in three bf16 terms and each product takes
// the six products of terms i + j <= 2 (12 in all), 52 GFLOP, 0.052 ms at
// 989 TFLOP/s: bound by operations either way.
//
// Split. flash_split writes K and V once per call as three bf16 planes
// each, hi = bf16(x), mid = bf16(x − hi), lo = bf16(x − hi − mid)
// (mix_tile.cuh's split3), zero-padded to whole key tiles (Skp), into a
// scratch the caller allocates (../flash_attention.py's scratch_elems; 50
// MB at the prefill shape): each K/V row serves up to Sq / BQ · n_rep query
// tiles, so a split as staged would be repeated that often. Q is read by
// one block only and is split as it is staged into shared memory.
//
// The loop (flash_fwd_mma): one block per (bh, 64-row query tile), each
// warp 16 query rows, so the softmax state (m, l, O) is a warp's own: a
// row's max and sum are quad shuffles over the C fragment, with no
// shared-memory round trip and no cross-warp barrier. At HD = 64 and 128 a
// block is 4 warps, one a 16-row group; at HD = 256 it is 8, two a group
// (see "HD = 256" below). Key tiles of BKV = 32 rows:
//  * S = Q·Kᵀ on mma.sync m16n8k16: Q's planes are the row-major A
//    (ldmatrix); K stored (keys, HD) with HD contiguous is the MMA's
//    column-major B as it lies (ldmatrix without .trans). Each k16 step's
//    six products go into a fresh f32 sum, smallest terms first, which one
//    add puts into S: the tensor core truncates its addends on the grid of
//    the largest one (mix_tile.cuh's note).
//  * Scale, softcap, then the mask (causal, window, keys >= Sk) only on
//    tiles that cross the diagonal, the window's edge or Sk; p = exp(s − m)
//    in f32, l summed from the f32 p; O rescaled by exp(m_old − m_new).
//  * P never leaves the registers: the C fragments of two adjacent n8
//    tiles of S are the A fragment of one k16 step of P·V (FlashAttention-
//    2's layout identity). Each p is split in three bf16 terms there; V
//    stored (keys, HD) is the B with n contiguous (ldmatrix.trans). The six
//    products again into a fresh sum per k16 step, 8 n8 tiles at a time.
//  * One K and one V buffer, filled by cp.async in FlashAttention-2's
//    interleaved order: V(j) loads while S(j) is computed, K(j + 1) while
//    P·V(j) is; two barriers a tile. Staged rows are padded by 16 bytes
//    (conflict-free ldmatrix, every fragment address a constant offset).
//    At HD = 128: Q's three planes 51 KB, K's and V's 25.5 KB each, 102 KB
//    a block, so two blocks (8 warps) share an SM; O (64 f32 a thread), S
//    and the fresh sums fill ~255 registers.
//  * Key tiles wholly outside the causal/window band are skipped: on the
//    TPU they contribute zero after the alpha rescale, so the result is
//    the same function. Query tiles launch longest first (the grid's slow
//    index counts down), so the last wave is short.
// HD = 256 (gemma2-2b's head width). O's accumulator a warp would be 128
// f32 registers a thread on top of the ~190 the loop holds at HD = 128,
// so each 16-row group gets two warps (CW = 2): both compute the group's
// whole S = Q·Kᵀ and its softmax (the same instructions on the same
// operands, so the same bits), and warp c accumulates O's columns
// [128c, 128c + 128) only — O stays 64 registers a thread, as at HD = 128.
// The cost is the redundant Q·Kᵀ: 1.5x the MMAs of a split S, traded for
// no S exchange through shared memory and no extra barrier. Budget: 8
// warps (256 threads) a block, one block an SM (__launch_bounds__(256, 1):
// up to 255 registers a thread); shared memory 3·(64 + 2·32)·(256 + 8)·2 =
// 202,752 B a block of the 232,448 an SM offers. K/V are staged 4 chunks a
// thread a term, Q 16.
// HD = 112 (kimi-k2's head width, 7168 / 64). Q·Kᵀ takes 7 k16 steps, which
// the loop takes one at a time anyway; O's 14 n8 tiles a warp are summed in
// P·V as one group of 8 and a remainder group of 6 (NG's multiple and the
// rest, each an even count for ldmatrix.x4's pairs of tiles); a K/V term's
// 32 x 14 16-byte chunks are 3.5 a thread, so the last round of the load
// takes the first 64 threads only. A staged row is 120 bf16 (240 B): its 8
// ldmatrix rows start at 240·r mod 128 = 0, 112, 96, ..., 16, 8 distinct
// 16-byte bank groups, and every row stays 16-byte aligned. CW = 1, two
// blocks an SM, 92,160 B of shared memory a block; O is 56 f32 a thread.
// Each output row is owned by one block, summed in a fixed order with no
// atomics: two calls give bit-equal results. A row with no key in its band
// (only with a window and Sq > Sk: q >= Sk + window - 1) gets l = 0 and
// writes 0; the wrapper (../flash_attention.py) overwrites such rows with
// V's mean over the Sk keys, the reference's answer.
//
// What holds it (chip_smoke.py, ../flash_variants.py; NVIDIA H100 80GB
// HBM3, 700 W): 0.213–0.215 ms a call at the prefill shape (the scalar f32
// kernel before it: 0.548–0.552; SDPA 0.276–0.278), 4.1x its tensor-core
// bound, 0.031 of it in flash_split; 0.109–0.110 ms at the epoch-1 step's
// BH = 4·16. The loop without its MMAs (loads, Q's split, ldmatrix, the
// softmax, P's split) takes 0.147 ms with the split, and the MMAs add
// ~0.067 on top: the two overlap little, as in lmhead_ce.cu's loop. Per
// warp and 32-key tile it issues 120 ldmatrix.x4 for 384 MMAs, and every
// query tile re-reads its K/V tiles' three planes from L2; 64-key tiles
// (one block an SM) and 128-row query tiles of 8 warps measured 42 % and
// 14 % slower. ptxas: 255 registers, 8 bytes of spill at HD = 128; 240
// and none at HD = 64 (HD = 256's budget: chip_smoke.py prints ptxas's
// report at every build, PERF.md keeps it).
//
// The bf16 branch at HD = 128 (a bf16 backbone's q, k, v and o; the
// reference's kernel takes bf16 and casts O to q's dtype) runs on its own
// kernel, fwg::flash_fwd_wg, on Hopper's asynchronous loop (wgmma_loop.cuh).
// Q, K and V are exact in bf16, so each goes to the tensor cores whole, one
// plane: Q·Kᵀ takes one product, P·V three (P stays f32, split in three
// bf16 terms, the reference's f32 P); the softmax and O sum in f32 and O
// is rounded to bf16 once. At the prefill shape the products are 17.2
// GFLOP, 0.0174 ms at 989 TFLOP/s, on ~50 MB (0.015 ms at 3.35 TB/s).
//  * The block: (bh, 128 query rows), grid (BH, ceil(Sq / 128)), longest
//    query tiles first; two consumer warpgroups of 64 rows and a producer
//    warpgroup (384 threads, one block an SM, setmaxnreg 232 / 40).
//  * TMA reads q, k and v where they lie, through 3-D maps (128, S, heads)
//    (wgmma_loop.cuh's tensor_map3): a box past Sq or Sk reads zeros, never
//    the next head's rows, so no padding pass and no scratch (flash_pad and
//    its copy are gone from this path). Q once a block, two 64-column
//    boxes; K and V of each 64-key tile through a two-stage ring, each with
//    its full and empty mbarriers. Query row bh reads KV head bh / n_rep.
//  * S = Q·Kᵀ on wgmma m64n64k16, both operands K-major from shared memory:
//    each 64-deep half of the head into a fresh f32 sum, one add joins
//    them. P·V on m64n128k16 with A from registers: the C fragments of S's
//    n8 tiles 2kc, 2kc + 1 are the A fragment of k16 step kc, each p split
//    in three bf16 terms there; V (keys, HD) is the MN-major B. The tile's
//    twelve products go into a fresh f32 sum, the terms smallest first,
//    which O = O·alpha + sum joins. The CPU model of this order
//    (tests/test_torch_kernels.py::test_flash_bf16_wgmma_promotion_error_model)
//    errs as the mma.sync loop's fresh sum a k16 step; one chain over the
//    head errs ~1.25x more and P·V straight into O ~1.9x (RMS).
//  * The softmax is flash_fwd_mma's, in the same C layout (a warp's 16 rows:
//    quad shuffles), the mask only on tiles that cross the warp's diagonal,
//    window edge or Sk. A key tile with no key in a warpgroup's band is
//    waited for and released unread by that warpgroup.
//  * Registers: O 64, P·V's fresh sum 64, P's terms 48 a thread, 229 of
//    the 232 in use (SASS), no spill. So a warpgroup's loop is serial: S,
//    its wait, the softmax, P·V, its wait; the two warpgroups overlap each
//    other. A second S in flight (FlashAttention-3's intra-warpgroup
//    overlap) does not fit; turns at the tensor cores between the two
//    warpgroups (named barriers) and P's terms through shared memory (to
//    free their registers for the overlap) ran slower in trials.
//  * Epilogue: O / l in bf16, rows >= Sq not stored; a row with no key
//    stays 0 for the wrapper. Fixed order, no atomics: bit-equal reruns.
// What holds it (../flash_variants.py --bf16; NVIDIA H100 80GB HBM3, 700 W):
// 0.065–0.071 ms at the prefill shape, 0.033–0.037 at the epoch-1 step's
// BH = 4·16, against 0.098–0.101 / 0.053–0.056 for the mma.sync loop it
// replaced (flash_pad + flash_fwd_mma<128, true>, BF16_ON_WGMMA = 0) in the
// same process. The producer's TMA stream alone takes 0.031–0.032 (the L2
// is flushed before each timing, so Q, K and V come from device memory
// beside the flush's write-backs), the loop without wgmma 0.045, without
// the softmax 0.052–0.053: the three add up, little overlaps. 128-key
// tiles spill (972 bytes) and take 0.105–0.108.
//
// bf16 at HD = 64, 112 and 256 (a bf16 gemma2-2b, musicgen, kimi-k2, the
// Table III models) runs on flash_fwd_mma<HD, true>: flash_pad copies K and
// V into one padded plane each, Q is staged whole, and the loop is the f32
// one with one term of Q, K and V (Q·Kᵀ one product a k16 step, P·V three:
// P keeps its three terms); O is rounded to bf16 once. Shared memory is a
// third of the f32 loop's: 18,432 B (HD = 64), 30,720 (112) and 67,584
// (256) a block. Moving these widths onto fwg's loop needs its own design
// at 256, where O and P·V's fresh sum alone would take 256 of a consumer's
// 232 registers.
//
// Tolerance: the reference's flash tolerance, atol 3e-5
// (tests/test_kernels.py:105); the CPU model of this arithmetic
// (tests/test_torch_kernels.py::test_flash_bf16_split_error_model, S = 256,
// HD = 128) errs 4.5e-7 against float64 attention with three terms, under
// the Pallas kernel's own f32 error (9.5e-7), 1.3e-5 with two, 8e-3 with one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mix_tile.cuh"
#include "wgmma_loop.cuh"

namespace {

namespace flash {

using namespace mix_tile;

constexpr int GROUPS = 4;           // 16-row query groups a block
constexpr int BQ = 16 * GROUPS;     // query rows per block
constexpr int BKV = 32;             // keys per tile
constexpr int TERMS = 3;            // bf16 terms of each f32 operand
constexpr int NT = BKV / 8;         // S's n8 tiles a warp holds
constexpr int NG = 8;               // P·V's n8 tiles summed together
constexpr int SPLIT_THREADS = 256;
static_assert(NT % 2 == 0, "whole k16 steps of P·V");

// the block's shape at head width HD: CW warps share a 16-row group, each
// accumulating HD / CW of O's columns
template <int HD>
struct Shape {
  static constexpr int CW = HD > 128 ? 2 : 1;
  static constexpr int WARPS = GROUPS * CW;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = CW == 1 ? 2 : 1;  // per SM: 102 KB (HD = 128), 198 KB (256)
  static constexpr int HDW = HD / CW;                 // O's columns a warp owns
};

// a staged row: HD bf16 values and 16 bytes of padding, so that the 8 rows
// one ldmatrix matrix reads start in 8 different 16-byte bank groups, and
// every fragment's address is the lane's base plus a constant
template <int HD>
__host__ __device__ constexpr int row_ld() { return HD + 8; }

// bf16 terms of each of Q, K and V: three for f32 inputs, one for bf16
// ones (exact in bf16, they go to the tensor cores whole)
template <bool BF>
__host__ __device__ constexpr int in_terms() { return BF ? 1 : TERMS; }

template <int HD, bool BF>
__host__ __device__ constexpr int smem_bytes() {
  return in_terms<BF>() * (BQ + 2 * BKV) * row_ld<HD>() * (int)sizeof(uint16_t);
}

// dst: K's three planes (BHkv, Skp, HD), then V's (blockIdx.y picks which),
// `plane` values each; rows past Sk are zero. Four values a thread.
__global__ void flash_split(const float* __restrict__ k, const float* __restrict__ v,
                            uint16_t* __restrict__ dst, int Sk, int Skp, int hd,
                            long long plane) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= plane) return;
  const float* __restrict__ src = blockIdx.y ? v : k;
  uint16_t* __restrict__ out = dst + blockIdx.y * TERMS * plane;
  const long long row = e / hd;  // (head, key) of the padded plane
  const int key = (int)(row % Skp), d = (int)(e % hd);
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (key < Sk) f = *reinterpret_cast<const float4*>(src + ((row / Skp) * Sk + key) * hd + d);
  uint32_t w01[3], w23[3];
  split3(f.x, f.y, w01);
  split3(f.z, f.w, w23);
#pragma unroll
  for (int j = 0; j < TERMS; ++j)
    *reinterpret_cast<uint2*>(out + j * plane + e) = make_uint2(w01[j], w23[j]);
}

// The bf16 branch's K and V on flash_fwd_mma (HD = 64, 112 and 256; 128
// only with BF16_ON_WGMMA = 0): one plane each, K's (BHkv, Skp, HD) then
// V's (blockIdx.y picks which), `plane` values each, rows past Sk zero.
// bf16 values go to the tensor cores whole, so they are only padded to
// whole key tiles. Four values a thread.
__global__ void flash_pad(const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                          uint16_t* __restrict__ dst, int Sk, int Skp, int hd, long long plane) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= plane) return;
  const uint16_t* __restrict__ src = blockIdx.y ? v : k;
  const long long row = e / hd;  // (head, key) of the padded plane
  const int key = (int)(row % Skp), d = (int)(e % hd);
  uint2 w = make_uint2(0u, 0u);
  if (key < Sk) w = *reinterpret_cast<const uint2*>(src + ((row / Skp) * Sk + key) * hd + d);
  *reinterpret_cast<uint2*>(dst + blockIdx.y * plane + e) = w;
}

// One block per (bh, query tile): grid (BH, ceil(Sq / BQ)). kv is
// flash_split's scratch (BF: flash_pad's). BF: q and o are bf16 (their
// raw bits), else f32.
template <int HD, bool BF>
__global__ void __launch_bounds__(Shape<HD>::THREADS, Shape<HD>::MIN_BLOCKS)
flash_fwd_mma(const std::conditional_t<BF, uint16_t, float>* __restrict__ q,
              const uint16_t* __restrict__ kv, std::conditional_t<BF, uint16_t, float>* __restrict__ o,
              int Sq, int Sk, int Skp, int n_rep, int causal, int window, float cap, float scale,
              long long plane) {
  constexpr int TKV = in_terms<BF>();  // terms of Q, K and V; P always has three
  constexpr int THREADS = Shape<HD>::THREADS, HDW = Shape<HD>::HDW;
  constexpr int LD = row_ld<HD>();
  constexpr int Q_TILE = BQ * LD, KV_TILE = BKV * LD;  // bf16 values of one staged term
  constexpr int KSTEPS = HD / 16;                      // k16 steps of Q·Kᵀ
  constexpr int NO = HDW / 8;                          // O's n8 tiles a warp holds
  constexpr int CPR = HD / 8;                          // 16-byte chunks of a row
  constexpr int KV_CHUNKS = BKV * CPR;                 // chunks of a K/V term's tile
  constexpr int CHUNKS = (KV_CHUNKS + THREADS - 1) / THREADS;  // a thread's, at most
  static_assert(NO % NG % 2 == 0, "P·V's groups take n8 tiles in pairs");
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;               // TKV x BQ x LD
  uint16_t* ks = qs + TKV * Q_TILE;  // TKV x BKV x LD
  uint16_t* vs = ks + TKV * KV_TILE; // TKV x BKV x LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rows 16·grp and O's columns from col0 (folded to warp and 0 at CW = 1,
  // which keeps HD <= 128's registers as they were)
  constexpr int CW = Shape<HD>::CW;
  const int grp = CW == 1 ? warp : warp % GROUPS;
  const int col0 = CW == 1 ? 0 : (warp / GROUPS) * HDW;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest query tiles first
  const uint16_t* __restrict__ kg = kv + (size_t)(bh / n_rep) * Skp * HD;
  const uint16_t* __restrict__ vg = kg + TKV * plane;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;  // exclusive
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BKV) * BKV;

  // the TKV planes' BKV x HD tile at key k0 -> `dst`, in padded rows
  auto load_kv = [&](uint16_t* dst, const uint16_t* __restrict__ src, int k0) {
#pragma unroll
    for (int j = 0; j < TKV; ++j)
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int c = tid + i * THREADS, r = c / CPR, m = (c % CPR) * 8;
        if (KV_CHUNKS % THREADS == 0 || c < KV_CHUNKS)
          cp_async16(dst + j * KV_TILE + r * LD + m, src + j * plane + (size_t)(k0 + r) * HD + m);
      }
  };

  if (k_begin < k_end) load_kv(ks, kg, k_begin);
  cp_commit();
  // Q: f32 rows split in three terms as staged, bf16 rows copied whole,
  // 16 bytes a thread (rows past Sq are zero)
  const auto* __restrict__ qb = q + ((size_t)bh * Sq + q0) * HD;
  if constexpr (BF) {
#pragma unroll 4
    for (int i = 0; i < BQ * HD / 8 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Sq) w = *reinterpret_cast<const uint4*>(qb + (size_t)r * HD + d);
      *reinterpret_cast<uint4*>(qs + r * LD + d) = w;
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < BQ * HD / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (HD / 4), d = (c % (HD / 4)) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) f = *reinterpret_cast<const float4*>(qb + (size_t)r * HD + d);
      uint32_t w01[3], w23[3];
      split3(f.x, f.y, w01);
      split3(f.z, f.w, w23);
#pragma unroll
      for (int j = 0; j < TERMS; ++j)
        *reinterpret_cast<uint2*>(qs + j * Q_TILE + r * LD + d) = make_uint2(w01[j], w23[j]);
    }
  }

  // ldmatrix row of this lane, matrix lj = lane / 8, row lane % 8:
  // Q (A, [row][hd]): (rows 0-7, hd 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
  // K (B = Kᵀ, [key][hd] as stored): (keys 0-7, hd 0-7), (0-7, 8-15),
  //   (8-15, 0-7), (8-15, 8-15): two n8 tiles' b0, b1;
  // V (B, [key][hd], transposed): (keys 0-7, hd 0-7), (8-15, 0-7),
  //   (0-7, 8-15), (8-15, 8-15): two n8 tiles' b0, b1.
  const int lj = lane >> 3, lr = lane & 7;
  const uint32_t q_lane = smem_addr(qs + (16 * grp + ((lj & 1) << 3) + lr) * LD + ((lj >> 1) << 3));
  const uint32_t k_lane = smem_addr(ks + (((lj >> 1) << 3) + lr) * LD + ((lj & 1) << 3));
  const uint32_t v_lane =
      smem_addr(vs + (((lj & 1) << 3) + lr) * LD + col0 + ((lj >> 1) << 3));
  constexpr int B = (int)sizeof(uint16_t);  // bytes of a staged value
  // C fragment: rows lane/4 (+8), columns 2·(lane%4) (+1) of each 16 x 8 tile
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = q0 + 16 * grp + gq;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // S = Q·Kᵀ for the warp's 16 rows x BKV keys
  auto scores = [&](float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[TKV][4];
#pragma unroll
      for (int i = 0; i < TKV; ++i) ldsm_x4(qa[i], q_lane + B * (i * Q_TILE + 16 * kk));
      uint32_t kb[TKV][NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
#pragma unroll
        for (int j = 0; j < TKV; ++j) {
          uint32_t r[4];
          ldsm_x4(r, k_lane + B * (j * KV_TILE + 16 * np * LD + 16 * kk));
          kb[j][2 * np][0] = r[0];
          kb[j][2 * np][1] = r[1];
          kb[j][2 * np + 1][0] = r[2];
          kb[j][2 * np + 1][1] = r[3];
        }
      // the k16 step into a fresh f32 sum, smallest products first
      // (terms i + j = 2, 1, then hi·hi; bf16 inputs: the one product)
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int ord = TKV - 1; ord >= 0; --ord)
#pragma unroll
        for (int i = 0; i <= ord; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(part[nt], qa[i], kb[ord - i][nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += part[nt][e];
    }
  };

  // s -> p in place: scale, softcap, the mask where the tile at k0 crosses
  // the band's or Sk's edge, then the online softmax's update of m, l, O
  auto softmax = [&](float (&s)[NT][4], int k0) {
    const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int row = row0 + 8 * (e >> 1), key = k0 + 8 * nt + 2 * tq + (e & 1);
          const bool valid = key < Sk && (!causal || key <= row) &&
                             (window <= 0 || row - key < window);
          if (!valid) x = -INFINITY;
        }
        s[nt][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float mu[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m_run[h], mt[h]);
      mu[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      alpha[h] = expf(m_run[h] - mu[h]);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mu[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + ls[h];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
  };

  // O's n8 tiles [n0, n0 + G) += P·V for k16 step kc, pa P's three terms
  // (V's: three, or one bf16 plane)
  auto pv_group = [&](const uint32_t (&pa)[TERMS][4], int kc, int n0, auto g) {
    constexpr int G = decltype(g)::value;
    uint32_t vb[TKV][G][2];
#pragma unroll
    for (int np = 0; np < G / 2; ++np)
#pragma unroll
      for (int j = 0; j < TKV; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, v_lane + B * (j * KV_TILE + 16 * kc * LD + 8 * n0 + 16 * np));
        vb[j][2 * np][0] = r[0];
        vb[j][2 * np][1] = r[1];
        vb[j][2 * np + 1][0] = r[2];
        vb[j][2 * np + 1][1] = r[3];
      }
    float part[G][4];
#pragma unroll
    for (int nt = 0; nt < G; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
    for (int ord = 2; ord >= 0; --ord)
#pragma unroll
      for (int i = ord - (TKV - 1) > 0 ? ord - (TKV - 1) : 0; i <= ord; ++i)  // V's term < TKV
#pragma unroll
        for (int nt = 0; nt < G; ++nt) mma_bf16(part[nt], pa[i], vb[ord - i][nt]);
#pragma unroll
    for (int nt = 0; nt < G; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + nt][e] += part[nt][e];
  };

  // O += P·V: the C fragments of S's n8 tiles 2kc, 2kc + 1 are the A
  // fragment of k16 step kc, split in three bf16 terms in registers; O's
  // tiles go NG at a time, then the rest (HD = 112: 8, then 6)
  auto add_pv = [&](const float (&p)[NT][4]) {
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t pa[TERMS][4], w[3];
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // a0..a3: rows +0, +8 of keys 0-7, then of keys 8-15
        split3(p[2 * kc + (x >> 1)][2 * (x & 1)], p[2 * kc + (x >> 1)][2 * (x & 1) + 1], w);
#pragma unroll
        for (int j = 0; j < TERMS; ++j) pa[j][x] = w[j];
      }
#pragma unroll
      for (int ng = 0; ng < NO / NG; ++ng)
        pv_group(pa, kc, NG * ng, std::integral_constant<int, NG>{});
      if constexpr (NO % NG != 0)
        pv_group(pa, kc, NO - NO % NG, std::integral_constant<int, NO % NG>{});
    }
  };

  for (int k0 = k_begin; k0 < k_end; k0 += BKV) {
    cp_wait<0>();     // K(k0) has landed (this thread's copies) ...
    __syncthreads();  // ... every thread's; V's buffer is free (and Q stored)
    load_kv(vs, vg, k0);
    cp_commit();
    float s[NT][4];
    scores(s);
    softmax(s, k0);
    cp_wait<0>();     // V(k0) has landed ...
    __syncthreads();  // ... every thread's; K's buffer is free
    if (k0 + BKV < k_end) load_kv(ks, kg, k0 + BKV);
    cp_commit();
    add_pv(s);
  }
  cp_wait<0>();

  // O / l, l summed over the quad in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    auto* __restrict__ orow = o + ((size_t)bh * Sq + row) * HD + col0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if constexpr (BF)  // O in q's dtype, as the reference casts it
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            bits(__floats2bfloat162_rn(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv));
      else
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

inline int key_rows(int Sk) { return (Sk + BKV - 1) / BKV * BKV; }

// BF: q, k, v and o bf16 (K and V padded, one plane each), else f32 (K
// and V split in three)
template <int HD, bool BF>
int launch(const void* q, const void* k, const void* v, void* o, uint16_t* scratch, int BH,
           int Sq, int Sk, int n_rep, int causal, int window, float cap, float scale,
           cudaStream_t s) {
  using T = std::conditional_t<BF, uint16_t, float>;
  const int Skp = key_rows(Sk);
  const long long plane = (long long)(BH / n_rep) * Skp * HD;
  if (plane > 0) {
    const long long blocks = (plane / 4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
    if constexpr (BF)
      flash_pad<<<dim3((unsigned)blocks, 2), SPLIT_THREADS, 0, s>>>(
          (const uint16_t*)k, (const uint16_t*)v, scratch, Sk, Skp, HD, plane);
    else
      flash_split<<<dim3((unsigned)blocks, 2), SPLIT_THREADS, 0, s>>>(
          (const float*)k, (const float*)v, scratch, Sk, Skp, HD, plane);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (Sq == 0) return 0;
  constexpr int smem = smem_bytes<HD, BF>();
  static bool opted = false;  // once, before any graph capture of the launch
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma<HD, BF>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  flash_fwd_mma<HD, BF><<<dim3(BH, (Sq + BQ - 1) / BQ), Shape<HD>::THREADS, smem, s>>>(
      (const T*)q, scratch, (T*)o, Sq, Sk, Skp, n_rep, causal, window, cap, scale, plane);
  return (int)cudaGetLastError();
}

}  // namespace flash

// ---- the bf16 branch on Hopper's asynchronous loop (wgmma_loop.cuh)

namespace fwg {

using namespace mix_tile;
using wgl::BK;                         // a TMA box's columns: one 128-byte swizzled row
constexpr int HD = 128;                // the bf16 backbone's head width
constexpr int BQ = 64 * wgl::CONSUMERS;  // query rows a block: 64 a consumer warpgroup
constexpr int BKV = 64;                // keys a tile
constexpr int STAGES = 2;              // K and V tiles in flight
constexpr int NS = BKV / 2;            // S's f32 values a thread (a warpgroup's 64 x BKV)
constexpr int KC = BKV / 16;           // k16 steps of P·V a tile
constexpr int Q_BOX = BQ * BK * 2;     // bytes of one of Q's two 64-column boxes
constexpr int KV_BOX = BKV * BK * 2;   // ... of one of a K or V tile's two boxes
constexpr int KV_TILE = 2 * KV_BOX;
constexpr int SMEM = 1024 + 2 * Q_BOX + 2 * STAGES * KV_TILE + (1 + 4 * STAGES) * 8;
static_assert(BKV == 64 || BKV == 128, "S on m64n64k16 or m64n128k16");

// S (+)= Q·Kᵀ over one k16 step, the warpgroup's 64 rows x BKV keys (N = NS)
template <int N>
__device__ __forceinline__ void qk_mma(float (&d)[N], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 32)
    wgl::mma_n64<0>(d, a, b, accumulate);
  else
    wgl::mma<0>(d, a, b, accumulate);
}

// One block per (bh, 128-row query tile), grid (BH, ceil(Sq / BQ)), the
// longest query tiles first. qmap: q (BH, Sq, HD); kmap, vmap: k, v
// (BH / n_rep, Sk, HD), all bf16 and read in place (tensor_map3); o (BH,
// Sq, HD) bf16. The producer thread loads Q once, then each key tile's K
// and V into their rings; each consumer warpgroup runs its 64 rows over
// the tiles (the source's note).
__global__ void __launch_bounds__(wgl::THREADS, 1)
flash_fwd_wg(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, uint16_t* __restrict__ o, int Sq, int Sk,
             int n_rep, int causal, int window, float cap, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - wgl::saddr(smem_raw) % 1024) % 1024);
  uint8_t* ks = qs + 2 * Q_BOX;
  uint8_t* vs = ks + STAGES * KV_TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * KV_TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  if (threadIdx.x == 0) {
    wgl::bar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wgl::bar_init(&k_full[s], 1);  // the producer's arrive, plus the bytes
      wgl::bar_init(&v_full[s], 1);
      wgl::bar_init(&k_empty[s], 4 * wgl::CONSUMERS);  // one arrive a consumer warp
      wgl::bar_init(&v_empty[s], 4 * wgl::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest query tiles first
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;  // exclusive
  const int k_begin = (window > 0 ? max(0, q0 - window + 1) : 0) / BKV * BKV;
  const int tiles = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  if (wgl::producer_warp()) {
    wgl::producer_regs();
    if (wgl::producer_thread() && tiles > 0) {
      wgl::prefetch_map(&qmap);
      wgl::prefetch_map(&kmap);
      wgl::prefetch_map(&vmap);
      wgl::bar_expect(q_full, 2 * Q_BOX);
      wgl::tma_load3(qs, &qmap, 0, q0, bh, q_full);
      wgl::tma_load3(qs + Q_BOX, &qmap, BK, q0, bh, q_full);
      const int kvh = bh / n_rep;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % STAGES, k0 = k_begin + it * BKV;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        wgl::bar_wait(&k_empty[s], parity);
        wgl::bar_expect(&k_full[s], KV_TILE);
        wgl::tma_load3(ks + s * KV_TILE, &kmap, 0, k0, kvh, &k_full[s]);
        wgl::tma_load3(ks + s * KV_TILE + KV_BOX, &kmap, BK, k0, kvh, &k_full[s]);
        wgl::bar_wait(&v_empty[s], parity);
        wgl::bar_expect(&v_full[s], KV_TILE);
        wgl::tma_load3(vs + s * KV_TILE, &vmap, 0, k0, kvh, &v_full[s]);
        wgl::tma_load3(vs + s * KV_TILE + KV_BOX, &vmap, BK, k0, kvh, &v_full[s]);
      }
    }
  } else {
    wgl::consumer_regs();
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;  // the C fragment's row and column pair
    const int w0 = q0 + 16 * warp;            // the warp's first row
    const int row0 = w0 + gq;                 // this thread's rows: row0, row0 + 8
    const int g0 = q0 + 64 * wg;              // the warpgroup's first row ...
    const int g_last = min(g0 + 63, Sq - 1);  // ... and last below Sq
    // this warpgroup's 64 rows of Q's two boxes (A, K-major)
    const uint32_t qa = wgl::saddr(qs) + wg * 64 * BK * 2;

    float acc[64];  // O, unnormalised: the warpgroup's 64 rows x HD
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    // s -> p in place: scale, softcap, the mask where the tile at k0 crosses
    // the warp's band or Sk, then the online softmax's m and l; alpha: the
    // factor of O's rows (flash_fwd_mma's softmax, in the same C layout)
    auto softmax = [&](float (&s)[NS], int k0, float (&alpha)[2]) {
      const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > w0) ||
                        (window > 0 && w0 + 15 - k0 >= window);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = s[i] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int row = row0 + 8 * ((i & 3) >> 1), key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          const bool valid = key < Sk && (!causal || key <= row) &&
                             (window <= 0 || row - key < window);
          if (!valid) x = -INFINITY;
        }
        s[i] = x;
        mt[(i & 3) >> 1] = fmaxf(mt[(i & 3) >> 1], x);
      }
      float mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m_run[h], mt[h]);
        mu[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
        alpha[h] = expf(m_run[h] - mu[h]);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float p = expf(s[i] - mu[(i & 3) >> 1]);
        s[i] = p;
        ls[(i & 3) >> 1] += p;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + ls[h];
    };

    if (tiles > 0) wgl::bar_wait(q_full, 0);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % STAGES, k0 = k_begin + it * BKV;
      const uint32_t parity = (it / STAGES) & 1;
      // whether any of the warpgroup's rows below Sq has a key of this tile
      // in its band; a tile outside it is waited for and released unread
      const bool live = g0 < Sq && (!causal || k0 <= g_last) &&
                        (window <= 0 || g0 - (k0 + BKV - 1) < window);
      float sc[NS], sp[NS], alpha[2];
      uint32_t pa[3 * KC][4];  // P's terms: pa[KC·t + kc], t 0 hi, 1 mid, 2 lo
      wgl::bar_wait(&k_full[s], parity);
      // S = Q·Kᵀ: each 64-deep half of the head (one box of Q and of K) into
      // a fresh f32 sum, one add then joins them
      if (live) {
        const uint32_t kb = wgl::saddr(ks + s * KV_TILE);
        auto qk_half = [&](float (&d)[NS], int box) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = wgl::desc(qa + box * Q_BOX + 32 * kk, 16, 1024);
            const uint64_t db = wgl::desc(kb + box * KV_BOX + 32 * kk, 16, 1024);
            qk_mma(d, da, db, kk > 0);
          }
          wgl::mma_commit();
        };
        wgl::pin(sc);
        wgl::pin(sp);
        wgl::mma_fence();
        qk_half(sc, 0);
        qk_half(sp, 1);
        wgl::mma_wait<0>();
        wgl::pin(sc);
        wgl::pin(sp);
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] += sp[i];
      }
      if (lane == 0) wgl::bar_arrive(&k_empty[s]);
      if (live) {
        softmax(sc, k0, alpha);
        // the C fragments of S's n8 tiles 2kc, 2kc + 1 are the A fragment of
        // P·V's k16 step kc, each p split in three bf16 terms
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int x = 0; x < 4; ++x) {  // a0..a3: rows +0, +8 of keys 0-7, then of keys 8-15
            uint32_t w[3];
            const int i = 4 * (2 * kc + (x >> 1)) + 2 * (x & 1);
            split3(sc[i], sc[i + 1], w);
#pragma unroll
            for (int t = 0; t < 3; ++t) pa[KC * t + kc][x] = w[t];
          }
      }
      wgl::bar_wait(&v_full[s], parity);
      // P·V into a fresh f32 sum a tile, P's terms smallest first, each over
      // the tile's k16 steps; V (keys, HD) is the MN-major B
      if (live) {
        float part[64];
        const uint32_t vb = wgl::saddr(vs + s * KV_TILE);
        wgl::pin(part);
        wgl::mma_fence();
#pragma unroll
        for (int t = 2; t >= 0; --t)
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            wgl::mma_rs<1>(part, pa[KC * t + kc], wgl::desc(vb + 16 * 128 * kc, KV_BOX, 1024),
                           t < 2 || kc > 0);
        wgl::mma_commit();
        wgl::mma_wait<0>();
        wgl::pin(part);
        wgl::pin(pa);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = acc[i] * alpha[(i & 3) >> 1] + part[i];
      }
      if (lane == 0) wgl::bar_arrive(&v_empty[s]);
    }

    // O / l in bf16, l summed over the quad in a fixed order; rows >= Sq are
    // not stored, a row with no key (l = 0) stays 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * h;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      uint16_t* __restrict__ orow = o + ((size_t)bh * Sq + row) * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            bits(__floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv));
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
           int n_rep, int causal, int window, float cap, float scale, cudaStream_t s) {
  if (Sq <= 0) return (int)cudaSuccess;
  static bool opted = false;  // once, before any graph capture of the launch
  if (!opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_fwd_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  CUtensorMap qmap, kmap = {}, vmap = {};  // no K/V map without keys (no tile reads one)
  cudaError_t e = wgl::tensor_map3(&qmap, q, BH, Sq, HD, BQ);
  if (e == cudaSuccess && Sk > 0) e = wgl::tensor_map3(&kmap, k, BH / n_rep, Sk, HD, BKV);
  if (e == cudaSuccess && Sk > 0) e = wgl::tensor_map3(&vmap, v, BH / n_rep, Sk, HD, BKV);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wg<<<dim3(BH, (Sq + BQ - 1) / BQ), wgl::THREADS, SMEM, s>>>(
      qmap, kmap, vmap, static_cast<uint16_t*>(o), Sq, Sk, n_rep, causal, window, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace fwg

// 1: bf16 q, k, v at HD = 128 run on fwg's loop (TMA + wgmma, no scratch);
// 0: on flash_fwd_mma<128, true> with flash_pad's scratch, the loop they
// took before (kept for flash_variants.py's comparison only). bf16 at the
// other head widths runs on flash_fwd_mma<HD, true> either way.
constexpr int BF16_ON_WGMMA = 1;

// a call at head width hd on the loop its type takes there (BF: bf16 q, k,
// v and o): flash_fwd_mma<HD, BF>, or fwg's for bf16 at 128 (a constexpr
// branch, so the loop it replaces is not built)
template <bool BF>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, uint16_t* kv, int BH,
              int Sq, int Sk, int n_rep, int causal, int window, float cap, float scale,
              cudaStream_t s) {
  switch (hd) {
    case 64:
      return flash::launch<64, BF>(q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap, scale,
                                   s);
    case 112:
      return flash::launch<112, BF>(q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap, scale,
                                    s);
    case 128:
      if constexpr (BF && BF16_ON_WGMMA)
        return fwg::launch(q, k, v, o, BH, Sq, Sk, n_rep, causal, window, cap, scale, s);
      else
        return flash::launch<128, BF>(q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap,
                                      scale, s);
    case 256:
      return flash::launch<256, BF>(q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap, scale,
                                    s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 where a call of this type and head width runs on the wgmma loop (bf:
// bf16 q, k, v)
int flash_wgmma(int bf, int hd) { return bf && hd == fwg::HD && BF16_ON_WGMMA; }

// keys a tile of flash_fwd_mma, whose K/V scratch holds whole tiles
// (flash_attention.py's scratch_elems)
int flash_key_tile() { return flash::BKV; }

// bf: q, k, v and o bf16, else f32; hd 64, 112, 128 or 256 either way;
// scratch: flash_attention.py's scratch_elems bf16 values (none on the
// wgmma loop)
int flash_launch(const void* q, const void* k, const void* v, void* o, void* scratch, int BH,
                 int Sq, int Sk, int hd, int n_rep, int causal, int window, float cap,
                 float scale, int bf, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  uint16_t* kv = static_cast<uint16_t*>(scratch);
  if (bf)
    return launch_hd<true>(hd, q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap, scale, s);
  return launch_hd<false>(hd, q, k, v, o, kv, BH, Sq, Sk, n_rep, causal, window, cap, scale, s);
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
