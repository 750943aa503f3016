// Paged-KV decode attention for sm_90a (one decode step, grouped GQA).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py (_kernel /
// _paged_attention_call, public paged_attention). q, out: (B, Hkv, n_rep,
// HD) f32; k/v pages: (n_pages, page, Hkv, HD) int8 with f32 scales
// (n_pages, page, Hkv), or plain f32 / bf16; block_tables (B, max_pages)
// int32 (page 0 is the null page); lengths (B,) int32 — the index the new
// token was written at, attended (kpos <= lengths[b]). Options: sliding
// window (window > 0: kpos > lengths[b] - window) and tanh softcap
// (cap > 0).
//
// One block per (request b, kv head g). The block reads its own block
// table row and length (no scalar prefetch on the card) and walks only
// the positions its query attends, so masked slots are never loaded and
// a padding row (length 0, null page) attends one finite slot. Each of
// the 8 warps owns every 8th position and keeps its own online softmax
// (m, l, acc) in registers; a lane holds HD/32 consecutive dims, so a
// warp reads one token's K (or V) row for head g as one contiguous
// HD-byte (int8) run. INT8 rows are dequantized in registers as
// float(q) * scale, the reference's product. The warps' states are merged
// in shared memory at the end (flash-decoding style), replacing the TPU
// kernel's sequential page axis and its VMEM accumulator.
//
// Bound on the H100: bytes — every attended K/V row is read once
// (int8: 2 * (HD + 4) bytes per token and kv head), against 4 * n_rep * HD
// FLOPs on it. Limits of this version: HD in {64, 128}, n_rep <= 8, any
// page size and number of kv heads (the TPU envelope assert of page <= 64,
// hkv <= 16 does not apply).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8, THREADS = NWARPS * 32, MAX_REP = 8;
constexpr float NEG_INF = -1e30f;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float out[VEC]) {
  const Vec<T, VEC> r = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f32(r.v[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
paged_attn(const float* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
           const float* __restrict__ ks, const float* __restrict__ vs,
           const int* __restrict__ block_tables, const int* __restrict__ lengths,
           float* __restrict__ out, int Hkv, int n_rep, int page, int max_pages, int window,
           float cap, float scale) {
  constexpr int VEC = HD / 32;
  __shared__ float sm_m[NWARPS][MAX_REP], sm_l[NWARPS][MAX_REP];
  __shared__ float sm_acc[NWARPS][MAX_REP][HD];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int pos = lengths[b];
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, max_pages * page - 1);
  const int* bt = block_tables + (size_t)b * max_pages;
  const float* qb = q + ((size_t)b * Hkv + g) * n_rep * HD;

  float qr[MAX_REP][VEC], acc[MAX_REP][VEC], m[MAX_REP], l[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = NEG_INF; l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[r][e] = r < n_rep ? qb[(size_t)r * HD + lane * VEC + e] : 0.f;
      acc[r][e] = 0.f;
    }
  }

  for (int t = lo + warp; t <= hi; t += NWARPS) {
    const size_t row = ((size_t)bt[t / page] * page + t % page) * Hkv + g;
    float kv[VEC], vv[VEC];
    load_row<T, VEC>(kp + row * HD + lane * VEC, kv);
    load_row<T, VEC>(vp + row * HD + lane * VEC, vv);
    if (ks != nullptr) {
      const float sk = ks[row], sv = vs[row];
#pragma unroll
      for (int e = 0; e < VEC; ++e) { kv[e] = kv[e] * sk; vv[e] = vv[e] * sv; }
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= n_rep) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += qr[r][e] * kv[e];
      s = warp_sum(s) * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const float m_new = fmaxf(m[r], s);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = acc[r][e] * alpha + p * vv[e];
    }
  }

#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    if (lane == 0) { sm_m[warp][r] = m[r]; sm_l[warp][r] = l[r]; }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[warp][r][lane * VEC + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_rep * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][r] - M);
      L += sm_l[w][r] * c;
      O += sm_acc[w][r][d] * c;
    }
    out[(((size_t)b * Hkv + g) * n_rep + r) * HD + d] = O / fmaxf(L, 1e-30f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* bt, const void* lengths, void* out, int B, int Hkv, int n_rep, int page,
           int max_pages, int window, float cap, float scale, cudaStream_t stream) {
  paged_attn<T, HD><<<B * Hkv, THREADS, 0, stream>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const float*)ks, (const float*)vs,
      (const int*)bt, (const int*)lengths, (float*)out, Hkv, n_rep, page, max_pages, window, cap,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kp, const void* vp, const void* ks,
              const void* vs, const void* bt, const void* lengths, void* out, int B, int Hkv,
              int n_rep, int page, int max_pages, int window, float cap, float scale,
              cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep, page, max_pages,
                         window, cap, scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep, page, max_pages,
                          window, cap, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int paged_max_rep() { return MAX_REP; }

// kind: 0 = int8 pages with scales, 1 = f32 pages, 2 = bf16 pages
int paged_launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const void* bt, const void* lengths, void* out, int B, int Hkv, int n_rep,
                 int hd, int page, int max_pages, int kind, int window, float cap, float scale,
                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n_rep < 1 || n_rep > MAX_REP) return (int)cudaErrorInvalidValue;
  if (kind == 0)
    return launch_hd<int8_t>(hd, q, kp, vp, ks, vs, bt, lengths, out, B, Hkv, n_rep, page,
                             max_pages, window, cap, scale, s);
  if (kind == 1)
    return launch_hd<float>(hd, q, kp, vp, nullptr, nullptr, bt, lengths, out, B, Hkv, n_rep,
                            page, max_pages, window, cap, scale, s);
  if (kind == 2)
    return launch_hd<__nv_bfloat16>(hd, q, kp, vp, nullptr, nullptr, bt, lengths, out, B, Hkv,
                                    n_rep, page, max_pages, window, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
