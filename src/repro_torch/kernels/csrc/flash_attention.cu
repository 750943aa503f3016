// Causal online-softmax ("flash") attention forward for sm_90a, f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel /
// flash_attention_tpu). q, o: (BH, Sq, HD); k, v: (BH / n_rep, Sk, HD),
// all f32 row-major — query row bh reads kv row bh / n_rep, i.e. grouped
// GQA heads read directly instead of the repeated-KV copy the TPU path
// builds. Options: causal mask, sliding window (window > 0), tanh softcap
// (cap > 0). Positions are 0..S-1 for both queries and keys.
//
// One block per (bh, 64-row query tile). The TPU kernel's sequential key
// grid axis becomes a loop inside the block over 32-row key tiles, with
// the softmax state (m, l, acc) in registers. Key tiles wholly outside
// the causal/window band are skipped: on the TPU they contribute zero
// after the alpha rescale, so the result is the same function.
//
// Bound on the H100: at the prefill shape (BH=128, S=512, HD=128) the f32
// FLOPs (~8.6 GFLOP causal) dominate the bytes (~134 MB), so it is
// bound by operations on the CUDA cores. This first version stages Q, K,
// V and the probabilities in shared memory (rows padded to HD+1 floats
// so the strided thread layout reads distinct banks) and runs scalar
// FMAs; tensor cores (wgmma) are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BKV = 32, THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          int Sq, int Sk, int n_rep, int causal, int window, float cap, float scale) {
  constexpr int QS = HD + 1;  // padded row stride of Qs / Ks
  constexpr int DJ = HD / 16; // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x QS
  float* Ks = Qs + BQ * QS;      // BKV x QS
  float* Vs = Ks + BKV * QS;     // BKV x HD
  float* Ps = Vs + BKV * HD;     // BQ x (BKV + 1)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * Sq * HD;
  const float* kb = k + (size_t)(bh / n_rep) * Sk * HD;
  const float* vb = v + (size_t)(bh / n_rep) * Sk * HD;

  for (int idx = threadIdx.x; idx < BQ * HD / 4; idx += THREADS) {
    const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) val = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * HD + d);
    Qs[r * QS + d] = val.x; Qs[r * QS + d + 1] = val.y;
    Qs[r * QS + d + 2] = val.z; Qs[r * QS + d + 3] = val.w;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;  // exclusive
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BKV) * BKV;

  for (int k0 = k_begin; k0 < k_end; k0 += BKV) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed (and Qs stored)
    for (int idx = threadIdx.x; idx < BKV * HD / 4; idx += THREADS) {
      const int r = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * HD + d);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * HD + d);
      }
      Ks[r * QS + d] = kv.x; Ks[r * QS + d + 1] = kv.y;
      Ks[r * QS + d + 2] = kv.z; Ks[r * QS + d + 3] = kv.w;
      *reinterpret_cast<float4*>(Vs + r * HD + d) = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += a[i] * b[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        valid[j] = kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
        s[i][j] = valid[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[((size_t)bh * Sq + r) * HD + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int BH, int Sq, int Sk,
           int n_rep, int causal, int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1));
  static bool configured = false;  // once, before any graph capture of the launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  flash_fwd<HD><<<dim3((Sq + BQ - 1) / BQ, BH), THREADS, smem, stream>>>(
      q, k, v, o, Sq, Sk, n_rep, causal, window, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
                 int hd, int n_rep, int causal, int window, float cap, float scale,
                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>((const float*)q, (const float*)k, (const float*)v, (float*)o, BH, Sq, Sk,
                      n_rep, causal, window, cap, scale, s);
  if (hd == 128)
    return launch<128>((const float*)q, (const float*)k, (const float*)v, (float*)o, BH, Sq, Sk,
                       n_rep, causal, window, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
