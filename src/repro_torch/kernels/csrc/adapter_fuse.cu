// out = λ·(b @ W_down) + (1−λ)·a — the fused adapter mix for float taps,
// forward only, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/adapter_fuse.py (_kernel /
// adapter_fuse). b (T, d) f32 or bf16; W_down (d, da) f32 or bf16; a
// (T, da) f32 or bf16; out (T, da) bf16 where b and W both are, else f32
// (JAX's promotion of b @ W: a bf16 tap mixed into the f32 adapter gives
// f32); all row-major. The
// product is accumulated in f32 and the mix is applied in f32 before the
// one rounding to out's type. λ is a 0-d f32 device tensor, already
// clamped to [0, 1], read here (a host read would stall the stream once
// per period). T, d and da are ragged and masked here: no padding copies.
//
// What bounds it on the H100: on the serving path (pac_decode_step, one
// call per period of a decode step) T is the batch, 1 to 8, with d = 2048
// and da = 256. The call then reads W_down (2.1 MB in f32) once and does
// almost no arithmetic: the bytes bound it (~0.63 µs at 3.35 TB/s), and
// in practice the launch latency. At the training width (T = 2048) the
// tensor cores' operations bound it: 6 bf16 products of 2·T·d·da for f32
// taps and W (13 µs at 989 TFLOP/s; 32 µs in f32 on the CUDA cores), one
// for bf16 (2.2 µs, under the 3.4 µs its bytes take).
//
// Two paths, chosen by T:
//  * skinny (T <= 8): skinny.cuh's GEMV, one launch: column tiles x
//    contraction slices, the slices of a tile one thread block cluster;
//    16-byte loads of W rows (4 f32 or 8 bf16 columns a lane), several rows
//    a lane in flight, f32 FMAs on the CUDA cores, warps then blocks summed
//    in a fixed order through distributed shared memory, and the λ-mix
//    applied by the rank that sums each output. At d = 2048, d_a = 256 the
//    plan (../skinny.py) is 8 tiles of 32 columns x 8 ranks: 64 blocks
//    (5.0–5.3 µs a call on an H100 at 700 W against torch.addmm's
//    5.1–5.9 in the same calls; PERF.md).
//  * tiled (T > 8): mix_tile.cuh's tensor-core loop (mixfwd::launch), the
//    one cached_mix.cu's mix_fwd runs, without its residual: b as the
//    entry (f32 split in three bf16 terms, bf16 whole), W split in three
//    when f32 and whole when bf16, so 6 products per k16 step for f32 b
//    and W, 3 for one bf16 operand, 1 for both bf16. 128 x 64 output
//    tiles with the contraction cut into slices (4 at T = 2048, d = 2048,
//    da = 256; 8 at T = 100, d = 1000, da = 200), summed in slice order
//    by mixfwd's reduce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_tile.cuh"
#include "skinny.cuh"

namespace {

template <typename TB, typename TW, typename TO>
int launch(int a_bf16, const void* b, const void* w, const void* a, const void* lam, void* out,
           void* partial, int T, int d, int da, int ranks, int cols, cudaStream_t s) {
  if (T <= skinny::MAX_ROWS) {
    constexpr int KIND = sizeof(TW) == 4 ? skinny::F32 : skinny::BF16;
    return skinny::launch<KIND>((const TB*)b, w, nullptr,
                                skinny::Mix<TO>{a, a_bf16, (const float*)lam, (TO*)out}, T, d,
                                da, ranks, cols, s);
  }
  // tiled: b is the loop's entry, its own width d
  constexpr int KIND = sizeof(TB) == 4 ? mix_tile::F32 : mix_tile::BF16;
  if (a_bf16)
    return mixfwd::launch<KIND, TW, __nv_bfloat16, TO>(
        b, nullptr, (const TW*)w, (const __nv_bfloat16*)a, (const float*)lam, (TO*)out, nullptr,
        (float*)partial, T, d, d, da, 0, s);
  return mixfwd::launch<KIND, TW, float, TO>(b, nullptr, (const TW*)w, (const float*)a,
                                             (const float*)lam, (TO*)out, nullptr,
                                             (float*)partial, T, d, d, da, 0, s);
}

}  // namespace

extern "C" {

// (T, da) f32 partials one call of the tiled path (T > 8) sums, when its
// contraction is cut into more than one slice; 0: none
int adapter_fuse_partials(int T, int d, int da) {
  if (T <= skinny::MAX_ROWS) return 0;
  const int S = mixfwd::slices(T, d, da);
  return S > 1 ? S : 0;
}

// partial: (adapter_fuse_partials(T, d, da), T, da) f32 scratch when that is > 0, else unused.
// *_bf16: that operand is bf16, else f32; out is bf16 where b and W both are, else f32.
// ranks, cols: the skinny path's plan (T <= 8; ../skinny.py), else unused.
int adapter_fuse_launch(const void* b, const void* w, const void* a, const void* lam, void* out,
                        void* partial, int T, int d, int da, int b_bf16, int w_bf16, int a_bf16,
                        int ranks, int cols, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (T <= 0 || d <= 0 || da <= 0) return (int)cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  switch ((b_bf16 ? 2 : 0) + (w_bf16 ? 1 : 0)) {
    case 0:
      return launch<float, float, float>(a_bf16, b, w, a, lam, out, partial, T, d, da, ranks,
                                         cols, s);
    case 1:
      return launch<float, BF, float>(a_bf16, b, w, a, lam, out, partial, T, d, da, ranks, cols,
                                      s);
    case 2:
      return launch<BF, float, float>(a_bf16, b, w, a, lam, out, partial, T, d, da, ranks, cols,
                                      s);
    default:
      return launch<BF, BF, BF>(a_bf16, b, w, a, lam, out, partial, T, d, da, ranks, cols, s);
  }
}

const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
