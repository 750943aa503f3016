"""``y = x @ dequant(Wq)`` — block-dequant INT8/INT4 matmul.

Replaces the TPU kernel ``src/repro/kernels/quant_matmul.py``
(``_kernel`` / ``quant_matmul``), with the CUDA kernel
``csrc/quant_matmul.cu``. Weights stay at storage width in device
memory and are dequantized tile by tile on chip.

What bounds it on the H100: the decode step (M = batch bucket <= 8) is
a GEMV bound by the weight bytes — about 1.56 GB of int8 weights plus
scales per decode step across the 24 layers of internlm2-1.8b, about
0.47 ms at 3.35 TB/s. Its kernel path is one launch of
``csrc/skinny.cuh``'s GEMV: it dequantizes as the reference does
(``float(q) * scale``, f32 accumulation), loads 16 codes a lane (fewer
at M > 4), splits K over the blocks of a thread block cluster (the plan
of :mod:`~repro_torch.kernels.skinny`) and sums the slices in a fixed
order through distributed shared memory (deterministic, no scratch).
Prefill and the epoch-1 training step (M > 8, up to 4096) are bound by
operations: one layer's seven projections at M = 4096 take at least
1.563 ms on the bf16 tensor cores (three products a weight, below) and
7.69 ms in f32 on the CUDA cores. Its kernel path runs on the bf16 tensor cores: the scale, which
changes at every k, is folded into x once per 128-column quantization
block (``a = f32(x * scale[:, nb])``), ``a`` is split in three bf16
terms as it is staged, the int8 or int4 codes go whole (exact in bf16),
and each 64 x 128 output tile is written once (reruns bit-equal). It
rounds ``x * scale`` where the reference rounds ``q * scale``; the three
terms keep that f32 value whole, and the result stays within the
reference's f32 tolerance (atol 1e-3 + rtol 1e-4).

On CPU and meta tensors (``_build.plain_path``) the wrapper computes
:func:`~repro_torch.kernels.ref.quant_matmul_ref`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import quant_matmul_ref
from repro_torch.kernels.skinny import SKINNY_ROWS, plan_for

QBLOCK = 128  # quantization block along N (matches core.quantization)

#: launches of the CUDA kernel in this process (the CPU path does not count)
launches = 0
#: the same launches by storage width and branch: "int8 skinny" (M <= 8, the
#: GEMV), "int4 tiled" (M > 8, ``qmm_mma``), ...
branch_launches: collections.Counter = collections.Counter()


def _fn():
    lib = _build.library("quant_matmul")
    fn = lib.qmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bits: int = 8
                 ) -> torch.Tensor:
    """``x @ dequant(q, scale)`` -> (M, N) f32.

    x: (M, K) f32; q: (K, N) int8 or (K, N//2) packed int4 nibbles;
    scale: (K, N // 128) f32 — the storage format of
    ``core.quantization.quantize(block=128)``. M and K need no padding.
    """
    global launches
    require(bits in (8, 4), f"bits must be 8 or 4, got {bits}")
    require(x.ndim == 2 and q.ndim == 2 and scale.ndim == 2, "x, q, scale must be 2-D")
    M, K = x.shape
    N = scale.shape[1] * QBLOCK
    require(q.shape == (K, N if bits == 8 else N // 2),
            f"q shape {tuple(q.shape)} does not match x {tuple(x.shape)} / scale "
            f"{tuple(scale.shape)} at int{bits}")
    require(scale.shape[0] == K, "scale must have one row per weight row")
    require(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    require(q.dtype == torch.int8 and scale.dtype == torch.float32, "q int8, scale float32")
    require(x.device == q.device == scale.device, "x, q, scale on different devices")
    if _build.plain_path(x):
        return _build.run_plain("quant_matmul", quant_matmul_ref, x, q, scale, bits)
    require(x.device.type == "cuda", f"unsupported device {x.device}")
    require(x.is_contiguous() and q.is_contiguous() and scale.is_contiguous(),
            "x, q, scale must be contiguous")
    require(q.data_ptr() % 4 == 0 and x.data_ptr() % 16 == 0, "misaligned x or q")
    lib, fn = _fn()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ranks = cols = 0
    if M <= SKINNY_ROWS:
        _, _, ranks, cols = plan_for(x, M, K, N, bits)
    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, bits, ranks,
            cols, _build.stream_of(x))
    _build.check(lib, rc, "quant_matmul")
    launches += 1
    branch_launches[f"int{bits} {'skinny' if M <= SKINNY_ROWS else 'tiled'}"] += 1
    return out
