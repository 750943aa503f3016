"""``out = λ·(b @ W_down) + (1−λ)·a`` — the fused adapter mix for float
taps, forward only.

Replaces the TPU kernel ``src/repro/kernels/adapter_fuse.py``
(``_kernel`` / ``adapter_fuse``), with the CUDA kernel
``csrc/adapter_fuse.cu``. ``b`` (T, d) and ``W_down`` (d, d_a) are f32
or bf16, ``a`` (T, d_a) f32 or bf16; the product is accumulated in f32
and the result is in JAX's promotion of ``b``'s and ``w_down``'s dtypes
(bf16 only where both are; a bf16 tap mixed into the f32 adapter gives
f32). Ragged T, d and d_a are masked in the kernel (no padding copies).
λ is a 0-d f32 tensor on the card, already clamped to [0, 1], read by
the kernel: a host read per period would stall the stream 24 times a
decode step.

What bounds it on the H100: on the serving path (``pac_decode_step``,
one call per period) T is the batch (1 at B = 1), d = 2048 and
d_a = 256: the call reads the 2.1 MB f32 ``W_down`` and little else, so
the bytes bound it (~0.63 µs at 3.35 TB/s). Its path for T <= 8 is one
launch of ``csrc/skinny.cuh``'s GEMV: 16-byte loads of W rows, the
contraction split over the blocks of a thread block cluster (the plan of
:mod:`~repro_torch.kernels.skinny`: 8 tiles of 32 columns x 8 ranks at
this shape) and summed in a fixed order through distributed shared memory,
where the λ-mix is applied (deterministic, no scratch); larger T takes
``cached_mix``'s ``mix_fwd`` loop on the bf16 tensor cores (an f32
operand split in three bf16 terms), its contraction cut into slices
summed in a fixed order too.

There is no gradient (the TPU kernel has none): inputs that require
grad are refused; training's mix is
:class:`~repro_torch.kernels.cached_mix.MixFn`. On CPU and meta tensors
(``_build.plain_path``) the wrapper computes
:func:`~repro_torch.kernels.ref.adapter_fuse_ref`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import adapter_fuse_ref
from repro_torch.kernels.skinny import SKINNY_ROWS, plan_for

_FLOATS = (torch.float32, torch.bfloat16)

#: launches of the CUDA kernel in this process (the CPU path does not count)
launches = 0


def _lib():
    lib = _build.library("adapter_fuse")
    if lib.adapter_fuse_launch.argtypes is None:
        lib.adapter_fuse_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                            + [ctypes.c_void_p])
        lib.adapter_fuse_launch.restype = ctypes.c_int
        lib.adapter_fuse_partials.argtypes = [ctypes.c_int] * 3
        lib.adapter_fuse_partials.restype = ctypes.c_int
    return lib


def adapter_fuse(b: torch.Tensor, w_down: torch.Tensor, a: torch.Tensor, lam) -> torch.Tensor:
    """``λ·(b @ w_down) + (1−λ)·a`` -> (T, d_a) in the promotion of
    ``b``'s and ``w_down``'s dtypes, as JAX gives ``b @ w_down``.

    b: (T, d); w_down: (d, d_a); a: (T, d_a); λ: a scalar in [0, 1] — on
    the card a 0-d (or one-element) f32 tensor on ``b``'s device."""
    global launches
    require(b.ndim == 2 and w_down.ndim == 2 and a.ndim == 2, "b, w_down, a must be 2-D")
    T, d = b.shape
    da = w_down.shape[1]
    require(w_down.shape[0] == d and d > 0, f"w_down {tuple(w_down.shape)} does not take b "
                                            f"{tuple(b.shape)}")
    require(a.shape == (T, da), f"a {tuple(a.shape)} does not match ({T}, {da})")
    require(b.dtype in _FLOATS and w_down.dtype in _FLOATS and a.dtype in _FLOATS,
            f"b, w_down, a must be f32 or bf16, got {b.dtype}, {w_down.dtype}, {a.dtype}")
    require(b.device == w_down.device == a.device, "b, w_down, a on different devices")
    grads = [t for t in (b, w_down, a, lam) if isinstance(t, torch.Tensor) and t.requires_grad]
    require(not grads, "adapter_fuse has no gradient (nor has the TPU kernel); "
                       "train through cached_mix.MixFn")
    if _build.plain_path(b):
        return _build.run_plain("adapter_fuse", adapter_fuse_ref, b, w_down, a, lam)
    require(b.device.type == "cuda", f"unsupported device {b.device}")
    require(isinstance(lam, torch.Tensor) and lam.numel() == 1 and lam.dtype == torch.float32
            and lam.device == b.device, "λ must be a one-element f32 tensor on b's device")
    require(b.is_contiguous() and w_down.is_contiguous() and a.is_contiguous(),
            "b, w_down, a must be contiguous")
    out = torch.empty((T, da), dtype=torch.promote_types(b.dtype, w_down.dtype), device=b.device)
    if T == 0 or da == 0:
        return out
    lib = _lib()
    ranks = cols = 0
    partial = out
    if T <= SKINNY_ROWS:
        _, _, ranks, cols = plan_for(b, T, d, da, 8 * w_down.element_size())
    else:  # the tiled path's contraction slices, summed in order
        splits = lib.adapter_fuse_partials(T, d, da)
        if splits:
            partial = torch.empty((splits, T, da), dtype=torch.float32, device=b.device)
    rc = lib.adapter_fuse_launch(
        b.data_ptr(), w_down.data_ptr(), a.data_ptr(), lam.data_ptr(), out.data_ptr(),
        partial.data_ptr(), T, d, da, int(b.dtype == torch.bfloat16),
        int(w_down.dtype == torch.bfloat16), int(a.dtype == torch.bfloat16), ranks, cols,
        _build.stream_of(b))
    _build.check(lib, rc, "adapter_fuse")
    launches += 1
    return out
