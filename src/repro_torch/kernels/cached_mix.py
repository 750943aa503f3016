"""The cached-epoch adapter mix: ``out = λ·(dequant(b) @ W_down) + (1−λ)·a``
and its weight gradient ``dW_down = λ·dequant(b)[:, :d]ᵀ @ g``.

Replaces the TPU kernels ``src/repro/kernels/cached_step.py``
``_mix_fwd_kernel`` (``_mix_fwd_impl``) and ``_mix_dw_kernel``
(``_mix_dw_impl``), with the CUDA kernels ``csrc/cached_mix.cu``
(``mix_fwd``, ``mix_dw``). ``b`` is an activation-cache entry in its
storage form: an f32 or bf16 tensor, or an int8
:class:`~repro_torch.core.quantization.QTensor` (one f32 scale per block
of the last axis). The kernels dequantize it tile by tile on chip, so
the tap crosses device memory at its storage width and never as f32.

Both kernels run on the bf16 tensor cores (``mma.sync`` with f32
accumulators). An f32 operand is split into three bf16 terms (hi, mid,
lo) as it is staged, so the product keeps ~24 significant bits; int8
codes and bf16 entries are exact in bf16 and go to the MMA whole, so an
f32 entry costs 6 products per step and the others 3. At the training
shape of internlm2-1.8b (T = 2048 tokens, d = 2048, d_a = 256) each is
~6.4 GFLOP of bf16 work on ~8–12 MB, so the tensor cores' operations
bound it (~6.5 µs; the same product in f32 on the CUDA cores, ~32 µs).

``mix_fwd`` (``csrc/mix_tile.cuh``'s loop, shared with
``adapter_fuse``'s tiled path) splits ``W_down``. The int8 scale changes
along its contraction, so each 16-deep step's sum is multiplied by its
token's scale as it is added up; the contraction is cut into slices
summed in a fixed order. Held to the reference's forward tolerance,
``|Δ| ≤ 1e-4 + 1e-4·|want|`` for ``out`` and ``bw``
(tests/test_cached_step.py:53-56);
``tests/test_torch_kernels.py::test_mix_fwd_bf16_split_error_model``
emulates the split on the CPU. ``mix_dw`` splits ``g``, an int8 entry's
per-token scale folded into it, and cuts the tokens into slices. A
2-term split would miss its stated tolerance, ``|Δ| ≤ 2e-4 + 1e-3·|dW|``
against :func:`~repro_torch.kernels.ref.mix_dw_ref` (the reference's
custom-VJP tolerance, tests/test_cached_step.py:84);
``tests/test_torch_kernels.py::test_mix_dw_bf16_split_error_model``
holds the split's arithmetic to it on the CPU. Neither uses atomics:
two calls give bit-equal results. The kernels' times on the card are
in PERF.md.

:class:`MixFn` is the counterpart of the reference's custom VJP
``_mix_op``: the forward saves the f32 residual ``bw`` (T, d_a), never
the dequantized tap; the backward returns ``dW`` from ``mix_dw``,
``da = (1−λ)·g`` and ``dλ = Σ g·(bw − a)``, and no gradient for the
frozen entry.

On CPU and meta tensors (``_build.plain_path``) the wrappers compute the
plain versions (:func:`~repro_torch.kernels.ref.mix_fwd_ref`,
:func:`~repro_torch.kernels.ref.mix_dw_ref`); on CUDA tensors they launch
the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import mix_dw_ref, mix_fwd_ref

#: launches of each CUDA kernel in this process (the CPU path does not count)
launches = {"mix_fwd": 0, "mix_dw": 0}

_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lib():
    lib = _build.library("cached_mix")
    if lib.mix_fwd_launch.argtypes is None:
        lib.mix_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.mix_fwd_launch.restype = ctypes.c_int
        lib.mix_fwd_slices.argtypes = [ctypes.c_int] * 3
        lib.mix_fwd_slices.restype = ctypes.c_int
        lib.mix_dw_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.mix_dw_launch.restype = ctypes.c_int
        lib.mix_dw_slices.argtypes = [ctypes.c_int] * 3
        lib.mix_dw_slices.restype = ctypes.c_int
    return lib


def _entry(b):
    """(payload, scale or None, quantization block) of a 2-D entry."""
    if isinstance(b, QTensor):
        require(b.bits == 8, f"int8 entries only, got int{b.bits}")
        require(b.q.ndim == 2 and b.scale.shape == (b.q.shape[0], b.q.shape[1] // b.block),
                f"entry {b} is not (T, d_pad) with one scale per block")
        require(b.scale.dtype == torch.float32, "entry scales must be float32")
        return b.q, b.scale, b.block
    require(isinstance(b, torch.Tensor) and b.ndim == 2, "entry must be a 2-D tensor or QTensor")
    require(b.dtype in (torch.float32, torch.bfloat16), f"float entries are f32 or bf16, got {b.dtype}")
    return b, None, 1


def _lam_on(lam, device) -> torch.Tensor:
    lam = torch.as_tensor(lam, dtype=torch.float32, device=device)
    require(lam.numel() == 1, "λ must be a scalar")
    return lam


def _check_cuda(payload, scale, *tensors) -> None:
    for t in (payload, scale, *tensors):
        if t is None:
            continue
        require(t.device.type == "cuda", f"unsupported device {t.device}")
        require(t.is_contiguous(), "entry, weights and activations must be contiguous")


def mix_fwd(b, w_down: torch.Tensor, a: torch.Tensor, lam):
    """(out in ``a``'s dtype, bw f32), both (T, d_a). b: (T, d_store)
    entry; w_down (d, d_a) with d <= d_store; a (T, d_a); λ a scalar."""
    payload, scale, qblock = _entry(b)
    T, ld = payload.shape
    d, da = w_down.shape
    require(d <= ld, f"W_down has {d} rows, the entry only {ld} columns")
    require(a.shape == (T, da), f"a {tuple(a.shape)} does not match ({T}, {da})")
    require(a.dtype in (torch.float32, torch.bfloat16), f"a must be f32 or bf16, got {a.dtype}")
    require(payload.device == w_down.device == a.device, "entry, W_down, a on different devices")
    if _build.plain_path(payload):
        return _build.run_plain("mix_fwd", mix_fwd_ref, b, w_down, a, lam)
    require(w_down.dtype == torch.float32, "W_down must be float32")
    lam = _lam_on(lam, a.device)
    _check_cuda(payload, scale, w_down, a, lam)
    out = torch.empty_like(a)
    bw = torch.empty((T, da), dtype=torch.float32, device=a.device)
    if T == 0 or da == 0:
        return out, bw
    lib = _lib()
    slices = lib.mix_fwd_slices(T, d, da)  # the contraction's slices, summed in order
    partial = bw if slices == 1 else torch.empty((slices, T, da), dtype=torch.float32,
                                                 device=a.device)
    rc = lib.mix_fwd_launch(payload.data_ptr(), 0 if scale is None else scale.data_ptr(),
                            w_down.data_ptr(), a.data_ptr(), lam.data_ptr(), out.data_ptr(),
                            bw.data_ptr(), partial.data_ptr(), T, ld, d, da, qblock,
                            _STORAGE[payload.dtype], int(a.dtype == torch.bfloat16),
                            _build.stream_of(a))
    _build.check(lib, rc, "mix_fwd")
    launches["mix_fwd"] += 1
    return out, bw


def mix_dw(b, g: torch.Tensor, lam, d: int) -> torch.Tensor:
    """``λ · dequant(b)[:, :d]ᵀ @ g`` -> (d, d_a) f32. b: (T, d_store)
    entry with d <= d_store; g (T, d_a)."""
    payload, scale, qblock = _entry(b)
    T, ld = payload.shape
    require(0 < d <= ld, f"d={d} outside the entry's {ld} columns")
    require(g.ndim == 2 and g.shape[0] == T, f"g {tuple(g.shape)} does not have {T} rows")
    require(payload.device == g.device, "entry and g on different devices")
    if _build.plain_path(payload):
        return _build.run_plain("mix_dw", mix_dw_ref, b, g, lam, d)
    g = g.float().contiguous()
    lam = _lam_on(lam, g.device)
    _check_cuda(payload, scale, g, lam)
    lib = _lib()
    da = g.shape[1]
    dw = torch.empty((d, da), dtype=torch.float32, device=g.device)
    slices = lib.mix_dw_slices(T, d, da)  # the token slices' partial dW, summed in order
    partial = dw if slices == 1 else torch.empty((slices, d, da), dtype=torch.float32,
                                                 device=g.device)
    rc = lib.mix_dw_launch(payload.data_ptr(), 0 if scale is None else scale.data_ptr(),
                           g.data_ptr(), lam.data_ptr(), dw.data_ptr(), partial.data_ptr(), T,
                           ld, d, da, qblock, _STORAGE[payload.dtype], _build.stream_of(g))
    _build.check(lib, rc, "mix_dw")
    launches["mix_dw"] += 1
    return dw


class MixFn(torch.autograd.Function):
    """Differentiable in (W_down, a, λ); the entry is a frozen activation."""

    @staticmethod
    def forward(ctx, b, w_down, a, lam):
        out, bw = mix_fwd(b, w_down, a, lam)
        ctx.entry = b
        ctx.save_for_backward(w_down, a, lam, bw)
        return out

    @staticmethod
    def backward(ctx, g):
        w_down, a, lam, bw = ctx.saved_tensors
        dw = da = dlam = None
        if ctx.needs_input_grad[1]:
            dw = mix_dw(ctx.entry, g, lam, w_down.shape[0]).to(w_down.dtype)
        g32, lam32 = g.float(), lam.float()
        if ctx.needs_input_grad[2]:
            da = ((1.0 - lam32) * g32).to(a.dtype)
        if ctx.needs_input_grad[3]:
            dlam = torch.sum(g32 * (bw - a.float())).to(lam.dtype).reshape(lam.shape)
        return None, dw, da, dlam
