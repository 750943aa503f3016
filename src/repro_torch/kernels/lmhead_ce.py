"""Blockwise cross-entropy over the frozen LM head: per-token NLL and
log-sum-exp of ``softmax(softcap(h @ W))``, and ``dh``.

Replaces the TPU kernels ``src/repro/kernels/cached_step.py``
``_ce_fwd_kernel`` (``_ce_fwd_impl``) and ``_ce_bwd_kernel``
(``_ce_bwd_impl``), with the CUDA kernels ``csrc/lmhead_ce.cu``. Both
split an f32 h and W once per call in three bf16 terms each (a bf16 h or
W, a bf16 backbone's head, goes whole: one plane, and the loop takes 3
products a k16 step instead of 6), W one vocab chunk at
a time, and run one 128 x 128 tile per block on the bf16 tensor cores
(one loop, shared). ``ce_fwd``: the logits tile with an online softmax in
its epilogue, the partials of the vocab tiles merged in a second pass.
``ce_bwd``: per chunk, the logits tiles recomputed bit for bit and turned
into the softmax gradient ``P``, stored as three bf16 planes, then
``dh += P @ Wᵀ`` on the same W planes. The (T, V) logits never reach
device memory; the scratch is the split planes of h and of one W chunk,
and in the backward one P chunk's (:func:`ce_bwd_scratch`).

What bounds them on the H100: at the training shape of internlm2-1.8b
(T = 2048, d = 2048, V = 92544) the forward is 6 bf16 products of ~0.78
TFLOP each (≈4.7 ms at 989 TFLOP/s) and the backward twice that (≈9.4
ms), against ~0.77 GB of head weights: operations bound both. Any d and
V are taken (ragged edges are padded with zero terms or masked).

:class:`CEFn` is the counterpart of the reference's custom VJP
``_ce_op``: it saves ``lse`` and its backward is ``ce_bwd``; the head is
frozen and the labels are integers, so neither gets a gradient.

On CPU and meta tensors (``_build.plain_path``) the wrappers compute the
plain versions (:func:`~repro_torch.kernels.ref.ce_fwd_ref`,
:func:`~repro_torch.kernels.ref.ce_bwd_ref`); on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import ce_bwd_ref, ce_fwd_ref

#: launches of each CUDA kernel in this process (the CPU path does not count)
launches = {"ce_fwd": 0, "ce_bwd": 0}

#: vocab columns the kernels split at a time, about (rounded to whole
#: waves of the card): W's three bf16 planes of one chunk, 3·d·FWD_CHUNK·2
#: bytes (0.1 GB at d = 2048), are scratch beside h's (25 MB at T = d = 2048)
FWD_CHUNK = 8192


def _lib():
    lib = _build.library("lmhead_ce")
    if lib.ce_fwd_launch.argtypes is None:
        lib.ce_fwd_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                                      + [ctypes.c_float] + [ctypes.c_int] * 2
                                      + [ctypes.c_void_p])
        lib.ce_fwd_launch.restype = ctypes.c_int
        lib.ce_bwd_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                      + [ctypes.c_float] + [ctypes.c_int] * 2
                                      + [ctypes.c_void_p])
        lib.ce_bwd_launch.restype = ctypes.c_int
        lib.ce_tile.argtypes = [ctypes.c_int]
        lib.ce_tile.restype = ctypes.c_int
    return lib


def _validate(h, w, labels, softcap) -> None:
    require(h.ndim == 2 and w.ndim == 2 and h.shape[1] == w.shape[0],
            f"h {tuple(h.shape)} and W {tuple(w.shape)} do not chain")
    require(labels.shape == (h.shape[0],), f"labels {tuple(labels.shape)} must be ({h.shape[0]},)")
    require(softcap is None or softcap > 0, "softcap must be positive")
    require(h.device == w.device == labels.device, "h, W, labels on different devices")


def _check_cuda(h, w, *f32) -> None:
    """h and W f32 or bf16 (each on its own), lse and g f32; all on the
    card and contiguous."""
    for t in (h, w) + f32:
        require(t.device.type == "cuda", f"unsupported device {t.device}")
        require(t.is_contiguous(), "h, W, lse, g must be contiguous")
    for t in (h, w):
        require(t.dtype in (torch.float32, torch.bfloat16),
                f"h and W must be float32 or bfloat16, got {t.dtype}")
    for t in f32:
        require(t.dtype == torch.float32, f"lse and g must be float32, got {t.dtype}")


def terms(t: torch.Tensor) -> int:
    """bf16 planes an operand takes on the tensor cores: three terms of an
    f32 value, a bf16 value whole."""
    return 1 if t.dtype == torch.bfloat16 else 3


def fwd_chunk_tiles(t_tiles: int, v_tiles: int, bn: int, sms: int) -> int:
    """Vocab tiles per W chunk of both kernels: about ``FWD_CHUNK`` columns,
    rounded so that the chunk's blocks (one per SM, ``t_tiles`` token tiles
    by the chunk's vocab tiles) fill whole waves of the card, and at most
    twice ``FWD_CHUNK``."""
    waves = max(1, round(FWD_CHUNK / bn * t_tiles / sms))
    return max(1, min(v_tiles, 2 * FWD_CHUNK // bn, waves * sms // t_tiles))


def ce_bwd_scratch(T: int, d: int, V: int, bm: int, bn: int, sms: int, h_terms: int = 3,
                   w_terms: int = 3) -> Tuple[int, ...]:
    """The backward's W chunk, in vocab tiles (the forward's), and the bf16
    values of its three scratches: h's planes (h_terms, Tp, dp), one W
    chunk's (w_terms, dp, chunk·bn) and one P chunk's (3, Tp, chunk·bn),
    where Tp is T in whole token tiles (``bm``) and dp is d in whole
    ``dh`` tiles (``bn``); an operand's planes are :func:`terms`."""
    t_tiles, v_tiles = -(-T // bm), -(-V // bn)
    tp, dp = t_tiles * bm, -(-d // bn) * bn
    chunk = fwd_chunk_tiles(t_tiles, v_tiles, bn, sms)
    return chunk, h_terms * tp * dp, w_terms * dp * chunk * bn, 3 * tp * chunk * bn


def ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           softcap: Optional[float] = None):
    """(nll, lse), each (T,) f32. h (T, d); W (d, V), each f32 or bf16 (a
    bf16 operand goes to the tensor cores whole); labels (T,) in [0, V)."""
    _validate(h, w, labels, softcap)
    if _build.plain_path(h):
        return _build.run_plain("ce_fwd", ce_fwd_ref, h, w, labels, softcap)
    _check_cuda(h, w)
    lib = _lib()
    T, d = h.shape
    V = w.shape[1]
    labels = labels.to(torch.int32).contiguous()
    bm, bn, bk = (lib.ce_tile(i) for i in range(3))
    t_tiles, v_tiles = -(-T // bm), -(-V // bn)
    dp = -(-d // bk) * bk
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    chunk = fwd_chunk_tiles(t_tiles, v_tiles, bn, sms)
    hs = torch.empty(terms(h) * t_tiles * bm * dp, dtype=torch.bfloat16, device=h.device)
    ws = torch.empty(terms(w) * dp * chunk * bn, dtype=torch.bfloat16, device=h.device)
    part = torch.empty((3, T, v_tiles), dtype=torch.float32, device=h.device)
    nll = torch.empty(T, dtype=torch.float32, device=h.device)
    lse = torch.empty(T, dtype=torch.float32, device=h.device)
    rc = lib.ce_fwd_launch(h.data_ptr(), w.data_ptr(), labels.data_ptr(), hs.data_ptr(),
                           ws.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                           part[2].data_ptr(), nll.data_ptr(), lse.data_ptr(), T, d, V, chunk,
                           softcap or 0.0, int(terms(h) == 1), int(terms(w) == 1),
                           _build.stream_of(h))
    _build.check(lib, rc, "ce_fwd")
    launches["ce_fwd"] += 1
    return nll, lse


def ce_bwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
           g: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    """``dh = g · ((softmax − onehot)·(1 − tanh²)) @ Wᵀ`` -> (T, d) in
    ``h``'s dtype (the reference's: summed in f32, rounded once); h and W
    each f32 or bf16, lse and g (T,) f32."""
    _validate(h, w, labels, softcap)
    require(lse.shape == g.shape == (h.shape[0],), "lse and g must be (T,)")
    if _build.plain_path(h):
        return _build.run_plain("ce_bwd", ce_bwd_ref, h, w, labels, lse, g, softcap)
    g = g.float().contiguous()
    _check_cuda(h, w, lse, g)
    lib = _lib()
    T, d = h.shape
    V = w.shape[1]
    labels = labels.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    chunk, *sizes = ce_bwd_scratch(T, d, V, lib.ce_tile(0), lib.ce_tile(1), sms, terms(h),
                                   terms(w))
    hs, ws, ps = (torch.empty(n, dtype=torch.bfloat16, device=h.device) for n in sizes)
    dh = torch.empty((T, d), dtype=torch.float32, device=h.device)
    rc = lib.ce_bwd_launch(h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                           g.data_ptr(), hs.data_ptr(), ws.data_ptr(), ps.data_ptr(),
                           dh.data_ptr(), T, d, V, chunk, softcap or 0.0, int(terms(h) == 1),
                           int(terms(w) == 1), _build.stream_of(h))
    _build.check(lib, rc, "ce_bwd")
    launches["ce_bwd"] += 1
    return dh if h.dtype == torch.float32 else dh.to(h.dtype)


class CEFn(torch.autograd.Function):
    """Differentiable in h only (the head is frozen in PAC+)."""

    @staticmethod
    def forward(ctx, h, w, labels, softcap):
        nll, lse = ce_fwd(h, w, labels, softcap)
        ctx.softcap = softcap
        ctx.save_for_backward(h, w, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        return ce_bwd(h, w, labels, lse, g, ctx.softcap), None, None, None
