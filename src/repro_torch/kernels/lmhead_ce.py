"""Blockwise cross-entropy over the frozen LM head: per-token NLL and
log-sum-exp of ``softmax(softcap(h @ W))``, and ``dh``.

Replaces the TPU kernels ``src/repro/kernels/cached_step.py``
``_ce_fwd_kernel`` (``_ce_fwd_impl``) and ``_ce_bwd_kernel``
(``_ce_bwd_impl``), with the CUDA kernels ``csrc/lmhead_ce.cu``, on two
loops chosen by W's type:

* f32 W (``tile_mma``): h and W split once per call in three bf16 terms
  each (a bf16 h goes whole: one plane), W one vocab chunk at a time, one
  128 x 128 tile per block on ``mma.sync``. ``ce_fwd``: the logits tile
  with an online softmax in its epilogue, the partials of the vocab tiles
  merged in a second pass. ``ce_bwd``: per chunk, the logits tiles
  recomputed bit for bit and turned into the softmax gradient ``P``,
  stored as three bf16 planes, then ``dh += P @ Wᵀ`` on the same W
  planes.
* bf16 W, a bf16 backbone's head (Hopper's asynchronous loop,
  ``csrc/wgmma_loop.cuh``): W goes whole, read by TMA where it lies
  (:func:`w_in_place`; else from one padded copy), into a ring of
  shared-memory stages that a producer warpgroup fills and two consumer
  warpgroups multiply with ``wgmma``; h's three terms (3 products). The
  forward is one launch over all of V (128 x 256 tiles), the backward the
  same chunks of ``P`` as above (128 x 128 logits tiles, 128 x 256 ``dh``
  tiles).

The (T, V) logits never reach device memory; the scratch is h's split
planes, W's chunk planes on ``tile_mma`` (none on the wgmma loop unless W
needs the padded copy), and in the backward one P chunk's
(:func:`ce_fwd_scratch`, :func:`ce_bwd_scratch`).

What bounds them on the H100: at the training shape of internlm2-1.8b
(T = 2048, d = 2048, V = 92544) the forward is 6 bf16 products of ~0.78
TFLOP each with an f32 W (≈4.7 ms at 989 TFLOP/s), 3 with a bf16 W
(≈2.4 ms), and the backward twice that, against ~0.77 GB (f32) or 0.38
GB (bf16) of head weights: operations bound both. Any d and V are taken
(ragged edges are padded with zero terms, read as zeros by TMA, or
masked).

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
        lib.ce_tile.argtypes = [ctypes.c_int] * 2
        lib.ce_tile.restype = ctypes.c_int
        lib.ce_wgmma.argtypes = [ctypes.c_int]
        lib.ce_wgmma.restype = ctypes.c_int
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


def w_in_place(V: int, ptr: int) -> bool:
    """Whether the wgmma loop's TMA reads a bf16 W (d, V) where it lies:
    every row 16-byte aligned (V a multiple of 8, the base at a multiple
    of 16 bytes). Otherwise the kernel reads one padded copy (d, Vp), Vp
    = V rounded up to 8, that it writes into the W scratch."""
    return V % 8 == 0 and ptr % 16 == 0


def _w_copy(d: int, V: int, in_place: bool) -> int:
    """bf16 values of the wgmma loop's W scratch: none where TMA reads W
    in place, else the padded copy's d·Vp."""
    return 0 if in_place else d * (-(-V // 8) * 8)


def route(h_bf16: bool, w_bf16: bool, in_place: bool, wgmma: bool) -> dict:
    """The kernels ``ce_fwd`` and ``ce_bwd`` launch on the card, in order,
    for these operands (a bf16 h, a bf16 W, W :func:`w_in_place`) and the
    library's loop for a bf16 W (``wgmma``: the library's ``ce_wgmma``)."""
    h_pass = "ce_pad (h)" if h_bf16 else "ce_split (h)"
    ta, tb = (1 if h_bf16 else 3), (1 if w_bf16 else 3)
    if not (w_bf16 and wgmma):
        w_pass = "ce_pad (W chunk)" if w_bf16 else "ce_split (W chunk)"
        return {"ce_fwd": [h_pass, w_pass, f"ce_fwd_mma<{ta}, {tb}>", "ce_merge"],
                "ce_bwd": [h_pass, w_pass, f"ce_grad_mma<{ta}, {tb}>", f"ce_dh_mma<{tb}>"]}
    w_pass = [] if in_place else ["ce_pad (W, padded copy)"]
    return {"ce_fwd": [h_pass, *w_pass, f"ce_fwd_wg<{ta}, 2>", "ce_merge"],
            "ce_bwd": [h_pass, *w_pass, f"ce_grad_wg<{ta}, 1>", "ce_dh_wg<2>"]}


def route_of(h: torch.Tensor, w: torch.Tensor) -> dict:
    """:func:`route` for these tensors on the card (builds the library)."""
    wgmma = bool(_lib().ce_wgmma(int(terms(w) == 1)))
    return route(terms(h) == 1, terms(w) == 1, w_in_place(w.shape[1], w.data_ptr()), wgmma)


def ce_fwd_scratch(T: int, d: int, V: int, bm: int, bn: int, bk: int, sms: int,
                   h_terms: int = 3, w_terms: int = 3, wgmma: bool = False,
                   in_place: bool = True) -> Tuple[int, ...]:
    """The forward's W chunk, in vocab tiles, and the bf16 values of its
    two scratches: h's planes (h_terms, Tp, dp), Tp and dp being T and d in
    whole ``bm`` and ``bk`` tiles; on ``tile_mma`` one W chunk's planes
    (w_terms, dp, chunk·bn), on the wgmma loop (a bf16 W, one launch, W
    read by TMA) no W scratch, or the padded copy where W is not
    :func:`w_in_place`."""
    t_tiles, v_tiles = -(-T // bm), -(-V // bn)
    tp, dp = t_tiles * bm, -(-d // bk) * bk
    chunk = fwd_chunk_tiles(t_tiles, v_tiles, bn, sms)
    n_w = _w_copy(d, V, in_place) if wgmma else w_terms * dp * chunk * bn
    return chunk, h_terms * tp * dp, n_w


def ce_bwd_scratch(T: int, d: int, V: int, bm: int, bn: int, sms: int, h_terms: int = 3,
                   w_terms: int = 3, bk: int = 64, wgmma: bool = False,
                   in_place: bool = True) -> Tuple[int, ...]:
    """The backward's W chunk, in vocab tiles (the forward's), and the bf16
    values of its three scratches: h's planes (h_terms, Tp, dp), one W
    chunk's (w_terms, dp, chunk·bn) and one P chunk's (3, Tp, chunk·bn),
    where Tp is T in whole token tiles (``bm``) and dp is d in whole
    ``dh`` tiles (``bn``); an operand's planes are :func:`terms`. On the
    wgmma loop (``wgmma``, a bf16 W) dp is d in whole ``bk`` steps (TMA
    reads W's rows past d as zeros) and the W scratch is the forward's."""
    t_tiles, v_tiles = -(-T // bm), -(-V // bn)
    tp, dp = t_tiles * bm, -(-d // (bk if wgmma else bn)) * (bk if wgmma else bn)
    chunk = fwd_chunk_tiles(t_tiles, v_tiles, bn, sms)
    n_w = _w_copy(d, V, in_place) if wgmma else w_terms * dp * chunk * bn
    return chunk, h_terms * tp * dp, n_w, 3 * tp * chunk * bn


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
    wgmma = lib.ce_wgmma(int(terms(w) == 1))
    bm, bn, bk = (lib.ce_tile(i, wgmma) for i in range(3))  # ce_fwd_wg's, or tile_mma's
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    chunk, *sizes = ce_fwd_scratch(T, d, V, bm, bn, bk, sms, terms(h), terms(w), bool(wgmma),
                                   w_in_place(V, w.data_ptr()))
    hs, ws = (torch.empty(n, dtype=torch.bfloat16, device=h.device) for n in sizes)
    part = torch.empty((3, T, -(-V // bn)), dtype=torch.float32, device=h.device)
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
    wgmma = lib.ce_wgmma(int(terms(w) == 1))
    bm, bn, bk = (lib.ce_tile(i, 2 * wgmma) for i in range(3))  # ce_grad_wg's, or tile_mma's
    chunk, *sizes = ce_bwd_scratch(T, d, V, bm, bn, sms, terms(h), terms(w), bk, bool(wgmma),
                                   w_in_place(V, w.data_ptr()))
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
