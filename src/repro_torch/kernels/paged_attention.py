"""Paged-KV decode attention (the serving engine's core).

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``_kernel`` / ``_paged_attention_call``, public ``paged_attention``),
with the CUDA kernel ``csrc/paged_attention.cu``: one decode step of
grouped-GQA attention over each request's pages up to ``lengths[b]``,
INT8 pages dequantized with per-(token, kv-head) scales, optional
sliding ``window`` and tanh ``attn_softcap``, f32/bf16/int8 pages, page
0 the null page.

What bounds it on the H100: bytes — each attended K/V row is read once
(int8: 2·(hd + 4) bytes per token and kv head) for 4·n_rep·hd FLOPs. The
kernel runs one block per (request, kv head); the block reads its own
block-table row and length (the card has no scalar prefetch), walks
only the attended positions, dequantizes in registers and merges its
warps' online-softmax states at the end. A padding row (length 0, null
page) attends one finite slot, so its output is finite. Limits on the
card: hd in (64, 128), n_rep <= 8; page size and kv-head count are free.

On CPU tensors the wrapper computes
:func:`~repro_torch.kernels.ref.paged_attention_ref`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import paged_attention_ref

#: launches of the CUDA kernel in this process (the CPU path does not count)
launches = 0

HEAD_DIMS = (64, 128)
_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _fn():
    lib = _build.library("paged_attention")
    fn = lib.paged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_max_rep.argtypes = []
        lib.paged_max_rep.restype = ctypes.c_int
    return lib, fn


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention -> (B, Hkv, n_rep, hd) f32.

    q: (B, Hkv, n_rep, hd) f32 post-rope new-token query; k/v_pages:
    (n_pages, page, Hkv, hd) — int8 with ``k_scale``/``v_scale``
    (n_pages, page, Hkv) f32, or plain f32/bf16; block_tables:
    (B, max_pages) int32 (page 0 is the null page); lengths: (B,) int32,
    the index the new token was written at (``kpos <= lengths[b]``).
    """
    global launches
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    require(q.ndim == 4, "q must be (B, Hkv, n_rep, hd)")
    B, hkv, n_rep, hd = q.shape
    require(k_pages.ndim == 4 and k_pages.shape == v_pages.shape
            and k_pages.shape[2:] == (hkv, hd),
            f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    require(block_tables.ndim == 2 and block_tables.shape[0] == B and lengths.shape == (B,),
            "block_tables must be (B, max_pages) and lengths (B,)")
    quantized = k_scale is not None
    if quantized:
        require(k_pages.dtype == torch.int8, "scaled pages must be int8")
        require(k_scale.shape == v_scale.shape == k_pages.shape[:3], "scale shape")
    else:
        require(k_pages.dtype in (torch.float32, torch.bfloat16),
                "unscaled pages must be float32 or bfloat16")
    require(window is None or window > 0, "window must be positive")
    require(attn_softcap is None or attn_softcap > 0, "attn_softcap must be positive")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   k_scale=k_scale, v_scale=v_scale, window=window,
                                   attn_softcap=attn_softcap)
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    tensors = [q, k_pages, v_pages, block_tables, lengths] + ([k_scale, v_scale] if quantized else [])
    require(all(t.device == q.device for t in tensors), "arguments on different devices")
    require(all(t.is_contiguous() for t in tensors), "arguments must be contiguous")
    require(q.dtype == torch.float32, "q must be float32")
    require(block_tables.dtype == torch.int32 and lengths.dtype == torch.int32,
            "block_tables and lengths must be int32")
    require(k_pages.dtype == v_pages.dtype, "k and v pages must share a dtype")
    require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    lib, fn = _fn()
    require(n_rep <= lib.paged_max_rep(), f"n_rep {n_rep} > {lib.paged_max_rep()}")
    out = torch.empty_like(q)
    ks = k_scale.data_ptr() if quantized else None
    vs = v_scale.data_ptr() if quantized else None
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, hkv, n_rep, hd, k_pages.shape[1], block_tables.shape[1], _KIND[k_pages.dtype],
            window or 0, attn_softcap or 0.0, hd ** -0.5, _build.stream_of(q))
    _build.check(lib, rc, "paged_attention")
    launches += 1
    return out
