"""Causal online-softmax ("flash") attention, forward.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_kernel`` / ``flash_attention_tpu``), with the CUDA kernel
``csrc/flash_attention.cu``: causal masking, optional sliding
``window`` and tanh ``attn_softcap``, f32 in and out, or bf16 in and out
(the bf16 backbone's branch, below).

What bounds it on the H100: at the prefill shape of internlm2-1.8b
(B·H = 8·16, S = 512, hd = 128) it does ~8.6 GFLOP of f32 work on ~101 MB,
so it is bound by operations. Both products run on the bf16 tensor cores
with every f32 operand (Q, K, V and the probabilities P) split in three
bf16 terms, six products each: K and V are split once per call into a
scratch this wrapper allocates, Q as it is staged, P in registers, where
the scores S stay from the softmax to the P·V product. Each block owns a
(head, 64-row query tile), loops over key tiles with the softmax state in
registers and skips key tiles outside the causal/window band. It reads
grouped GQA heads directly — query row ``bh`` uses kv row ``bh // n_rep``
— so the repeated-KV copy the TPU path built is never made. Padded
prompt positions lie past every real query, so the causal mask keeps
them out of real rows. A query row with no key in its band (only with a
``window`` and Sq > Sk: rows ``q >= Sk + window - 1``) gets the
reference's answer, V's mean over the Sk keys of its KV head: the
reference masks with a finite -1e30, so every p of such a row is 1. The
kernel leaves such rows at 0 and this wrapper overwrites them, only when
they exist (never at Sq = Sk, every path's shape). Tolerance: the
reference's atol 3e-5 (``tests/test_kernels.py:105``); ``chip_smoke.py`` holds the kernel to it
(max |Δ| 1.4e-6 at the prefill shape) and times it: 0.213–0.215 ms a call
at the prefill shape on an NVIDIA H100 80GB HBM3 at 700 W, against SDPA's
0.276–0.278 and the 0.052 ms tensor-core bound (``PERF.md``).

The bf16 branch (a bf16 backbone's q, k and v) runs at hd 128 on its own
kernel, ``flash_fwd_wg``, on Hopper's asynchronous loop
(``csrc/wgmma_loop.cuh``): TMA reads Q, K and V where they lie (no copy,
no scratch: :func:`scratch_elems` gives 0), into a ring of K and V tiles
that a producer warpgroup fills; two consumer warpgroups, 64 query rows
each, run Q·Kᵀ and P·V on ``wgmma``. The three are exact in bf16 and go
to the tensor cores whole, one plane each: Q·Kᵀ takes one product, P·V
three (P stays f32, split in three bf16 terms, the reference's f32 P).
The softmax and O stay in f32, and O is rounded to bf16 once, as the
reference casts O to q's dtype (``src/repro/models/layers.py:201``,
``flash_attention.py:101``). Its tolerance against its plain version on
the card is one bf16 rounding of O (``chip_smoke.py``'s
``BF16_OUT_TOL``). At hd 64, 112 and 256 (a bf16 gemma2-2b, kimi-k2, the
Table III models) the bf16 branch runs on the f32 loop's bf16
instantiation, ``flash_fwd_mma<hd, bf16>``, after ``flash_pad``'s padded
copy of K and V (one plane each: :func:`scratch_elems`): Q, K and V one
term each, P three, the softmax and O in f32, O rounded to bf16 once, the
same function at the same tolerance. :func:`route` names the kernels a
call at (dtype, hd) launches.

Head widths 64, 112 (kimi-k2), 128 and 256 (gemma2-2b); at 256 two warps
share each 16-row group, each accumulating half of O's columns; at 112
O's 14 column tiles a warp are summed 8 then 6 (the source's notes).

On CPU and meta tensors (``_build.plain_path``) the wrapper computes
:func:`~repro_torch.kernels.ref.flash_attention_ref`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import flash_attention_ref

#: launches of the CUDA kernel in this process (the CPU path does not count)
launches = 0

HEAD_DIMS = (64, 112, 128, 256)  # the head widths the kernel is instantiated for
BF16_HEAD_DIMS = HEAD_DIMS  # ... and its bf16 branch's: every one
WGMMA_HEAD_DIMS = (128,)  # the bf16 widths on the wgmma loop (the others on flash_fwd_mma)


def _fn():
    lib = _build.library("flash_attention")
    fn = lib.flash_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_wgmma.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_wgmma.restype = ctypes.c_int
        lib.flash_key_tile.argtypes = []
        lib.flash_key_tile.restype = ctypes.c_int
    return lib, fn


def on_wgmma(dtype, hd: int, wgmma: bool = True) -> bool:
    """Whether a call at ``dtype`` and head width ``hd`` runs on the wgmma
    loop: bf16 at hd 128 while the library routes it there (``wgmma``: its
    ``BF16_ON_WGMMA``); every other call on ``flash_fwd_mma``."""
    require_head_dim(hd, dtype)
    return wgmma and dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS


def route(dtype, hd: int, wgmma: bool = True) -> list:
    """The kernels one call at ``dtype`` and head width ``hd`` launches, in
    order: bf16 q, k, v at hd 128 on the wgmma loop (K and V read in place
    by TMA, nothing before it); bf16 at the other widths, or at 128 routed
    back (``wgmma`` false), on ``flash_fwd_mma`` after ``flash_pad``'s
    padded copy; f32 on ``flash_fwd_mma`` after ``flash_split``. Refuses a
    head width the kernel is not built for at ``dtype``."""
    if on_wgmma(dtype, hd, wgmma):
        return ["flash_fwd_wg"]
    if dtype == torch.bfloat16:
        return ["flash_pad", f"flash_fwd_mma<{hd}, bf16>"]
    return ["flash_split", f"flash_fwd_mma<{hd}>"]


def scratch_elems(BH: int, Sk: int, hd: int, n_rep: int, dtype, key_tile: int,
                  wgmma: bool = True) -> int:
    """bf16 values of the K/V scratch a call at (``dtype``, ``hd``) needs:
    none on the wgmma loop; on ``flash_fwd_mma`` K's and V's planes (three
    each of f32 operands, one each of bf16), (BH / n_rep) heads of Sk keys
    padded to whole tiles of ``key_tile`` (the library's
    ``flash_key_tile``)."""
    if on_wgmma(dtype, hd, wgmma):
        return 0
    terms = 1 if dtype == torch.bfloat16 else 3
    return 2 * terms * (BH // n_rep) * (-(-Sk // key_tile) * key_tile) * hd


def route_of(q: torch.Tensor) -> list:
    """:func:`route` for a call with ``q`` on the card (the built library
    says which loop bf16 takes at q's head width)."""
    lib, _ = _fn()
    return route(q.dtype, q.shape[-1],
                 bool(lib.flash_wgmma(int(q.dtype == torch.bfloat16), q.shape[-1])))


def require_head_dim(hd: int, dtype=torch.float32) -> None:
    """The head widths the kernel is built for, the same at either dtype:
    any other is refused on the card (the plain version on the CPU takes
    any)."""
    require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS} at {dtype}")


def _keyless_from(Sq: int, Sk: int, window: Optional[int]) -> int:
    """The first query row with no key in its band, or ``Sq``. Row q's
    band holds the keys k < Sk with q - k < window (and k <= q when
    causal): causal or not, it is empty once q - (Sk - 1) >= window."""
    if window is None:
        return Sq
    return min(Sq, Sk + window - 1)


def _fill_keyless(out: torch.Tensor, v: torch.Tensor, n_rep: int, window: Optional[int]
                  ) -> torch.Tensor:
    """Give ``out``'s rows with no key the reference's answer, in place:
    V's mean over the Sk keys of the KV head query head ``bh`` reads,
    ``bh // n_rep`` (the kernel leaves them at 0)."""
    first = _keyless_from(out.shape[1], v.shape[1], window)
    if first < out.shape[1]:
        out[:, first:] = v.mean(dim=1).repeat_interleave(n_rep, dim=0)[:, None, :]
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention -> (BH, Sq, hd) in q's dtype.

    q: (BH, Sq, hd); k, v: (BH / n_rep, Sk, hd) — ``n_rep = 1`` is the
    reference's repeated-KV layout, ``n_rep > 1`` reads grouped heads.
    All three f32, or all three bf16 (the bf16 branch: taken whole by the
    tensor cores, the softmax and O in f32, O rounded to bf16 once).
    """
    global launches
    require(q.ndim == 3 and k.ndim == 3 and k.shape == v.shape, "q, k, v must be (BH, S, hd)")
    BH, Sq, hd = q.shape
    require(k.shape[0] > 0 and BH % k.shape[0] == 0 and k.shape[2] == hd,
            f"kv shape {tuple(k.shape)} does not group q {tuple(q.shape)}")
    require(window is None or window > 0, "window must be positive")
    require(attn_softcap is None or attn_softcap > 0, "attn_softcap must be positive")
    require(q.device == k.device == v.device, "q, k, v on different devices")
    if _build.plain_path(q):
        return _build.run_plain("flash_attention", flash_attention_ref, q, k, v, causal=causal,
                                window=window, attn_softcap=attn_softcap)
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    require(q.dtype == k.dtype == v.dtype and q.dtype in (torch.float32, torch.bfloat16),
            f"q, k, v must be all float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require_head_dim(hd, q.dtype)
    require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "q, k, v must be contiguous and 16-byte aligned")
    lib, fn = _fn()
    n_rep, Sk = BH // k.shape[0], k.shape[1]
    out = torch.empty_like(q)
    bf = int(q.dtype == torch.bfloat16)
    scratch = torch.empty(scratch_elems(BH, Sk, hd, n_rep, q.dtype, lib.flash_key_tile(),
                                        bool(lib.flash_wgmma(bf, hd))),
                          dtype=torch.bfloat16, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), scratch.data_ptr(), BH, Sq,
            Sk, hd, n_rep, int(causal), window or 0, attn_softcap or 0.0, hd ** -0.5, bf,
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    launches += 1
    return _fill_keyless(out, v, n_rep, window)
