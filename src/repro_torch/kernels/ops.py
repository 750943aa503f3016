"""Public wrappers over the kernels for model-shaped tensors (counterpart
of ``repro.kernels.ops``).

Each takes the layout the model code holds and reshapes it to the
kernel's, as the reference does: a (…, d) activation becomes 2-D for
``quant_matmul`` and ``adapter_fuse``, and (B, H, S, hd) attention
becomes (B·H, S, hd). Where the reference routes between its Pallas
kernel and the jnp oracle by backend, each kernel wrapper here routes
by the tensors' device: the plain version on CPU and meta tensors, the CUDA
kernel on the card (or an error). The ``cuda`` OpSet calls these.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import adapter_fuse as _adapter_fuse
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import quant_matmul as _qmm


def quant_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``x @ dequant(w)`` with the dequantization on chip. x (…, K);
    w a 2-D QTensor in blocks of 128, or narrower than 128 columns (one
    block a row: its codes are padded with zeros to the kernel's 128)
    -> (…, w.orig_last) f32."""
    single = w.block < _qmm.QBLOCK and w.scale.shape[-1] == 1
    if w.q.ndim != 2 or not (w.block == _qmm.QBLOCK or single):
        raise ValueError(f"quant_matmul takes 2-D weights in blocks of {_qmm.QBLOCK}, got {w}")
    q = w.q
    if single:
        q = torch.nn.functional.pad(q, (0, _qmm.QBLOCK * w.bits // 8 - q.shape[-1]))
    lead, K = x.shape[:-1], x.shape[-1]
    out = _qmm.quant_matmul(x.reshape(-1, K).contiguous(), q, w.scale, bits=w.bits)
    if out.shape[1] != w.orig_last:
        out = out[:, : w.orig_last]
    return out.reshape(lead + (w.orig_last,))


def adapter_fuse(b: torch.Tensor, w_down: torch.Tensor, a: torch.Tensor, lam) -> torch.Tensor:
    """``λ·(b @ w_down) + (1−λ)·a``, fused. b (…, d); a (…, d_a);
    w_down (d, d_a) -> (…, d_a) in the promotion of b's and w_down's dtypes."""
    lead = b.shape[:-1]
    out = _adapter_fuse.adapter_fuse(b.reshape(-1, b.shape[-1]).contiguous(),
                                     w_down.contiguous(),
                                     a.reshape(-1, a.shape[-1]).contiguous(), lam)
    return out.reshape(lead + (out.shape[-1],))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, attn_softcap: Optional[float] = None
                    ) -> torch.Tensor:
    """(B, H, S, hd) attention; k, v (B, H or Hkv, S, hd) — grouped KV
    heads are read in place. Returns (B, H, S, hd) f32."""
    B, H, S, hd = q.shape

    def fold(t):
        return t.reshape(B * t.shape[1], t.shape[2], hd).contiguous()

    out = _flash.flash_attention(fold(q), fold(k), fold(v), causal=causal, window=window,
                                 attn_softcap=attn_softcap)
    return out.reshape(B, H, S, hd)
