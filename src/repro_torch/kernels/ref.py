"""Plain PyTorch versions of the kernels (the allclose targets).

Same signatures and layouts as the reference's oracles
(``repro.kernels.ref``). The wrappers in this package take these on
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import QTensor, dequantize

_NEG_INF = -1e30


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """Dequantize-then-matmul (the paper's Fig. 8 two-step path).
    x (M, K); q (K, N) int8 or (K, N/2) packed int4; scale (K, N/128)."""
    orig_last = scale.shape[-1] * 128
    w = dequantize(QTensor(q, scale, bits, 128, orig_last), torch.float32)
    return x @ w.to(x.dtype)


def _repeat_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(BHkv, S, hd) -> (BHkv·n, S, hd): row bh reads kv row bh // n."""
    return t if n == 1 else t.repeat_interleave(n, dim=0)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Naive quadratic attention. q: (BH, S, hd); k, v: (BH, S, hd), or
    (BH/n_rep, S, hd) grouped — query row bh reads kv row bh // n_rep,
    which is the reference's repeated-KV layout without the copy."""
    BH, Sq, hd = q.shape
    n_rep = BH // k.shape[0]
    k, v = _repeat_heads(k, n_rep), _repeat_heads(v, n_rep)
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd ** -0.5)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def paged_attention_ref(
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
    """Paged decode attention: gather-then-dense.

    q: (B, Hkv, n_rep, hd) post-rope query of the new token;
    k/v_pages: (n_pages, page, Hkv, hd) — int8 payload with
    ``[kv]_scale`` (n_pages, page, Hkv), or plain f32/bf16;
    block_tables: (B, max_pages) int32 page ids (0 = the null page);
    lengths: (B,) int32 — the index the new token was written at (it is
    attended: ``kpos <= lengths[b]``). Returns (B, Hkv, n_rep, hd) f32.
    """
    B = q.shape[0]
    hd = q.shape[-1]
    bt = block_tables.long()
    k = k_pages[bt].float()  # (B, maxp, page, Hkv, hd)
    v = v_pages[bt].float()
    if k_scale is not None:
        k = k * k_scale[bt].float()[..., None]
    if v_scale is not None:
        v = v * v_scale[bt].float()[..., None]
    S = bt.shape[1] * k_pages.shape[1]
    k = k.reshape(B, S, k.shape[-2], hd)
    v = v.reshape(B, S, v.shape[-2], hd)
    s = torch.einsum("bgrd,bsgd->bgrs", q.float(), k) * (hd ** -0.5)
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    kpos = torch.arange(S, device=q.device)
    lengths = lengths.long()
    valid = kpos[None, :] <= lengths[:, None]
    if window is not None:
        valid &= kpos[None, :] > (lengths[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bgrs,bsgd->bgrd", w, v)
