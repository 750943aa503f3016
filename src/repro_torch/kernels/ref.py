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


def adapter_fuse_ref(b: torch.Tensor, w_down: torch.Tensor, a: torch.Tensor, lam
                     ) -> torch.Tensor:
    """The ``adapter_fuse`` kernel's function: ``λ·(b @ w_down) + (1−λ)·a``
    in the promotion of b's and w_down's dtypes, the product and the mix in
    f32. b (T, d), w_down (d, d_a), a (T, d_a); λ a scalar, already clamped
    to [0, 1]."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=b.device)
    out = lam * (b.float() @ w_down.float()) + (1.0 - lam) * a.float()
    return out.to(torch.promote_types(b.dtype, w_down.dtype))


def mix_fwd_ref(b, w_down: torch.Tensor, a: torch.Tensor, lam):
    """The ``mix_fwd`` kernel's function: (out in ``a``'s dtype, the f32
    residual ``bw = dequant(b)[:, :d] @ w_down``); b (T, d_store), w_down
    (d, d_a) with d <= d_store, a (T, d_a), λ a scalar."""
    from repro_torch.kernels.cached_step import entry_as_f32

    bw = entry_as_f32(b, w_down.shape[0]) @ w_down.float()
    lam = torch.as_tensor(lam, dtype=torch.float32, device=a.device)
    return (lam * bw + (1.0 - lam) * a.float()).to(a.dtype), bw


def dq_adapter_mix_ref(b, w_down: torch.Tensor, a: torch.Tensor, lam, orig_last: int
                       ) -> torch.Tensor:
    """Eager twin of ``cached_step.dq_adapter_mix`` (the reference
    oracle's signature; ``orig_last``, the tap's width, is W_down's rows):
    decompress the entry to f32, dense matmul, λ-mix, in ``a``'s dtype."""
    return mix_fwd_ref(b, w_down[:orig_last], a, lam)[0]


def mix_dw_ref(b, g: torch.Tensor, lam, d: int, dtype=torch.float32) -> torch.Tensor:
    """The ``mix_dw`` kernel's function: ``λ · dequant(b)[:, :d]ᵀ @ g``
    -> (d, d_a) in ``dtype``."""
    from repro_torch.kernels.cached_step import entry_as_f32

    lam = torch.as_tensor(lam, dtype=torch.float32, device=g.device)
    return (lam * (entry_as_f32(b, d).T @ g.float())).to(dtype)


def _capped_logits(h, w, softcap):
    """(logits, d logits / d z): ``softcap(h @ w)`` in f32 and its slope
    (None without a cap)."""
    z = h.float() @ w.float()
    if softcap is None:
        return z, None
    t = torch.tanh(z / softcap)
    return softcap * t, 1.0 - t * t


def ce_fwd_ref(h, w, labels, softcap=None):
    """The ``ce_fwd`` kernel's function: per-token (nll, lse), f32."""
    logits, _ = _capped_logits(h, w, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, 1, labels.long()[:, None])[:, 0], lse


def lmhead_ce_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, softcap=None
                  ) -> torch.Tensor:
    """Full-logits per-token NLL (the (T, V) tensor the CE kernels avoid)."""
    return ce_fwd_ref(h, w, labels, softcap)[0]


def ce_bwd_ref(h, w, labels, lse, g, softcap=None) -> torch.Tensor:
    """The ``ce_bwd`` kernel's function:
    ``dh = g · ((softmax − onehot) · (1 − tanh²)) @ wᵀ`` in ``h``'s dtype,
    the tanh factor only under a softcap."""
    logits, slope = _capped_logits(h, w, softcap)
    p = torch.exp(logits - lse.float()[:, None])
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    if slope is not None:
        p = p * slope
    return ((p @ w.float().T) * g.float()[:, None]).to(h.dtype)


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
