"""The cached-epoch (epoch ≥ 2) training hot path: the adapter mix on
storage-form cache entries and the blockwise LM-head cross-entropy.

Counterpart of ``repro.kernels.cached_step``. From epoch 2 on the
activation cache replaces every backbone forward (paper §IV-B), and the
cached step is the per-step cost of a fine-tuning run. Its two heavy
pieces run on hand-written CUDA kernels:

* :func:`dq_adapter_mix` — ``λ · (dequant(b) @ W_down) + (1 − λ) · a``
  per period, where ``b`` is a cache entry in its storage form
  (``kernels/cached_mix.py``);
* :func:`lmhead_ce` — the per-token NLL over the frozen head without
  the (T, vocab) logits (``kernels/lmhead_ce.py``).

:func:`cached_loss_parts` composes them into the cached-epoch PAC+ loss:
``impl="ref"`` is the plain oracle (upcast to f32, dense matmuls, full
logits) and ``impl="cuda"`` the kernel path. Both take every storage
form. On CPU tensors the kernel wrappers compute their plain versions,
so the ``cuda`` composition runs on the CPU too.

Storage form: a cached activation is an f32 or bf16 tensor, or, under
the int8 policy, a :class:`~repro_torch.core.quantization.QTensor`
(int8 payload ``(..., d_pad)`` + one f32 scale per 128-wide block,
``orig_last = d``) — the port's form of the reference's
``{"q", "scale"}`` dict, which PyTorch, having no pytrees to keep
plain, does not need.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, dequantize, maybe_dequantize_tree
from repro_torch.kernels.cached_mix import MixFn
from repro_torch.kernels.lmhead_ce import CEFn

# ---------------------------------------------------------------------------
# Cache-entry storage form
# ---------------------------------------------------------------------------


def is_quantized_entry(x) -> bool:
    """True for the int8 storage form."""
    return isinstance(x, QTensor)


def entry_as_f32(x, orig_last: int) -> torch.Tensor:
    """Storage form -> f32 tensor (the eager, plain decompression)."""
    if is_quantized_entry(x):
        return dequantize(QTensor(x.q, x.scale, 8, x.block, orig_last))
    return x.float()


def _rows(x):
    """Fold the leading axes of an entry: (..., d) -> (T, d)."""
    if is_quantized_entry(x):
        return QTensor(x.q.reshape(-1, x.q.shape[-1]).contiguous(),
                       x.scale.reshape(-1, x.scale.shape[-1]).contiguous(),
                       x.bits, x.block, x.orig_last)
    return x.reshape(-1, x.shape[-1]).contiguous()


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def dq_adapter_mix(b, w_down: torch.Tensor, a: torch.Tensor, lam) -> torch.Tensor:
    """Fused ``λ · (dequant(b) @ w_down) + (1 − λ) · a``.

    b: (..., d) cache entry in storage form (a frozen activation: no
    gradient); w_down: (d, d_a); a: (..., d_a), whose dtype and shape
    the result takes; lam: scalar λ (a tensor, differentiable, or a
    float)."""
    lead = a.shape[:-1]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=a.device)
    out = MixFn.apply(_rows(b), w_down, a.reshape(-1, a.shape[-1]).contiguous(), lam)
    return out.reshape(*lead, -1)


def lmhead_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *, softcap=None
              ) -> torch.Tensor:
    """Per-token NLL of ``softmax(softcap(h @ w))`` -> (T,) f32.

    h: (T, d) hidden states after the final norm (differentiable);
    w: (d, V) frozen head (dequantize a QTensor first); labels: (T,) in
    [0, V) — clamp ignored positions to 0 and mask their NLL outside."""
    cap = None if softcap is None else float(softcap)
    return CEFn.apply(h.contiguous(), w.contiguous(), labels, cap)


# ---------------------------------------------------------------------------
# The composed cached-epoch loss
# ---------------------------------------------------------------------------


def ref_cached_loss_parts(backbone_params, adapter_params, cfg, cached, positions,
                          r: int = 8):
    """Plain oracle: eager f32 decompression + dense torch math."""
    from repro_torch.core.parallel_adapters import pac_logits
    from repro_torch.models.backbone import cross_entropy_parts

    b0, taps, b_final = (entry_as_f32(cached[k], cfg.d_model) for k in ("b0", "taps", "b_final"))
    logits = pac_logits(backbone_params, adapter_params, cfg, b0, taps, b_final, positions, r)
    return cross_entropy_parts(logits, cached["labels"])


def fused_cached_loss_parts(backbone_params, adapter_params, cfg, cached, positions,
                            r: int = 8):
    """The kernel path: storage-form entries feed :func:`dq_adapter_mix`
    per period, the head runs through :func:`lmhead_ce` (on the session's
    one contiguous f32 head, ``loss_head``, tied or not); the d/r-wide
    adapter blocks, norms and the up projection are plain torch at
    1/r² the backbone's cost."""
    from repro_torch.core.parallel_adapters import adapter_config
    from repro_torch.models.backbone import apply_block, loss_head, period_slice
    from repro_torch.models.layers import rms_norm

    labels = cached["labels"]
    B, S = labels.shape
    d = cfg.d_model
    acfg = adapter_config(cfg, r)
    downs = adapter_params["downs"]
    lambdas = torch.clamp(adapter_params["lambda"], 0.0, 1.0)
    taps = cached["taps"]

    # the embedding-side projection: the same fused op with λ = 1 (no mix)
    a = dq_adapter_mix(cached["b0"], downs[0],
                       torch.zeros((B, S, acfg.d_model), device=downs.device), 1.0)
    for i in range(cfg.n_periods):
        h = dq_adapter_mix(taps[i], downs[i + 1], a, lambdas[i]).to(a.dtype)
        for spec, p in zip(acfg.pattern, period_slice(adapter_params["blocks"], i)):
            h = apply_block(p, h, acfg, spec, positions)
        a = h
    a = rms_norm(a, adapter_params["out_norm"], acfg.norm_eps)
    side = a @ adapter_params["up"]

    # b_final is one (B, S, d) plane used elementwise: no matmul to fuse
    # its decompression into
    h = entry_as_f32(cached["b_final"], d) + side
    h = rms_norm(h, maybe_dequantize_tree(backbone_params["final_norm"]), cfg.norm_eps)
    mask = labels != -100
    lab = torch.where(mask, labels, torch.zeros_like(labels))
    nll = lmhead_ce(h.reshape(B * S, d), loss_head(backbone_params, cfg), lab.reshape(B * S),
                    softcap=cfg.logit_softcap).reshape(B, S)
    return torch.sum(nll * mask), torch.sum(mask)


def cached_loss_parts(backbone_params, adapter_params, cfg, cached, positions, r: int = 8,
                      *, impl: str = "ref"):
    """(summed NLL, valid-token count) of the cached-epoch PAC+ loss.

    ``cached``: {"b0", "taps", "b_final"} in storage form + "labels".
    ``impl="ref"`` is the plain oracle, ``impl="cuda"`` the kernels."""
    if impl == "ref":
        return ref_cached_loss_parts(backbone_params, adapter_params, cfg, cached, positions, r)
    if impl == "cuda":
        return fused_cached_loss_parts(backbone_params, adapter_params, cfg, cached, positions, r)
    raise ValueError(f"kernel_impl must be 'ref' or 'cuda', got {impl!r}")
