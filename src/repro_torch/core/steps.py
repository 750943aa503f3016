"""PAC+ training and single-user serving steps (counterpart of
``repro.core.steps``).

* :func:`pac_train_step` — epoch 1: frozen (possibly quantized) backbone
  forward, then an adapter update; returns the activations for the cache.
* :func:`pac_cached_train_step` — epoch ≥ 2: adapter-only, from cached
  activations.
* :func:`prefill_step`, :func:`decode_step`, :func:`pac_decode_step` —
  serving one user's personal model against a linear KV cache (f32, or
  INT8 from ``init_cache(kv_quant=8)``), updated in place.

Gradients are ``torch.autograd.grad`` over the adapter's leaves; the
frozen path runs under ``torch.no_grad()`` (the reference's
``stop_gradient``). Every step is functional, as in the reference: it
returns new adapter and optimizer trees and leaves its inputs alone.
Nothing in a step reads a device value back to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import adapter_decode, pac_logits
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.models.backbone import (
    backbone_decode,
    backbone_forward,
    cross_entropy,
    decode_periods,
    logits_from_hidden,
)
from repro_torch.optim import adamw_update, clip_by_global_norm


def _update(loss_fn, adapter_params, opt_state, lr, clip):
    """Loss, gradients over the adapter's leaves, clip, AdamW."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), adapter_params)
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), leaves)
    grads, _ = clip_by_global_norm(grads, clip)
    adapter_params, opt_state = adamw_update(leaves, grads, opt_state, lr=lr)
    return loss.detach(), adapter_params, opt_state


def pac_train_step(backbone_params, adapter_params, opt_state, batch, *, cfg, r: int = 8,
                   lr=1e-3, clip=1.0, kernel_impl: str = "ref", tap_policy: str = "f32"):
    """Epoch-1 PAC+ step.

    ``kernel_impl="ref"`` runs the plain OpSet and the plain loss;
    ``"cuda"`` runs the frozen forward on still-quantized weights through
    the kernels, emits the activations in the cache's storage form
    (``tap_policy`` = the cache's compress policy) and computes the loss
    on them with the fused cached-step kernels.

    Returns (loss, adapter_params', opt_state', (b0, taps, b_final))."""
    from repro_torch.kernels.cached_step import cached_loss_parts

    ops = get_opset(kernel_impl, tap_policy)  # the ref OpSet always emits f32
    with torch.no_grad():
        b_final, taps, x, positions = backbone_forward(
            backbone_params, cfg, batch, collect_taps=True, return_inputs=True, ops=ops)
    labels = batch["labels"]
    if kernel_impl == "ref":
        def loss_fn(ap):
            return cross_entropy(pac_logits(backbone_params, ap, cfg, x, taps, b_final,
                                            positions, r), labels)

        loss, adapter_params, opt_state = _update(loss_fn, adapter_params, opt_state, lr, clip)
        return loss, adapter_params, opt_state, (x, taps, b_final)

    b0_s, bf_s = ops.emit_tap(x), ops.emit_tap(b_final)
    cached = {"b0": b0_s, "taps": taps, "b_final": bf_s, "labels": labels}

    def loss_fn(ap):
        num, den = cached_loss_parts(backbone_params, ap, cfg, cached, positions, r,
                                     impl=kernel_impl)
        return num / torch.clamp_min(den, 1)

    loss, adapter_params, opt_state = _update(loss_fn, adapter_params, opt_state, lr, clip)
    return loss, adapter_params, opt_state, (b0_s, taps, bf_s)


def _cached_positions(cached_batch, cfg):
    if "positions" in cached_batch:
        return cached_batch["positions"]
    labels = cached_batch["labels"]
    B, S = labels.shape
    if cfg.rope == "mrope":
        raise NotImplementedError("mrope (qwen2-vl) arrives with the other-families slice")
    return torch.arange(S, dtype=torch.int32, device=labels.device).expand(B, S)


def pac_cached_train_step(backbone_params, adapter_params, opt_state, cached_batch, *, cfg,
                          r: int = 8, lr=1e-3, clip=1.0, kernel_impl: str = "ref"):
    """Epoch ≥ 2 PAC+ step: the activation cache replaces the backbone.

    cached_batch: {"b0": (B,S,d), "taps": (n_p,B,S,d), "b_final": (B,S,d),
    "labels": (B,S), optional "positions"}; each activation may be in its
    storage form (f32/bf16 tensor or int8 QTensor), decompressed on the
    device inside the step. ``kernel_impl="cuda"`` fuses the per-period
    dequant × down-projection × λ-mix and streams the LM-head CE, so
    neither f32 taps nor the logits are ever resident; ``"ref"`` upcasts
    and materialises the (B,S,vocab) logits. Only the head and final norm
    of ``backbone_params`` are read.

    Returns (loss, adapter_params', opt_state')."""
    from repro_torch.kernels.cached_step import cached_loss_parts

    positions = _cached_positions(cached_batch, cfg)

    def loss_fn(ap):
        num, den = cached_loss_parts(backbone_params, ap, cfg, cached_batch, positions, r,
                                     impl=kernel_impl)
        return num / torch.clamp_min(den, 1)

    return _update(loss_fn, adapter_params, opt_state, lr, clip)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(params, batch, *, cfg, kernel_impl: str = "ref"):
    """Full-prompt forward through the ``kernel_impl`` OpSet. Returns the
    last position's logits (B,1,V)."""
    h, _ = backbone_forward(params, cfg, batch, ops=get_opset(kernel_impl))
    return logits_from_hidden(params, cfg, h[:, -1:, :])


@torch.no_grad()
def decode_step(params, token_batch, cache, pos, *, cfg, kernel_impl: str = "ref"):
    """One-token decode against the linear cache. Returns (logits, cache)."""
    return backbone_decode(params, cfg, token_batch, cache, pos, ops=get_opset(kernel_impl))


@torch.no_grad()
def pac_decode_step(backbone_params, adapter_params, token_batch, cache, adapter_cache, pos,
                    *, cfg, r: int = 8, kernel_impl: str = "ref"):
    """Serve the personal model: backbone decode plus side-network decode.

    token_batch: {"tokens": (B,1)} or {"embeds": (B,1,d)}; cache: the
    backbone's linear cache (``init_cache``, f32 or ``kv_quant=8``);
    adapter_cache: ``init_adapter_cache``; pos: the index the token is
    written at (an int or a (B,) tensor). The frozen backbone runs on the
    ``kernel_impl`` OpSet, so does the adapter's per-period λ-mix (under
    ``cuda`` the ``adapter_fuse`` kernel); the adapter's blocks and the
    LM head stay on plain ops, as in the reference. Returns (logits
    (B,1,V), cache, adapter_cache) — both caches updated in place."""
    ops = get_opset(kernel_impl)
    if "embeds" in token_batch:
        x = token_batch["embeds"]
    else:
        x = ops.embed_lookup(backbone_params["embed"], token_batch["tokens"])
    pos = torch.as_tensor(pos, device=x.device).long().expand(x.shape[0])
    b_final, taps = decode_periods(backbone_params, cfg, x, cache, pos, ops=ops)
    side, adapter_cache = adapter_decode(adapter_params, cfg, x, taps, adapter_cache, pos, r,
                                         ops=ops)
    return logits_from_hidden(backbone_params, cfg, b_final + side), cache, adapter_cache
