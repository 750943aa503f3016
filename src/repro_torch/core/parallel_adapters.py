"""Parallel Adapters — the per-user side network (paper §IV-A).

Counterpart of ``repro.core.parallel_adapters``. Adapter block *i*
consumes ``λ_i · W_down_i(b_i) + (1 − λ_i) · a_{i−1}``, where ``b_i`` is
the backbone's hidden state after period *i*; the final adapter state is
projected up with ``W_up`` and added to the backbone's final hidden
state before the frozen LM head. The adapter runs on plain PyTorch ops
(the ``ref`` OpSet), as in the reference.

Multi-tenant serving runs B requests with B different adapters in one
step. The reference ``vmap``s over requests; here the request axis is
explicit: :func:`rows` lays a gathered adapter batch out so that every
weight carries a request axis right after the period axis and every
gain broadcasts per row, and the single-adapter functions below then run
all B side networks at once, with per-row positions, cache writes and
masks.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.opset import get_opset
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.models.backbone import (
    apply_block,
    apply_block_decode,
    init_block,
    init_cache,
    logits_from_hidden,
    period_slice,
)
from repro_torch.models.layers import LeafMaker, promoted_matmul, rms_norm


def adapter_config(cfg, r: int = 8):
    """The paper's 'lightweight version of the backbone': every width /r."""
    d_a = max(8, cfg.d_model // r)
    n_heads = max(1, cfg.n_heads // r)
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = max(1, n_heads // ratio)
    n_heads = max(n_heads, n_kv)
    hd = max(4, (d_a // n_heads) // 2 * 2)  # rope needs an even head_dim
    d_a = hd * n_heads
    pattern = tuple(dataclasses.replace(s, moe=False) for s in cfg.pattern)
    d_ff = cfg.d_ff
    if any(s.moe for s in cfg.pattern) and cfg.moe is not None:
        d_ff = cfg.moe.d_expert * cfg.moe.top_k
    return dataclasses.replace(
        cfg,
        name=cfg.name + f"-adapter-r{r}",
        d_model=d_a,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=max(16, d_ff // r) if d_ff else 0,
        pattern=pattern,
        moe=None,
        mlstm_chunk=cfg.mlstm_chunk,
    )


def init_adapter(gen: torch.Generator, cfg, r: int = 8, *, device=None,
                 dtype=torch.float32) -> dict:
    """Random (Gaussian) adapter; block leaves stacked over periods."""
    acfg = adapter_config(cfg, r)
    n_p = cfg.n_periods
    d, d_a = cfg.d_model, acfg.d_model
    leaf = LeafMaker(gen, device=device, dtype=dtype)
    return {
        "downs": leaf.normal((n_p + 1, d, d_a), d ** -0.5),  # [0] embeds b_0
        "lambda": torch.full((n_p,), 0.5, dtype=torch.float32, device=device),
        "blocks": [init_block(LeafMaker(gen, device=device, dtype=dtype, lead=(n_p,)), acfg, s)
                   for s in acfg.pattern],
        "up": leaf.normal((d_a, d), d_a ** -0.5),
        "out_norm": torch.zeros((d_a,), dtype=dtype, device=device),
    }


def adapter_param_count(cfg, r: int = 8) -> int:
    """Trainable parameters of one adapter, counted over its leaves (drawn
    on the meta device: shapes only), as the reference counts them."""
    params = init_adapter(torch.Generator(), cfg, r, device="meta")
    return sum(t.numel() for t in tree_leaves(params))


def init_adapter_cache(cfg, B: int, max_len: int, r: int = 8, dtype=torch.float32,
                       device=None):
    """The adapter's decode cache: :func:`init_cache` of its config (K/V
    per attention block, the recurrent state per SSM block)."""
    return init_cache(adapter_config(cfg, r), B, max_len, dtype, device)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def adapter_forward(adapter_params, cfg, b0, taps, positions, r: int = 8):
    """Run the side network. b0: (B,S,d) embedding output; taps:
    (n_p,B,S,d) activations after each period. Returns the final adapter
    state projected up to d: (B,S,d)."""
    acfg = adapter_config(cfg, r)
    downs = adapter_params["downs"]
    lambdas = torch.clamp(adapter_params["lambda"], 0.0, 1.0)
    # a bf16 backbone's b0 and taps meet the f32 adapter in f32 (JAX's
    # promotion); the mix is cast back to the carry's dtype, as the
    # reference's ``mixed.astype(a_prev.dtype)``
    a = promoted_matmul(b0, downs[0])
    blocks = adapter_params["blocks"]
    for i in range(cfg.n_periods):
        lam = lambdas[i]
        h = (lam * promoted_matmul(taps[i], downs[i + 1]) + (1.0 - lam) * a).to(a.dtype)
        for spec, p in zip(acfg.pattern, period_slice(blocks, i)):
            h = apply_block(p, h, acfg, spec, positions)
        a = h
    a = rms_norm(a, adapter_params["out_norm"], acfg.norm_eps)
    return a @ adapter_params["up"]


def pac_logits(backbone_params, adapter_params, cfg, b0, taps, b_final, positions,
               r: int = 8):
    """Side-tuning combine: adapter output + backbone final hidden state
    through the frozen head."""
    side = adapter_forward(adapter_params, cfg, b0, taps, positions, r)
    return logits_from_hidden(backbone_params, cfg, b_final + side)


# ---------------------------------------------------------------------------
# Adapter banks: one adapter per request
# ---------------------------------------------------------------------------


def stack_adapters(adapters):
    """Stack per-user adapter trees into one bank with a leading user axis."""
    adapters = list(adapters)
    if not adapters:
        raise ValueError("need at least one adapter")

    def zip_map(*trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map(*(t[k] for t in trees)) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(zip_map(*vs) for vs in zip(*trees))
        return torch.stack(trees)

    return zip_map(*adapters)


def gather_adapters(bank, user_idx: torch.Tensor):
    """Per-request adapters: bank leaves (U, ...) gathered to (B, ...) by
    ``user_idx`` (B,) — duplicates are fine."""
    idx = user_idx.long()
    return tree_map(lambda t: t[idx], bank)


def rows(adapter_batch):
    """Lay a gathered (B, ...) adapter batch out for the batched forward:
    period-stacked leaves become (n_p, B, ...), so that indexing period i
    gives per-row weights (B, d_in, d_out) for ``x @ w``; vector gains
    gain a broadcast axis, (…, B, 1, d); λ becomes (n_p, B, 1, 1)."""

    def per_period(t):  # (B, n_p, *rest) -> (n_p, B, *rest), gains (n_p, B, 1, d)
        t = t.transpose(0, 1)
        return t[:, :, None, :] if t.ndim == 3 else t

    return {
        "downs": adapter_batch["downs"].transpose(0, 1),
        "lambda": adapter_batch["lambda"].transpose(0, 1)[:, :, None, None],
        "blocks": [tree_map(per_period, b) for b in adapter_batch["blocks"]],
        "up": adapter_batch["up"],
        "out_norm": adapter_batch["out_norm"][:, None, :],
    }


# ---------------------------------------------------------------------------
# Decode / prefill
# ---------------------------------------------------------------------------


def adapter_decode(adapter_params, cfg, b0_t, taps_t, cache, pos, r: int = 8, ops=None):
    """One-token adapter step. b0_t: (B,1,d); taps_t: (n_p,B,1,d); cache:
    the :func:`init_adapter_cache` layout (K/V for attention blocks, the
    recurrent state for SSM ones), updated in place; pos: (B,) per-row
    write index. ``adapter_params`` is one adapter or a
    :func:`rows` batch. Each period's λ-mix runs ``ops.adapter_mix``
    (the ``cuda`` OpSet's ``adapter_fuse`` kernel for one adapter); the
    adapter's blocks stay on the plain ops, as in the reference.
    Returns (side (B,1,d), cache)."""
    ops = ops if ops is not None else get_opset("ref")
    acfg = adapter_config(cfg, r)
    downs = adapter_params["downs"]
    lambdas = torch.clamp(adapter_params["lambda"], 0.0, 1.0)
    a = promoted_matmul(b0_t, downs[0])
    blocks = adapter_params["blocks"]
    for i in range(cfg.n_periods):
        h = ops.adapter_mix(taps_t[i], downs[i + 1], a, lambdas[i]).to(a.dtype)
        for j, (spec, p) in enumerate(zip(acfg.pattern, period_slice(blocks, i))):
            entry = {name: t[i] for name, t in cache[j].items()}
            h, _ = apply_block_decode(p, h, acfg, spec, entry, pos)
        a = h
    a = rms_norm(a, adapter_params["out_norm"], acfg.norm_eps)
    return a @ adapter_params["up"], cache


def batched_adapter_decode(adapter_batch, cfg, b0_t, taps_t, cache, lengths, r: int = 8):
    """One adapter step for B requests with B different adapters and
    per-request write positions. adapter_batch: (B, ...) leaves (see
    :func:`gather_adapters`); cache leaves (n_p, B, L, ...), updated in
    place; lengths: (B,). Row b equals :func:`adapter_decode` of
    request b alone."""
    return adapter_decode(rows(adapter_batch), cfg, b0_t, taps_t, cache, lengths, r)


def adapter_prefill(adapter_params, cfg, b0, taps, positions, max_len: int, r: int = 8):
    """Side-network prefill: one forward over the prompt that also
    captures the adapter's KV (the decode-ready state).

    b0: (B,S,d); taps: (n_p,B,S,d) or a list of n_p (B,S,d); positions
    (B,S). Returns (side (B,S,d), caches) with caches in the
    :func:`init_adapter_cache` layout, the first S slots holding the
    prompt KV. Attention-pattern adapters only, as in the reference: an
    SSM block's forward keeps no final state, and SSM and hybrid archs
    take the engine's stepwise prompt path instead."""
    acfg = adapter_config(cfg, r)
    if any(s.kind != "attn" for s in acfg.pattern):
        raise ValueError("adapter_prefill supports attention-pattern adapters only; got "
                         f"{tuple(s.kind for s in acfg.pattern)}")
    S = b0.shape[1]
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    downs = adapter_params["downs"]
    lambdas = torch.clamp(adapter_params["lambda"], 0.0, 1.0)
    a = promoted_matmul(b0, downs[0])
    B = b0.shape[0]
    # the adapter's K/V in its carry's dtype (f32 beside a bf16 backbone)
    caches = init_cache(acfg, B, max_len, dtype=a.dtype, device=b0.device)
    blocks = adapter_params["blocks"]
    for i in range(cfg.n_periods):
        lam = lambdas[i]
        h = (lam * promoted_matmul(taps[i], downs[i + 1]) + (1.0 - lam) * a).to(a.dtype)
        for j, (spec, p) in enumerate(zip(acfg.pattern, period_slice(blocks, i))):
            h, (k, v) = apply_block(p, h, acfg, spec, positions, return_kv=True)
            caches[j]["k"][i, :, :S] = k
            caches[j]["v"][i, :, :S] = v
        a = h
    a = rms_norm(a, adapter_params["out_norm"], acfg.norm_eps)
    return a @ adapter_params["up"], caches


def batched_adapter_prefill(adapter_batch, cfg, b0, taps, positions, max_len: int,
                            r: int = 8):
    """Per-request-adapter prefill: :func:`adapter_prefill` with a
    (B, ...) adapter batch."""
    return adapter_prefill(rows(adapter_batch), cfg, b0, taps, positions, max_len, r)
