"""Batched paged decode + prefill steps (counterpart of ``repro.serve.decode``).

:func:`paged_pac_decode_step` serves B requests with B different
adapters in one step, against KV that lives in the shared page pool —
each request's cache is its block-table row. Per-request ``lengths``
give the write index and rope position of each row. Attention goes
through ``ops.paged_attention``: the ``cuda`` OpSet runs the paged CUDA
kernel, ``ref`` the gather-then-dense version; INT8 pages are
dequantized inside those ops only.

:func:`paged_prefill` ingests whole prompts in one batched forward whose
per-layer K/V is scattered into the pages, plus the adapter-side
prefill, for attention patterns (dense or MoE FFNs). An SSM block of the
decode step runs its mixer's decode on the per-slot state rows (SSM and
hybrid archs take the engine's stepwise prompt path: prompt tokens fed
through the decode step). An MoE FFN at decode routes the step's B
tokens at twice the config's capacity factor, as the reference does.

Pools and adapter caches are updated **in place**; the functions return
them too, mirroring the reference's signatures.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import batched_adapter_decode, batched_adapter_prefill
from repro_torch.models import ssm
from repro_torch.models.backbone import apply_block, embed_inputs, logits_from_hidden, period_slice
from repro_torch.models.layers import _project_qkv, decode_positions, mlp_forward
from repro_torch.models.moe import moe_forward
from repro_torch.serve.paging import period_entry, write_prompt_kv, write_token_kv


def _paged_attention_block(p, h, cfg, spec, entry, block_tables, lengths, ops):
    """One attention mixer against the page pool. h: (B,1,d); entry: one
    period slice of an attention pool (written in place). Returns mix."""
    B = h.shape[0]
    q, k, v = _project_qkv(p, h, cfg, decode_positions(cfg, lengths), ops)
    write_token_kv(entry, k, v, block_tables, lengths)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    qh = q[:, 0].reshape(B, cfg.n_kv_heads, n_rep, cfg.hd)
    if isinstance(entry["k"], dict):  # INT8 pages: payload + scales
        o = ops.paged_attention(
            qh, entry["k"]["q"], entry["v"]["q"], entry["k"]["scale"], entry["v"]["scale"],
            block_tables, lengths, cfg, spec)
    else:
        o = ops.paged_attention(qh, entry["k"], entry["v"], None, None,
                                block_tables, lengths, cfg, spec)
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd).to(h.dtype)
    return ops.matmul(o, p["wo"])


def _apply_block_paged(p, x, cfg, spec, entry, block_tables, lengths, ops):
    """``apply_block_decode`` with the attention cache paged; an SSM
    kind runs on its per-slot state rows (``entry``: (B, ...) leaves,
    written in place)."""
    p = ops.prepare_block(p, spec)
    h = ops.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        mix = _paged_attention_block(p["mixer"], h, cfg, spec, entry, block_tables, lengths, ops)
    else:
        mix = ssm.decode_into(spec.kind, p["mixer"], h, cfg, entry)
    x = x + mix
    if "ffn" in p:
        h = ops.rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe and cfg.moe is not None:
            x = x + moe_forward(p["ffn"], h, cfg.moe,
                                capacity_factor=2.0 * cfg.moe.capacity_factor)
        else:
            x = x + mlp_forward(p["ffn"], h, ops=ops)
    return x


def paged_pac_decode_step(
    backbone_params,
    adapter_batch,
    tokens: torch.Tensor,
    pools: List,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    adapter_cache,
    *,
    cfg,
    r: int = 8,
    kernel_impl: str = "cuda",
):
    """One continuous-batching decode step: B requests, B adapters.

    tokens: (B,1) int; pools: one entry per pattern position, a whole
    page pool for attention, the per-slot state rows sliced to the B rows
    for an SSM kind; block_tables: (B, max_pages) int32; lengths: (B,)
    int32 write index;
    adapter_batch / adapter_cache: ``None`` to serve the bare backbone,
    else a gathered (B, ...) adapter tree + its (n_p, B, L, ...) cache.
    Returns (logits (B,1,V), pools, adapter_cache) — the last two updated
    in place. Row b equals a B=1 call for request b alone.
    """
    ops = get_opset(kernel_impl)
    block_tables = block_tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    x = ops.embed_lookup(backbone_params["embed"], tokens)
    h = x
    taps = []
    for i in range(cfg.n_periods):
        blocks = period_slice(backbone_params["blocks"], i)
        for j, spec in enumerate(cfg.pattern):
            h = _apply_block_paged(blocks[j], h, cfg, spec, period_entry(pools[j], i),
                                   block_tables, lengths, ops)
        taps.append(h)
    if adapter_batch is None:
        side = 0.0
    else:
        side, adapter_cache = batched_adapter_decode(
            adapter_batch, cfg, x, taps, adapter_cache, lengths, r)
    logits = logits_from_hidden(backbone_params, cfg, h + side)
    return logits, pools, adapter_cache


def paged_prefill(
    backbone_params,
    adapter_batch,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    pools: List,
    block_tables: torch.Tensor,
    *,
    cfg,
    max_len: int,
    r: int = 8,
    kernel_impl: str = "cuda",
):
    """One-shot prompt ingestion.

    tokens: (B, S) int, left-aligned, padded past ``lengths[b]`` (padding
    KV lands on the null page); block_tables must already cover
    ``ceil(lengths/page)`` pages per row. Returns (last-token logits
    (B,1,V), pools (written in place), adapter caches in the
    ``init_adapter_cache`` layout, or ``None`` when ``adapter_batch`` is).
    Attention patterns only: SSM and hybrid archs take the engine's
    stepwise path.
    """
    if any(s.kind != "attn" for s in cfg.pattern):
        raise ValueError(
            f"one-shot paged prefill needs an all-attention pattern; {cfg.name} has "
            f"{tuple(s.kind for s in cfg.pattern)}: the engine's stepwise prompt path covers "
            "SSM and hybrid archs")
    ops = get_opset(kernel_impl)
    block_tables = block_tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    x, positions = embed_inputs(backbone_params, cfg, {"tokens": tokens}, ops=ops)
    h = x
    taps = []
    for i in range(cfg.n_periods):
        blocks = period_slice(backbone_params["blocks"], i)
        for j, spec in enumerate(cfg.pattern):
            h, (k, v) = apply_block(blocks[j], h, cfg, spec, positions, ops=ops, return_kv=True)
            write_prompt_kv(period_entry(pools[j], i), k, v, block_tables, lengths)
        taps.append(h)
    if adapter_batch is None:
        side, acaches = 0.0, None
    else:
        side, acaches = batched_adapter_prefill(adapter_batch, cfg, x, taps, positions,
                                                max_len, r)
    hs = h + side
    idx = torch.clamp_min(lengths.long() - 1, 0)
    h_last = hs[torch.arange(hs.shape[0], device=hs.device), idx][:, None]
    logits = logits_from_hidden(backbone_params, cfg, h_last)
    return logits, pools, acaches
