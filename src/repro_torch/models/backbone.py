"""Pattern-driven decoder backbone (counterpart of ``repro.models.backbone``).

An :class:`~repro_torch.configs.base.ArchConfig` declares a period of
layers tiled ``n_periods`` times. Block parameters are stacked over
periods (leaves ``(n_p, ...)``, as in the reference, so parameters bridge
over unchanged); the forward is a Python loop over periods where the
reference scans. Attention blocks with a dense or an MoE FFN
(``models/moe.py``), and the SSM kinds of ``models/ssm.py`` (Mamba,
mLSTM, sLSTM); rope, Qwen2-VL's mrope over (3, B, S) position streams, or
no rope.

Decode runs one token against a per-kind cache: K/V for attention,
(h, conv) for Mamba, (C, n, m) for mLSTM, (c, n, h, m) for sLSTM, each
updated in place.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from repro_torch.core.opset import get_opset
from repro_torch.core.quantization import (
    index_tree,
    maybe_dequantize_tree,
    quantize,
    should_quantize,
    stack,
    tree_leaves,
)
from repro_torch.models import ssm
from repro_torch.models.layers import (
    LeafMaker,
    attention_decode,
    attention_decode_quant,
    attention_forward,
    init_attention,
    init_mlp,
    mlp_forward,
    promoted_matmul,
    rms_norm,
    softcap,
)
from repro_torch.models.moe import init_moe, moe_forward

_REF_OPS = get_opset("ref")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(leaf: LeafMaker, cfg, spec) -> dict:
    """Parameters for one layer position (leaves get ``leaf.lead`` in front)."""
    d = cfg.d_model
    init_mixer = init_attention if spec.kind == "attn" else ssm.MIXERS[spec.kind][0]
    p = {"ln1": leaf.zeros((d,)), "mixer": init_mixer(leaf, cfg)}
    if spec.ffn and (cfg.d_ff or (spec.moe and cfg.moe)):
        p["ln2"] = leaf.zeros((d,))
        if spec.moe and cfg.moe is not None:
            p["ffn"] = init_moe(leaf, d, cfg.moe)
        else:
            p["ffn"] = init_mlp(leaf, d, cfg.d_ff)
    return p


def init_backbone(gen: torch.Generator, cfg, *, device=None, dtype=torch.float32,
                  quant_bits: Optional[int] = None) -> dict:
    """Random backbone with block leaves stacked over periods.

    ``quant_bits`` (8 or 4) quantizes each leaf the moment it is drawn,
    by the rule of ``quantize_tree(bits)`` (an MoE router stays f32), so
    at full width the f32 tree is never resident at once; an MoE expert
    leaf is drawn and quantized one period at a time."""

    def finish(t, name=""):
        if quant_bits is not None and should_quantize((name,), t):
            return quantize(t, quant_bits)
        return t

    def maker(lead=()):
        return LeafMaker(gen, device=device, dtype=dtype, lead=lead, finish=finish)

    d = cfg.d_model
    params = {
        "embed": maker().normal((cfg.vocab, d), d ** -0.5),
        "final_norm": maker().zeros((d,)),
        "blocks": [init_block(maker((cfg.n_periods,)), cfg, spec) for spec in cfg.pattern],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = maker().normal((d, cfg.vocab), d ** -0.5)
    return params


def period_slice(blocks, i: int):
    """Period ``i`` of the stacked block list (views, no copies)."""
    return [index_tree(b, i) for b in blocks]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def apply_block(p, x, cfg, spec, positions, ops=None, return_kv: bool = False):
    """One block over a whole sequence. ``return_kv`` also returns the
    post-rope (k, v) of an attention block, None for an SSM block."""
    ops = ops if ops is not None else _REF_OPS
    p = ops.prepare_block(p, spec)
    h = ops.rms_norm(x, p["ln1"], cfg.norm_eps)
    kv = None
    if spec.kind != "attn":
        mix = ssm.MIXERS[spec.kind][1](p["mixer"], h, cfg)
    elif return_kv:
        mix, kv = attention_forward(p["mixer"], h, cfg, spec, positions, ops=ops, return_kv=True)
    else:
        mix = attention_forward(p["mixer"], h, cfg, spec, positions, ops=ops)
    x = x + mix
    if "ffn" in p:
        h = ops.rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe and cfg.moe is not None:
            x = x + moe_forward(p["ffn"], h, cfg.moe)
        else:
            x = x + mlp_forward(p["ffn"], h, ops=ops)
    if return_kv:
        return x, kv
    return x


def embed_inputs(params, cfg, batch: dict, ops=None):
    """Token embedding. batch: {"tokens": (B,S) int} or {"embeds": (B,S,d)};
    optional {"positions": (B,S), or (3,B,S) under mrope}; by default
    arange positions, on all three streams under mrope. Returns
    (x, positions)."""
    ops = ops if ops is not None else _REF_OPS
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = ops.embed_lookup(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = arange_positions(cfg, B, S, x.device)
    return x, positions


def arange_positions(cfg, B: int, S: int, device=None) -> torch.Tensor:
    """Implicit positions 0..S-1 for B rows: (B, S), or (3, B, S) under
    mrope (a text-only sequence: every stream alike)."""
    lead = (3,) if cfg.rope == "mrope" else ()
    return torch.arange(S, device=device).expand(*lead, B, S)


def backbone_forward(params, cfg, batch: dict, collect_taps: bool = False,
                     return_inputs: bool = False, ops=None):
    """Returns (final_hidden (B,S,d), taps (n_p,B,S,d) | None), or
    ``(final, taps, x0, positions)`` with ``return_inputs=True`` (so the
    PAC+ steps get ``b0`` without a second embedding lookup).

    Each period's output passes through ``ops.emit_tap`` where it is
    tapped: under the ``cuda`` OpSet with an int8 tap policy the stacked
    taps are one :class:`QTensor` (payload and scales both stacked over
    periods), with bf16 a bf16 tensor — already the cache's storage form.
    """
    ops = ops if ops is not None else _REF_OPS
    x0, positions = embed_inputs(params, cfg, batch, ops=ops)
    x, taps = run_periods(params["blocks"], cfg, x0, positions, ops=ops,
                          collect_taps=collect_taps)
    if return_inputs:
        return x, taps, x0, positions
    return x, taps


def run_periods(blocks, cfg, x, positions, ops=None, collect_taps: bool = False,
                active=None):
    """``x`` through every period of ``blocks`` (leaves stacked over a
    range of periods, e.g. one pipeline stage's). Returns (hidden, the
    period outputs through ``ops.emit_tap`` stacked over periods, or
    None). ``active`` (one bool a period) runs the False periods as
    identity: the padding of a ragged stage's slab, whose tap slot
    repeats the carry."""
    ops = ops if ops is not None else _REF_OPS
    n = tree_leaves(blocks)[0].shape[0]
    taps = []
    for i in range(n):
        if active is None or active[i]:
            for spec, p in zip(cfg.pattern, period_slice(blocks, i)):
                x = apply_block(p, x, cfg, spec, positions, ops=ops)
        if collect_taps:
            taps.append(ops.emit_tap(x))
    return x, (stack(taps) if collect_taps else None)


def stage_params(params, cfg, blocks, *, first: bool, loss: bool) -> dict:
    """What one pipeline stage keeps of ``params``: ``blocks`` (its
    periods), the embedding on the first stage, and the final norm and
    LM head where the loss runs."""
    out = {"blocks": blocks}
    if first or (loss and cfg.tie_embeddings):
        out["embed"] = params["embed"]
    if loss:
        out["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            out["lm_head"] = params["lm_head"]
    return out


def head_weight(params, cfg):
    """The (d, vocab) LM-head matrix, dequantized (a plain matmul follows,
    as in the reference, which computes the head outside any kernel)."""
    if cfg.tie_embeddings:
        return maybe_dequantize_tree(params["embed"]).T
    return maybe_dequantize_tree(params["lm_head"])


#: id(head leaf) -> (a weak reference to the leaf, its contiguous (d, V) f32 head)
_LOSS_HEADS: dict = {}


def loss_head(params, cfg) -> torch.Tensor:
    """:func:`head_weight` as one contiguous (d, V) tensor, made once for
    the life of the head's leaf (``lm_head``, or ``embed`` when tied) and
    reused by every later step that holds the same leaf: the frozen head
    of a session is dequantized, and a tied head transposed into place,
    once rather than each step (at gemma2-2b's V = 256000 that is 2.36 GB
    written a step). The values and dtype are :func:`head_weight`'s: f32
    for a quantized or f32 backbone, bf16 for a bf16 one (gemma2-2b's
    tied head then a 1.18 GB bf16 copy, which the CE kernels read
    whole)."""
    leaf = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    key = id(leaf)
    hit = _LOSS_HEADS.get(key)
    if hit is not None and hit[0]() is leaf:
        return hit[1]
    w = head_weight(params, cfg).contiguous()
    _LOSS_HEADS[key] = (weakref.ref(leaf, lambda _, k=key: _LOSS_HEADS.pop(k, None)), w)
    return w


def logits_from_hidden(params, cfg, h):
    p_norm = maybe_dequantize_tree(params["final_norm"])
    h = rms_norm(h, p_norm, cfg.norm_eps)
    logits = promoted_matmul(h, head_weight(params, cfg))
    return softcap(logits, cfg.logit_softcap)


def backbone_logits(params, cfg, batch: dict):
    h, _ = backbone_forward(params, cfg, batch)
    return logits_from_hidden(params, cfg, h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -100):
    """Mean CE over non-ignored positions. logits (B,S,V), labels (B,S)."""
    num, den = cross_entropy_parts(logits, labels, ignore)
    return num / torch.clamp_min(den, 1)


def cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -100):
    """(summed NLL, valid-token count) — the pieces of the mean CE. The
    label's log-probability is gathered (the reference contracts with a
    one-hot for vocab sharding; the sum it takes is the same value)."""
    mask = labels != ignore
    lab = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


# ---------------------------------------------------------------------------
# Decode against a linear cache
# ---------------------------------------------------------------------------


def init_cache(cfg, B: int, max_len: int, dtype=torch.float32, device=None, kv_quant=None):
    """Decode cache: one entry per pattern position, leaves stacked over
    periods. Attention: linear K/V (n_p, B, max_len, Hkv, hd);
    ``kv_quant=8`` stores them as int8 with f32 ``k_scale``/``v_scale``
    (n_p, B, max_len, Hkv), one per (token, kv head), as the reference
    does. SSM kinds: their recurrent state (n_p, B, ...)."""
    caches = []
    for spec in cfg.pattern:
        if spec.kind != "attn":
            caches.append(ssm.init_state(cfg, spec.kind, B, dtype, device, lead=cfg.n_periods))
            continue
        shape = (cfg.n_periods, B, max_len, cfg.n_kv_heads, cfg.hd)
        if kv_quant == 8:
            caches.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            })
        elif kv_quant is None:
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
        else:
            raise ValueError(f"kv_quant must be 8 or None, got {kv_quant!r}")
    return caches


def apply_block_decode(p, x, cfg, spec, cache, pos, ops=None):
    """One token through one block; ``cache`` is one period's entry,
    (B, ...) leaves, updated in place (INT8 K/V when it holds
    ``k_scale``; an SSM block's state written back); pos: (B,)."""
    ops = ops if ops is not None else _REF_OPS
    p = ops.prepare_block(p, spec)
    h = ops.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind != "attn":
        mix = ssm.decode_into(spec.kind, p["mixer"], h, cfg, cache)
    elif "k_scale" in cache:
        mix, cache = attention_decode_quant(p["mixer"], h, cfg, spec, cache, pos, ops=ops)
    else:
        mix, ck, cv = attention_decode(p["mixer"], h, cfg, spec, cache["k"], cache["v"], pos,
                                       ops=ops)
        cache = {"k": ck, "v": cv}
    x = x + mix
    if "ffn" in p:
        h = ops.rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe and cfg.moe is not None:
            # decode: T = B tokens; capacity widened, as the reference does,
            # so that drops are rare
            x = x + moe_forward(p["ffn"], h, cfg.moe,
                                capacity_factor=2.0 * cfg.moe.capacity_factor)
        else:
            x = x + mlp_forward(p["ffn"], h, ops=ops)
    return x, cache


def decode_periods(params, cfg, x, cache, pos, ops=None):
    """``x`` (B,1,d) through every period against the linear cache
    (written in place at ``pos``). Returns (final hidden, the hidden
    state after each period: the PAC+ taps)."""
    taps = []
    for i in range(cfg.n_periods):
        for j, (spec, p) in enumerate(zip(cfg.pattern, period_slice(params["blocks"], i))):
            entry = {name: t[i] for name, t in cache[j].items()}
            x, _ = apply_block_decode(p, x, cfg, spec, entry, pos, ops=ops)
        taps.append(x)
    return x, taps


def backbone_decode(params, cfg, token_batch: dict, cache, pos, ops=None):
    """One decode step. token_batch: {"tokens": (B,1)} or {"embeds":
    (B,1,d)}; pos: the index the new token is written at, an int or a
    (B,) tensor (per row). Returns (logits (B,1,V), cache) — the cache
    updated in place."""
    ops = ops if ops is not None else _REF_OPS
    if "embeds" in token_batch:
        x = token_batch["embeds"]
    else:
        x = ops.embed_lookup(params["embed"], token_batch["tokens"])
    pos = torch.as_tensor(pos, device=x.device).long().expand(x.shape[0])
    x, _ = decode_periods(params, cfg, x, cache, pos, ops=ops)
    return logits_from_hidden(params, cfg, x), cache
