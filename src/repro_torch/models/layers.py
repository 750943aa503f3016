"""Core transformer layers: norms, rotary embeddings, GQA attention, MLP.

Counterpart of ``repro.models.layers``. The ``ref`` OpSet's attention is
the reference's blocked online-softmax attention with its own backward
(:func:`flash_attention`): keys in blocks, and a backward that recomputes
each block's scores from the saved log-sum-exp, so neither pass keeps an
(S x S) score matrix. Shapes follow the reference:
activations (B, S, d), heads (B, S, H, hd). Every weight may carry a
leading request axis — ``x @ w`` with x (B, S, d_in) and w (B, d_in,
d_out) applies row b's own weight, and a norm gain (B, 1, d) broadcasts
per row — which is how the per-user adapters run B different side
networks in one batch (the reference ``vmap``s over requests instead).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


class LeafMaker:
    """Draws parameter leaves from one ``torch.Generator``.

    ``lead`` is prepended to every shape (the period-stacking axis);
    ``finish(t, name)`` maps each new leaf (e.g. quantizes it as soon as it
    is drawn, so a full f32 tree is never resident; ``name`` lets it skip
    leaves such as an MoE router)."""

    def __init__(self, gen: torch.Generator, *, device=None, dtype=torch.float32,
                 lead: tuple = (), finish=None):
        self.gen = gen
        self.device = device
        self.dtype = dtype
        self.lead = tuple(lead)
        self.finish = finish

    def _out(self, t, name: str = ""):
        return self.finish(t, name) if self.finish is not None else t

    def _draw(self, shape, std: float, name: str, dtype=None):
        t = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return self._out((t * std).to(dtype or self.dtype), name)

    def normal(self, shape, std: float, name: str = "", by_period: bool = False, dtype=None):
        """N(0, std²) of shape ``lead + shape`` (in ``dtype``, default the
        maker's). ``by_period`` draws and
        finishes one slice of the first lead axis at a time into the
        stacked leaf, so at most one slice is resident before ``finish``
        (an MoE expert leaf: ``finish`` quantizes along the last axis, so
        the codes are those of the stacked leaf quantized whole)."""
        if not (by_period and self.lead):
            return self._draw(self.lead + tuple(shape), std, name, dtype)
        from repro_torch.core.quantization import QTensor

        n, out = self.lead[0], None
        for i in range(n):
            t = self._draw(self.lead[1:] + tuple(shape), std, name)
            if out is None:
                if isinstance(t, QTensor):
                    out = QTensor(t.q.new_empty((n,) + tuple(t.q.shape)),
                                  t.scale.new_empty((n,) + tuple(t.scale.shape)),
                                  t.bits, t.block, t.orig_last)
                else:
                    out = t.new_empty((n,) + tuple(t.shape))
            if isinstance(t, QTensor):
                out.q[i], out.scale[i] = t.q, t.scale
            else:
                out[i] = t
            del t
        return out

    def zeros(self, shape, dtype=None):
        return self.full(shape, 0.0, dtype)

    def full(self, shape, value, dtype=None):
        """``value`` everywhere (a float, or a tensor broadcast to
        ``lead + shape``)."""
        t = torch.empty(self.lead + tuple(shape), device=self.device, dtype=dtype or self.dtype)
        return self._out(t.copy_(value) if isinstance(value, torch.Tensor) else t.fill_(value))


def init_attention(leaf: LeafMaker, cfg) -> dict:
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    return {
        "wq": leaf.normal((d, cfg.n_heads * hd), s),
        "wk": leaf.normal((d, cfg.n_kv_heads * hd), s),
        "wv": leaf.normal((d, cfg.n_kv_heads * hd), s),
        "wo": leaf.normal((cfg.n_heads * hd, d), s),
    }


def init_mlp(leaf: LeafMaker, d: int, d_ff: int) -> dict:
    return {
        "wi": leaf.normal((d, d_ff), d ** -0.5),
        "wg": leaf.normal((d, d_ff), d ** -0.5),
        "wo": leaf.normal((d_ff, d), d_ff ** -0.5),
    }


# ---------------------------------------------------------------------------
# Norms, softcap, rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Mean-and-variance norm over the last axis in f32 (the population
    variance, as ``jnp.var``), then ``x·weight + bias``, in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under JAX's type promotion, which the reference's ``@``
    follows: two float dtypes meet in the wider (a bf16 backbone tensor
    with an f32 adapter weight gives f32), where torch's ``@`` refuses
    mixed dtypes."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotate-half rope. x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1_000_000.0,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL multimodal rope. x: (B, S, H, hd); positions: (3, B, S)
    int, the temporal/height/width ids. The hd/2 frequency slots go to
    the three streams in the ratio ``sections`` (t:h:w), slot bounds
    ``half·acc // sum(sections)`` as in the reference (arXiv:2409.12191)."""
    if positions.ndim != 3 or positions.shape[0] != len(sections):
        raise ValueError(f"mrope takes ({len(sections)}, B, S) positions, got "
                         f"{tuple(positions.shape)}")
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)  # (half,)
    bounds = [half * sum(sections[:i + 1]) // sum(sections) for i in range(len(sections) - 1)]
    slot = torch.arange(half, device=x.device)
    stream = sum((slot >= b).long() for b in bounds)  # (half,) in 0..2
    # each frequency slot reads its stream's position: (B, S, half)
    pos_per_slot = positions.float().movedim(0, -1)[..., stream]
    angles = pos_per_slot * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def vision_positions(n_before: int, grid, n_after: int) -> torch.Tensor:
    """The (3, S) mrope position ids of one sequence laid out as Qwen2-VL
    lays a text-image-text prompt (arXiv:2409.12191 §2.1): ``n_before``
    text tokens with equal ids on the three streams, then an image of
    ``grid`` = (t, h, w) patches whose ids are the start offset plus the
    patch's (t, h, w) index, then ``n_after`` text tokens continuing from
    the largest id so far + 1 on every stream. S = n_before + t·h·w +
    n_after. What the vision frontend hands the backbone, stubbed here as
    in the reference."""
    t, h, w = grid
    before = torch.arange(n_before).expand(3, n_before)
    idx = torch.meshgrid(torch.arange(t), torch.arange(h), torch.arange(w), indexing="ij")
    image = torch.stack(idx).reshape(3, t * h * w) + n_before
    start = int(image.max()) + 1 if image.numel() else n_before
    after = (start + torch.arange(n_after)).expand(3, n_after)
    return torch.cat([before, image, after], dim=1)


def decode_positions(cfg, pos: torch.Tensor) -> torch.Tensor:
    """The rope positions of one decode token from the per-row write
    index ``pos`` (B,): (B, 1), or (3, B, 1) under mrope, every stream
    at ``pos`` (as the reference's decode paths broadcast it)."""
    pos = pos.long()[:, None]
    return pos.expand(3, *pos.shape) if cfg.rope == "mrope" else pos


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _project_qkv(p, x, cfg, positions, ops=None):
    B, S, _ = x.shape
    hd = cfg.hd
    mm = ops.matmul if ops is not None else (lambda a, w: a @ w)
    q = mm(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = mm(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = mm(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope == "rope":
        rope = ops.apply_rope if ops is not None else apply_rope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        mrope = ops.apply_mrope if ops is not None else apply_mrope
        q = mrope(q, positions, cfg.rope_theta)
        k = mrope(k, positions, cfg.rope_theta)
    return q, k, v


_PAD_POS = 2 ** 30  # the position of a padded key slot, which no query attends


def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """(Sq, blk) bool, True where a query attends a key: padded slots never,
    later keys not when ``causal``, keys ``window`` or more back not."""
    m = (k_pos[None, :] < _PAD_POS).expand(q_pos.shape[0], -1)
    d = q_pos[:, None] - k_pos[None, :]
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    return m


def _pad_keys(k, v, k_pos, block_k: int):
    """K, V and their positions padded to whole blocks of ``block_k`` (the
    padded slots at ``_PAD_POS``); returns them and the block count."""
    Sk = k.shape[2]
    nb = max(1, -(-Sk // block_k))
    pad = nb * block_k - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_PAD_POS)
    return k, v, k_pos, nb


def _block_scores(q, kj, scale: float, cap: Optional[float]):
    """(pre-cap scores, capped scores) of one key block, f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kj.float()) * scale
    return s, softcap(s, cap)


def _flash_fwd(q, k, v, q_pos, k_pos, causal, window, cap, block_k):
    """The online-softmax forward over key blocks: (o in q's dtype, lse
    f32 (B, H, Sq)). A query with no key gets V's mean, as in the
    reference (every masked score is the same -1e30)."""
    B, H, Sq, hd = q.shape
    scale = 1.0 / (hd ** 0.5)
    k, v, k_pos, nb = _pad_keys(k, v, k_pos, block_k)
    o = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for j in range(nb):
        blk = slice(j * block_k, (j + 1) * block_k)
        s = _block_scores(q, k[:, :, blk], scale, cap)[1]
        s = torch.where(_block_mask(q_pos, k_pos[blk], causal, window), s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, blk].float())
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def _flash_bwd(q, k, v, q_pos, k_pos, o, lse, do, causal, window, cap, block_k):
    """dq, dk, dv of :func:`_flash_fwd`, each key block's probabilities
    recomputed from ``lse`` (``ds = p·(dp − Σ dO·O)`` through the
    soft-cap's slope), in the inputs' dtypes."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = 1.0 / (hd ** 0.5)
    do_f = do.float()
    delta = (do_f * o.float()).sum(dim=-1)  # (B, H, Sq)
    k, v, k_pos, nb = _pad_keys(k, v, k_pos, block_k)
    q_f = q.float()
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(nb):
        blk = slice(j * block_k, (j + 1) * block_k)
        kj, vj = k[:, :, blk].float(), v[:, :, blk].float()
        s_pre, s = _block_scores(q, kj, scale, cap)
        mask = _block_mask(q_pos, k_pos[blk], causal, window)
        s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - lse[..., None])  # (B, H, Sq, blk)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do_f))
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", do_f, vj) - delta[..., None])
        if cap is not None:
            ds = ds * (1.0 - torch.square(torch.tanh(s_pre / cap)))
        ds = torch.where(mask, ds * scale, 0.0)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kj)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, q_f))
    dk = torch.cat(dks, dim=2)[:, :, :Sk]
    dv = torch.cat(dvs, dim=2)[:, :, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class BlockedAttention(torch.autograd.Function):
    """:func:`flash_attention` as an autograd Function: the forward keeps
    (q, k, v, o, lse) and the two position vectors, never a score block,
    and the backward recomputes each block's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, cap, block_k):
        o, lse = _flash_fwd(q, k, v, q_pos, k_pos, causal, window, cap, block_k)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.args = (causal, window, cap, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, q_pos, k_pos, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, causal: bool = True, window: Optional[int] = None,
                    attn_softcap: Optional[float] = None, block_k: int = 512) -> torch.Tensor:
    """Memory-bounded attention (the reference's ``flash_attention``).
    q: (B, H, Sq, hd); k, v: (B, H, Sk, hd), heads already matched (or
    grouped upstream); q_pos (Sq,), k_pos (Sk,) int. Keys run in blocks of
    ``block_k``; the backward saves (q, k, v, o, lse) and recomputes each
    block's scores. Returns (B, H, Sq, hd) in q's dtype."""
    return BlockedAttention.apply(q, k, v, q_pos, k_pos, causal, window, attn_softcap, block_k)


def ref_attention_core(q, k, v, cfg, spec, block_k: int = 1024) -> torch.Tensor:
    """Grouped-head causal attention on projected/rope'd q, k, v — the
    ``ref`` OpSet's attention, the reference's layout: the n_rep query
    heads that share a kv head are folded into the query-row axis (row
    ``r·S + s`` of kv head g is query head g·n_rep+r at position s), so
    K/V are never repeated, and :func:`flash_attention` runs over keys in
    blocks of ``min(block_k, S)``. q: (B,S,H,hd); k,v: (B,S,Hkv,hd) ->
    (B,S,H·hd)."""
    B, S, H, hd = q.shape
    hkv = cfg.n_kv_heads
    n_rep = H // hkv
    pos = torch.arange(S, device=q.device)
    qg = q.reshape(B, S, hkv, n_rep, hd).permute(0, 2, 3, 1, 4).reshape(B, hkv, n_rep * S, hd)
    o = flash_attention(qg, k.transpose(1, 2), v.transpose(1, 2), pos.repeat(n_rep), pos, True,
                        spec.window, cfg.attn_softcap, min(block_k, S))
    return o.reshape(B, hkv, n_rep, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)


def attention_forward(p, x, cfg, spec, positions, ops=None, return_kv: bool = False):
    """Full-sequence (prefill) attention. x: (B,S,d); positions: (B,S),
    or (3,B,S) under mrope.

    ``return_kv=True`` also returns the post-rope ``(k, v)`` pair
    ((B,S,Hkv,hd) each), which paged prefill scatters into the pages."""
    q, k, v = _project_qkv(p, x, cfg, positions, ops)
    if ops is not None:
        o = ops.attention(q, k, v, cfg, spec)
        out = ops.matmul(o, p["wo"])
    else:
        o = ref_attention_core(q, k, v, cfg, spec)
        out = o @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p, x, cfg, spec, cache_k, cache_v, pos, ops=None):
    """Single-token decode against a linear cache, per-row positions.

    x: (B,1,d); cache_[kv]: (B,Smax,Hkv,hd); pos: (B,) int — the slot
    row b's new token is written at (a scalar applies to every row).
    The caches are updated **in place** (the reference returns new
    arrays); they are also returned. Returns (out (B,1,d), cache_k, cache_v).
    """
    B = x.shape[0]
    Smax = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    q, k, v = _project_qkv(p, x, cfg, decode_positions(cfg, pos), ops)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.hd
    qh = q.reshape(B, cfg.n_kv_heads, n_rep, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qh.float(), cache_k.float()) * (hd ** -0.5)
    s = softcap(s, cfg.attn_softcap)
    kpos = torch.arange(Smax, device=x.device)
    valid = kpos[None, :] <= pos[:, None]
    if spec.window is not None:
        valid &= kpos[None, :] > pos[:, None] - spec.window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", w, cache_v.float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(x.dtype)
    out = ops.matmul(o, p["wo"]) if ops is not None else o @ p["wo"]
    return out, cache_k, cache_v


def quantize_kv_token(t: torch.Tensor):
    """Per-(B,1,Hkv) absmax INT8 quantization of one K/V token, bit for
    bit the reference's. t: (B, 1, Hkv, hd) -> (int8 same shape, f32
    scale (B, 1, Hkv))."""
    t = t.float()
    scale = torch.clamp_min(t.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attention_decode_quant(p, x, cfg, spec, cache, pos, ops=None):
    """Single-token decode against an INT8 linear KV cache, per-row
    positions (the paper's Eq. 1 absmax applied to the KV cache, one
    scale per (token, kv head)).

    cache: one period's ``{"k", "v"}`` int8 (B,Smax,Hkv,hd) and
    ``{"k_scale", "v_scale"}`` f32 (B,Smax,Hkv), updated **in place**
    at ``pos`` (B,). The scales are folded in after the score and value
    einsums, as in the reference, so the cache is read at int8 width.
    Returns (out (B,1,d), cache)."""
    B = x.shape[0]
    Smax = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    q, k, v = _project_qkv(p, x, cfg, decode_positions(cfg, pos), ops)
    rows = torch.arange(B, device=x.device)
    for name, t in (("k", k), ("v", v)):
        tq, ts = quantize_kv_token(t)
        cache[name][rows, pos] = tq[:, 0]
        cache[name + "_scale"][rows, pos] = ts[:, 0]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.hd
    qh = q.reshape(B, cfg.n_kv_heads, n_rep, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qh.float(), cache["k"].float()) * (hd ** -0.5)
    s = s * cache["k_scale"].transpose(1, 2)[:, :, None, :]  # fold K scales
    s = softcap(s, cfg.attn_softcap)
    kpos = torch.arange(Smax, device=x.device)
    valid = kpos[None, :] <= pos[:, None]
    if spec.window is not None:
        valid &= kpos[None, :] > pos[:, None] - spec.window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = w * cache["v_scale"].transpose(1, 2)[:, :, None, :]  # fold V scales
    o = torch.einsum("bgrs,bsgd->bgrd", w, cache["v"].float())
    o = o.reshape(B, 1, cfg.n_heads * hd).to(x.dtype)
    out = ops.matmul(o, p["wo"]) if ops is not None else o @ p["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# Gated MLP (llama-style)
# ---------------------------------------------------------------------------


def mlp_forward(p, x: torch.Tensor, ops=None) -> torch.Tensor:
    if ops is not None:
        mm = ops.matmul
        return mm(F.silu(mm(x, p["wg"])) * mm(x, p["wi"]), p["wo"])
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
