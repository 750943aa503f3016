"""State-space / recurrent sequence mixers: Mamba (S6), xLSTM mLSTM and sLSTM.

Counterpart of ``repro.models.ssm``:

* **Mamba** runs the selective scan as a loop over time steps in chunks
  of 128, with a depthwise causal conv in front.
* **mLSTM** is the stabilised chunkwise-parallel form: quadratic within
  a chunk, recurrent across chunks with a (C, n, m) matrix-memory carry;
  padded steps of the last chunk get the log input gate ``-1e30``, so
  they add nothing.
* **sLSTM** is sequential (the gates read h), in chunks of 64, with
  per-head block-diagonal recurrent weights.

Each mixer has ``*_forward`` (a whole sequence) and ``*_decode`` (one
step against an explicit state cache); the caches are returned new, as
in the reference, and the backbone writes them back into place. The
casts to f32 are the reference's: the scan carries, ``b_t``, ``c_t``,
``dt`` and the gates. Where autograd runs through a mixer (an adapter's
SSM blocks in training, a baseline's backbone), each chunk runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint``: the
backward recomputes a chunk's states instead of keeping them all.

No mixer runs in a kernel, in either package: the reference's Pallas
OpSet dequantizes an SSM block's mixer and runs it dense.

Every weight may carry a leading request axis (``rows`` of
``core/parallel_adapters``): matrices (B, d_in, d_out), vectors
(B, 1, n), ``conv_w`` (B, dc, di), ``a_log`` (B, di, ds) and the sLSTM
recurrences (B, H, hd, hd), so that a batch of B requests runs B
different adapters' mixers at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantization import QTensor

_NEG = -1e30


def _grad_flows(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _chunked(fn, carry: tuple, xs: tuple, *params):
    """``fn(*carry, *xs, *params) -> (*carry', ys)``, checkpointed when
    autograd runs through it."""
    if _grad_flows(*carry, *xs, *params):
        return checkpoint(fn, *carry, *xs, *params, use_reentrant=False)
    return fn(*carry, *xs, *params)


def _vec(v: torch.Tensor, n: int) -> torch.Tensor:
    """A gain or bias, (n,) or a request row's (B, 1, n), as (1, n) or
    (B, n): the shape that broadcasts against one step's (B, n)."""
    return v.reshape(-1, n)


# ---------------------------------------------------------------------------
# Mamba (S6)
# ---------------------------------------------------------------------------


def init_mamba(leaf, cfg) -> dict:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    dt_rank = max(1, d // 16)
    return {
        "in_proj": leaf.normal((d, 2 * di), d ** -0.5),
        "conv_w": leaf.normal((dc, di), dc ** -0.5),
        "conv_b": leaf.zeros((di,)),
        "w_bc": leaf.normal((di, 2 * ds), di ** -0.5),
        "w_dt1": leaf.normal((di, dt_rank), di ** -0.5),
        "w_dt2": leaf.normal((dt_rank, di), dt_rank ** -0.5),
        "dt_bias": leaf.full((di,), -4.6),  # softplus^-1(0.01)
        "a_log": leaf.full((di, ds), torch.log(torch.arange(1, ds + 1, dtype=torch.float32)),
                           torch.float32),
        "d_skip": leaf.full((di,), 1.0),
        "out_proj": leaf.normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,di); w: (dc,di) (or (B,dc,di))."""
    dc, S = w.shape[-2], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    w = w.unsqueeze(-3)  # (1, dc, di) or (B, 1, dc, di): tap i broadcasts over (B, S, di)
    out = sum(xp[:, i:i + S, :] * w[..., i, :] for i in range(dc))
    return out + b


def _mamba_chunk(h, xs, dt, b_t, c_t, a):
    """The sequential scan over one chunk. h: (B,di,ds); xs, dt: (B,c,di);
    b_t, c_t: (B,c,ds); a: (di,ds) or (B,di,ds). Returns (h', ys (B,c,di))."""
    ys = []
    for t in range(xs.shape[1]):
        dt_t = dt[:, t]
        da = torch.exp(dt_t[..., None] * a)
        h = h * da + (dt_t * xs[:, t])[..., None] * b_t[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_t[:, t]))
    return h, torch.stack(ys, 1)


def mamba_forward(p, x: torch.Tensor, cfg, chunk: int = 128, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d). The scan runs in chunks of ``chunk``
    steps; the reference pads the last chunk with zero steps, which feed
    no output, so here the last chunk runs its real steps only.
    ``return_state`` also returns the decode cache after the last step
    (:func:`init_mamba_cache`'s layout), which the reference does not."""
    B, S, d = x.shape
    di, ds = cfg.d_inner, cfg.ssm_d_state
    xz = x @ p["in_proj"]
    xin, res = xz.split(di, dim=-1)
    xs = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"]))  # (B,S,di)
    bc = (xs @ p["w_bc"]).float()
    b_t, c_t = bc.split(ds, dim=-1)  # (B,S,ds)
    dt = F.softplus((xs @ p["w_dt1"]) @ p["w_dt2"] + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"])
    xs32 = xs.float()
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        h, y = _chunked(_mamba_chunk, (h,), (xs32[:, sl], dt[:, sl], b_t[:, sl], c_t[:, sl]), a)
        ys.append(y)
    y = torch.cat(ys, 1) + xs32 * p["d_skip"]
    y = (y * F.silu(res.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    dc = cfg.ssm_d_conv
    return out, {"h": h, "conv": F.pad(xin, (0, 0, dc - 1, 0))[:, -(dc - 1):]}


def init_mamba_cache(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    return {
        "h": torch.zeros((B, cfg.d_inner, cfg.ssm_d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.ssm_d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }


def mamba_decode(p, x: torch.Tensor, cfg, cache):
    """x: (B,1,d); cache: {"h": (B,di,ds), "conv": (B,dc-1,di)}.
    Returns (out (B,1,d), the new cache)."""
    di, ds = cfg.d_inner, cfg.ssm_d_state
    xz = x @ p["in_proj"]
    xs, res = xz.split(di, dim=-1)  # (B,1,di)
    conv_in = torch.cat([cache["conv"], xs], dim=1)  # (B,dc,di)
    xc = F.silu(torch.sum(conv_in * p["conv_w"], dim=1, keepdim=True) + p["conv_b"])
    bc = (xc @ p["w_bc"]).float()
    b_t, c_t = bc[:, 0].split(ds, dim=-1)  # (B,ds)
    dt = F.softplus((xc @ p["w_dt1"]) @ p["w_dt2"] + p["dt_bias"]).float()[:, 0]  # (B,di)
    a = -torch.exp(p["a_log"])
    xc32 = xc.float()
    h = cache["h"] * torch.exp(dt[..., None] * a) + (dt * xc32[:, 0])[..., None] * b_t[:, None, :]
    y = torch.einsum("bds,bs->bd", h, c_t)[:, None] + xc32 * p["d_skip"]
    y = (y * F.silu(res.float())).to(x.dtype)
    return y @ p["out_proj"], {"h": h, "conv": conv_in[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory): chunkwise parallel
# ---------------------------------------------------------------------------


def init_mlstm(leaf, cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    s = d ** -0.5
    p = {
        "wq": leaf.normal((d, H * hd), s),
        "wk": leaf.normal((d, H * hd), s),
        "wv": leaf.normal((d, H * hd), s),
        "wi": leaf.normal((d, H), s, dtype=torch.float32),
        "wf": leaf.normal((d, H), s, dtype=torch.float32),
        "f_bias": leaf.full((H,), 3.0, torch.float32),  # bias toward remembering
        "wo": leaf.normal((H * hd, d), s),
    }
    # the reference draws the output gate from wq's key: it starts equal to wq
    wq = p["wq"]
    p["ogate"] = (QTensor(wq.q.clone(), wq.scale.clone(), wq.bits, wq.block, wq.orig_last)
                  if isinstance(wq, QTensor) else wq.clone())
    return p


def _mlstm_chunk(C, n, m, q, k, v, lf, li):
    """One chunk of the stabilised chunkwise mLSTM.

    carry: C (B,H,hd,hd), n (B,H,hd), m (B,H); q, k, v (c,B,H,hd); lf,
    li (c,B,H) log gates. Returns (C', n', m', h (c,B,H,hd))."""
    c, hd = q.shape[0], q.shape[-1]
    scale = hd ** -0.5
    Fc = torch.cumsum(lf, dim=0)  # F_t = sum_{s<=t} lf_s
    Ftot = Fc[-1]
    # A[i,j] = F_i - F_j + li_j: the weight of step j's write at step i, j <= i
    Aij = Fc[:, None] - Fc[None, :] + li[None, :]  # (c,c,B,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    Aij = torch.where(tri[:, :, None, None], Aij, torch.full_like(Aij, -math.inf))
    carry_scale = Fc + m[None]  # (c,B,H)
    M = torch.clamp_min(torch.maximum(torch.amax(Aij, dim=1), carry_scale), _NEG)
    D = torch.exp(Aij - M[:, None])
    S = torch.einsum("ibhd,jbhd->ijbh", q, k) * scale * D
    num_intra = torch.einsum("ijbh,jbhd->ibhd", S, v)
    den_intra = torch.sum(S, dim=1)  # (c,B,H)
    carry_w = torch.exp(carry_scale - M)
    num_carry = torch.einsum("ibhd,bhde->ibhe", q, C) * scale * carry_w[..., None]
    den_carry = torch.einsum("ibhd,bhd->ibh", q, n) * scale * carry_w
    num = num_intra + num_carry
    den = den_intra + den_carry
    h = num / torch.maximum(torch.abs(den), torch.exp(-M))[..., None]
    # the carry at the chunk's end
    m_new = torch.maximum(Ftot + m, torch.amax(Ftot[None] - Fc + li, dim=0))
    w_old = torch.exp(Ftot + m - m_new)  # (B,H)
    w_j = torch.exp(Ftot[None] - Fc + li - m_new[None])  # (c,B,H)
    C_new = C * w_old[..., None, None] + torch.einsum("jbhd,jbhe->bhde", k * w_j[..., None], v)
    n_new = n * w_old[..., None] + torch.einsum("jbhd,jbh->bhd", k, w_j)
    return C_new, n_new, m_new, h


def mlstm_forward(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d). Chunkwise-parallel stabilised mLSTM."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    chunk = min(cfg.mlstm_chunk, S)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, H, hd)
    v = (x @ p["wv"]).reshape(B, S, H, hd)
    og = torch.sigmoid((x @ p["ogate"]).reshape(B, S, H, hd))
    x32 = x.float()
    li = x32 @ p["wi"]  # log input gate (pre-exp), (B,S,H)
    lf = F.logsigmoid(x32 @ p["wf"] + p["f_bias"])

    nc = max(1, -(-S // chunk))
    pad = nc * chunk - S

    def prep(t, fill=0.0):  # (B,S,...) -> (nc, chunk, B, ...)
        if pad:
            t = torch.cat([t, t.new_full((B, pad) + t.shape[2:], fill)], dim=1)
        return t.reshape((B, nc, chunk) + t.shape[2:]).movedim(0, 2)

    qs, ks, vs = prep(q.float()), prep(k.float()), prep(v.float())
    lis = prep(li, fill=_NEG)  # padded steps contribute nothing
    lfs = prep(lf)
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    # m is the log scale of the (zero) initial carry; 0 keeps a padded
    # chunk's arithmetic finite (never -inf - -inf)
    m = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    hs = []
    for i in range(nc):
        C, n, m, h = _chunked(_mlstm_chunk, (C, n, m), (qs[i], ks[i], vs[i], lfs[i], lis[i]))
        hs.append(h)
    h = torch.cat(hs, 0).movedim(1, 0)[:, :S]  # (B,S,H,hd)
    h = (h.to(x.dtype) * og).reshape(B, S, H * hd)
    return h @ p["wo"]


def init_mlstm_cache(cfg, B: int, device=None) -> dict:
    H, hd = cfg.n_heads, cfg.hd
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, hd, hd), **z), "n": torch.zeros((B, H, hd), **z),
            "m": torch.zeros((B, H), **z)}


def mlstm_decode(p, x: torch.Tensor, cfg, cache):
    """Single-step recurrent mLSTM. x: (B,1,d). Returns (out (B,1,d),
    the new cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, H, hd).float()
    k = (x @ p["wk"]).reshape(B, H, hd).float()
    v = (x @ p["wv"]).reshape(B, H, hd).float()
    og = torch.sigmoid((x @ p["ogate"]).reshape(B, H, hd))
    x32 = x.float()
    li = (x32 @ p["wi"]).reshape(B, H)
    lf = F.logsigmoid(x32 @ p["wf"] + p["f_bias"]).reshape(B, H)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m, li)
    wf = torch.exp(lf + m - m_new)
    wi = torch.exp(li - m_new)
    C = C * wf[..., None, None] + wi[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = n * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C) * (hd ** -0.5)
    den = torch.einsum("bhd,bhd->bh", q, n) * (hd ** -0.5)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h = (h.to(x.dtype) * og).reshape(B, 1, H * hd)
    return h @ p["wo"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory): sequential, block-diagonal recurrence
# ---------------------------------------------------------------------------


def init_slstm(leaf, cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    s = d ** -0.5
    f32 = torch.float32
    return {
        "wz": leaf.normal((d, d), s),
        "wi": leaf.normal((d, d), s, dtype=f32),
        "wf": leaf.normal((d, d), s, dtype=f32),
        "wog": leaf.normal((d, d), s),
        # block-diagonal recurrent weights, one (hd, hd) block per head
        "rz": leaf.normal((H, hd, hd), hd ** -0.5, dtype=f32),
        "ri": leaf.zeros((H, hd, hd), f32),
        "rf": leaf.zeros((H, hd, hd), f32),
        "f_bias": leaf.full((d,), 3.0, f32),
        "wo": leaf.normal((d, d), s),
    }


def _slstm_step(c, n, h, m, xz, xi, xf, xo, r, f_bias):
    """One step. c, n, h, m: (B,d) f32; x*: the pre-projected gates
    (B,d); r: the recurrences [rz | ri | rf] side by side, (H,hd,3·hd)
    (or (B,H,hd,3·hd)); f_bias (1,d) or (B,d)."""
    B, d = h.shape
    H = r.shape[-3]
    hd = d // H
    rz, ri, rf = (t.reshape(B, d) for t in (h.reshape(B, H, 1, hd) @ r).split(hd, dim=-1))
    z = torch.tanh(xz + rz)
    li = xi + ri
    lf = F.logsigmoid(xf + rf + f_bias)
    o = torch.sigmoid(xo)
    m_new = torch.maximum(lf + m, li)
    c = c * torch.exp(lf + m - m_new) + torch.exp(li - m_new) * z
    n = n * torch.exp(lf + m - m_new) + torch.exp(li - m_new)
    h_new = o * c / torch.clamp_min(n, 1e-6)
    return c, n, h_new, m_new


def _slstm_chunk(c, n, h, m, xz, xi, xf, xo, r, f_bias):
    """The steps of one chunk. x*: (B,c,d). Returns (c, n, h, m, hs (B,c,d))."""
    hs = []
    for t in range(xz.shape[1]):
        c, n, h, m = _slstm_step(c, n, h, m, xz[:, t], xi[:, t], xf[:, t], xo[:, t], r, f_bias)
        hs.append(h)
    return c, n, h, m, torch.stack(hs, 1)


def _slstm_gates(p, x):
    x32 = x.float()
    return ((x @ p["wz"]).float(), x32 @ p["wi"], x32 @ p["wf"], (x @ p["wog"]).float())


def _slstm_recurrence(p, d: int):
    """(the three recurrences in one matrix, f_bias as a step's row)."""
    return torch.cat([p["rz"], p["ri"], p["rf"]], dim=-1), _vec(p["f_bias"], d)


def slstm_forward(p, x: torch.Tensor, cfg, chunk: int = 64) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d). The steps run in chunks of ``chunk``; the
    reference's zero steps padding the last chunk feed no output, so the
    last chunk here runs its real steps only."""
    B, S, d = x.shape
    gates = _slstm_gates(p, x)
    rec = _slstm_recurrence(p, d)
    z = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    carry = (z, z, z, torch.full((B, d), _NEG, dtype=torch.float32, device=x.device))
    hs = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        *carry, h = _chunked(_slstm_chunk, tuple(carry), tuple(g[:, sl] for g in gates), *rec)
        hs.append(h)
    return torch.cat(hs, 1).to(x.dtype) @ p["wo"]


def init_slstm_cache(cfg, B: int, device=None) -> dict:
    d = cfg.d_model
    z = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, d), **z), "n": torch.zeros((B, d), **z),
            "h": torch.zeros((B, d), **z), "m": torch.full((B, d), _NEG, **z)}


def slstm_decode(p, x: torch.Tensor, cfg, cache):
    """x: (B,1,d). Returns (out (B,1,d), the new cache)."""
    d = x.shape[-1]
    gates = tuple(g[:, 0] for g in _slstm_gates(p, x))
    c, n, h, m = _slstm_step(cache["c"], cache["n"], cache["h"], cache["m"], *gates,
                             *_slstm_recurrence(p, d))
    out = (h.to(x.dtype)[:, None, :]) @ p["wo"]
    return out, {"c": c, "n": n, "h": h, "m": m}


#: per SSM kind: (init, forward, decode)
MIXERS = {
    "mamba": (init_mamba, mamba_forward, mamba_decode),
    "mlstm": (init_mlstm, mlstm_forward, mlstm_decode),
    "slstm": (init_slstm, slstm_forward, slstm_decode),
}


def decode_into(kind: str, p, x: torch.Tensor, cfg, state: dict) -> torch.Tensor:
    """One decode step of an SSM kind whose new state is written back into
    ``state`` (views of a cache or of an engine's state rows). Returns the
    mixer's output (B,1,d)."""
    out, new = MIXERS[kind][2](p, x, cfg, state)
    for name, t in new.items():
        state[name].copy_(t)
    return out


def init_state(cfg, kind: str, B: int, dtype=torch.float32, device=None, lead=None) -> dict:
    """A fresh decode state for ``B`` rows of an SSM kind; ``lead``
    (e.g. the period count) stacks that many copies in front."""
    if kind == "mamba":
        one = init_mamba_cache(cfg, B, dtype, device)
    elif kind == "mlstm":
        one = init_mlstm_cache(cfg, B, device)
    elif kind == "slstm":
        one = init_slstm_cache(cfg, B, device)
    else:
        raise ValueError(f"unknown SSM kind {kind!r}")
    if lead is None:
        return one
    return {k: t[None].repeat((lead,) + (1,) * t.ndim) for k, t in one.items()}
