"""Weight initialisation of the Parallel Adapters (paper §IV-C).

Counterpart of ``repro.core.init_methods``, its two initialisers:

* **Structural pruning** — the adapter inherits the backbone's top-norm
  channels (the L2 norm criterion): per-matrix row/column selection by
  importance, with W_down set to the channel-selection matrix, so the
  side network starts as a pruned functional copy of the backbone, and
  ``W_up`` zero, so the PAC+ model's first output equals the backbone's
  (the smooth start).
* **Knowledge distillation** — from the pruned (or a random) start with
  ``W_up`` redrawn, the side network alone is trained on public
  calibration batches to reproduce the frozen backbone's next-token
  distribution from its taps (the paper runs this in the cloud; no
  private data). The teacher's forward runs under ``torch.no_grad()``
  through the ``kernel_impl`` OpSet: ``"cuda"`` takes a quantized
  backbone's projections through ``quant_matmul`` and its attention
  through the flash kernel; the function is the same under ``"ref"``.

Every layer kind: attention and mLSTM blocks prune by heads, sLSTM
blocks by channels and head blocks, Mamba blocks by inner channels; an
MoE FFN is pruned from its experts' mean, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import adapter_config, adapter_forward, init_adapter
from repro_torch.core.quantization import QTensor, maybe_dequantize_tree
from repro_torch.core.steps import _update
from repro_torch.models.backbone import backbone_forward, logits_from_hidden
from repro_torch.optim import adamw_init


def _l2(w, dim):
    return torch.sqrt(torch.sum(torch.square(w), dim=dim))


def _topk_idx(importance: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the top-k channels, in ascending order (a stable layout;
    ties go to the lower index, as in the reference's stable argsort)."""
    k = min(k, importance.shape[0])
    return torch.sort(torch.argsort(-importance, stable=True)[:k]).values


def _dense(x):
    return maybe_dequantize_tree(x)


def channel_importance(backbone_params, cfg) -> torch.Tensor:
    """L2 importance of each d_model channel (norm criterion)."""
    imp = _l2(_dense(backbone_params["embed"]), dim=0)
    for pos in backbone_params["blocks"]:
        name = next(n for n in ("wq", "wz", "in_proj") if n in pos["mixer"])
        imp = imp + _l2(_dense(pos["mixer"][name]), dim=(0, 2))
    return imp


def _prune_rows_cols(w, row_idx=None, col_idx=None):
    w = _dense(w)
    if row_idx is not None:
        w = torch.index_select(w, w.ndim - 2, row_idx)
    if col_idx is not None:
        w = torch.index_select(w, w.ndim - 1, col_idx)
    return w


def _expert_mean_pruned(ffn, keep_d, n_ff: int):
    """The reference's MoE branch: each of ``wi``, ``wg``, ``wo`` averaged
    over its experts, then pruned to ``keep_d`` and the ``n_ff`` d_e
    channels whose mean ``wi`` columns have the top L2 norm over periods
    and rows. Each period is dequantized and averaged on its own (twice:
    once for the norms, once to prune), so no (n_p, d, d_e) f32 mean and
    no whole stacked expert leaf is ever resident (mixtral's ``wi`` alone
    is 60 GB in f32)."""
    n_p = ffn["wi"].shape[0]

    def mean(name, i):
        return torch.mean(_dense(ffn[name][i]), dim=0)

    sq = sum(torch.sum(torch.square(mean("wi", i)), dim=0) for i in range(n_p))
    keep_ff = _topk_idx(torch.sqrt(sq), n_ff)
    out = {}
    for name, rows, cols in (("wi", keep_d, keep_ff), ("wg", keep_d, keep_ff),
                             ("wo", keep_ff, keep_d)):
        out[name] = torch.stack([_prune_rows_cols(mean(name, i), rows, cols)
                                 for i in range(n_p)])
    return out


def _prune_heads(w, keep_d, n_heads, hd, n_heads_a, hd_a, transpose=False):
    """(n_p, d, H·hd) -> (n_p, d_a, H_a·hd_a) by head and width norm selection."""
    w = _dense(w)
    if transpose:
        w = w.transpose(-1, -2)
    n_p, d, _ = w.shape
    w = w.reshape(n_p, d, n_heads, hd)
    heads = _topk_idx(_l2(w, dim=(0, 1, 3)), min(n_heads_a, n_heads))
    w = torch.index_select(w, 2, heads)
    if n_heads_a > n_heads:  # adapter wider than its source: zero heads
        w = torch.nn.functional.pad(w, (0, 0, 0, n_heads_a - n_heads))
    dims = _topk_idx(_l2(w, dim=(0, 1, 2)), min(hd_a, hd))
    w = torch.index_select(w, 3, dims)
    if hd_a > hd:
        w = torch.nn.functional.pad(w, (0, hd_a - hd))
    w = torch.index_select(w, 1, keep_d).reshape(n_p, keep_d.shape[0], n_heads_a * hd_a)
    if transpose:
        w = w.transpose(-1, -2)
    return w.contiguous()


def _prune_attention_like(sm, dm, cfg, acfg, keep_d, grouped: bool) -> None:
    """Attention (``grouped``: K/V over the kv heads) or mLSTM mixers:
    q/k/v/o by head and width norm; an mLSTM's output gate like q, its
    gate columns (and ``f_bias``) by the top-norm heads of ``wi``."""
    H, hd, Ha, hda = cfg.n_heads, cfg.hd, acfg.n_heads, acfg.hd
    for nm in ("wq", "wk", "wv"):
        kv = grouped and nm in ("wk", "wv")
        dm[nm] = _prune_heads(sm[nm], keep_d, cfg.n_kv_heads if kv else H, hd,
                              acfg.n_kv_heads if kv else Ha, hda)
    dm["wo"] = _prune_heads(sm["wo"], keep_d, H, hd, Ha, hda, transpose=True)
    if grouped:
        return
    dm["ogate"] = _prune_heads(sm["ogate"], keep_d, H, hd, Ha, hda)
    gate_heads = _topk_idx(_l2(_dense(sm["wi"]), dim=(0, 1)), Ha)
    dm["wi"] = _prune_rows_cols(sm["wi"], keep_d, gate_heads)
    dm["wf"] = _prune_rows_cols(sm["wf"], keep_d, gate_heads)
    dm["f_bias"] = torch.index_select(_dense(sm["f_bias"]), -1, gate_heads)


def _prune_slstm(sm, dm, acfg, keep_d) -> None:
    """sLSTM: every d x d matrix and ``f_bias`` at the kept channels; each
    block-diagonal recurrence keeps its first adapter-width head blocks."""
    for nm in ("wz", "wi", "wf", "wog", "wo"):
        dm[nm] = _prune_rows_cols(sm[nm], keep_d, keep_d)
    dm["f_bias"] = torch.index_select(_dense(sm["f_bias"]), -1, keep_d)
    Ha = acfg.n_heads
    hda = acfg.d_model // Ha
    for nm in ("rz", "ri", "rf"):
        dm[nm] = _dense(sm[nm])[:, :Ha, :hda, :hda].contiguous()


def _prune_mamba(sm, dm, cfg, acfg, keep_d) -> None:
    """Mamba: the inner channels (x and gate halves of ``in_proj`` apart)
    by the L2 norm of their ``in_proj`` columns, every inner-dim leaf at
    those; the first adapter-width state and ``dt`` ranks."""
    di, di_a, ds = cfg.d_inner, acfg.d_inner, acfg.ssm_d_state
    imp = _l2(_dense(sm["in_proj"]), dim=(0, 1))
    keep_x = _topk_idx(imp[:di], di_a)
    keep_z = _topk_idx(imp[di:], di_a) + di
    dm["in_proj"] = _prune_rows_cols(sm["in_proj"], keep_d, torch.cat([keep_x, keep_z]))
    for nm in ("conv_w", "conv_b", "dt_bias", "d_skip"):
        dm[nm] = torch.index_select(_dense(sm[nm]), -1, keep_x)
    bc = _prune_rows_cols(sm["w_bc"], keep_x)
    dm["w_bc"] = torch.cat([bc[..., :ds], bc[..., cfg.ssm_d_state:cfg.ssm_d_state + ds]], dim=-1)
    rk = dm["w_dt1"].shape[-1]
    dm["w_dt1"] = _prune_rows_cols(sm["w_dt1"], keep_x)[..., :rk].contiguous()
    dm["w_dt2"] = _prune_rows_cols(sm["w_dt2"], None, keep_x)[..., :rk, :].contiguous()
    dm["a_log"] = torch.index_select(_dense(sm["a_log"]), -2, keep_x)[..., :ds].contiguous()
    dm["out_proj"] = _prune_rows_cols(sm["out_proj"], keep_x, keep_d)


@torch.no_grad()
def pruning_init(gen: torch.Generator, backbone_params, cfg, r: int = 8, *, device=None,
                 dtype=torch.float32) -> dict:
    """Adapter params initialised from the backbone's top-norm channels.
    QTensor leaves are dequantized first."""
    acfg = adapter_config(cfg, r)
    params = init_adapter(gen, cfg, r, device=device, dtype=dtype)  # layout template
    d_a = acfg.d_model
    keep_d = _topk_idx(channel_importance(backbone_params, cfg), d_a).to(params["downs"].device)

    sel = torch.zeros((cfg.d_model, d_a), dtype=dtype, device=params["downs"].device)
    sel[keep_d, torch.arange(d_a, device=sel.device)] = 1.0
    params["downs"] = sel.expand(params["downs"].shape).contiguous()
    params["up"] = torch.zeros_like(params["up"])

    for pos_i, spec in enumerate(cfg.pattern):
        src, dst = backbone_params["blocks"][pos_i], params["blocks"][pos_i]
        dst["ln1"] = torch.index_select(_dense(src["ln1"]), -1, keep_d)
        if "ln2" in dst and "ln2" in src:
            dst["ln2"] = torch.index_select(_dense(src["ln2"]), -1, keep_d)
        sm, dm = src["mixer"], dst["mixer"]
        if spec.kind in ("attn", "mlstm"):
            _prune_attention_like(sm, dm, cfg, acfg, keep_d, grouped=spec.kind == "attn")
        elif spec.kind == "slstm":
            _prune_slstm(sm, dm, acfg, keep_d)
        elif spec.kind == "mamba":
            _prune_mamba(sm, dm, cfg, acfg, keep_d)
        else:
            raise ValueError(f"unknown layer kind {spec.kind!r}")
        if "ffn" in dst and spec.moe and cfg.moe is not None:
            dst["ffn"] = _expert_mean_pruned(src["ffn"], keep_d, dst["ffn"]["wi"].shape[-1])
        elif "ffn" in dst:
            wi, wg, wo = (_dense(src["ffn"][n]) for n in ("wi", "wg", "wo"))
            keep_ff = _topk_idx(_l2(wi, dim=(0, 1)), dst["ffn"]["wi"].shape[-1])
            dst["ffn"]["wi"] = _prune_rows_cols(wi, keep_d, keep_ff)
            dst["ffn"]["wg"] = _prune_rows_cols(wg, keep_d, keep_ff)
            dst["ffn"]["wo"] = _prune_rows_cols(wo, keep_ff, keep_d)
    return params


# ---------------------------------------------------------------------------
# Knowledge-distillation init
# ---------------------------------------------------------------------------


def distillation_init(gen: torch.Generator, backbone_params, cfg, calib_batches, r: int = 8,
                      steps: int = 50, lr: float = 1e-3, from_pruning: bool = True, *,
                      kernel_impl: str = "ref") -> dict:
    """Train the side network to mimic the frozen backbone's predictions.

    calib_batches: {"tokens": (B,S)} (or {"embeds"}) public-data batches,
    cycled over ``steps`` AdamW steps (no clipping, as in the reference).
    The student's logits come from the adapter path alone,
    ``lm_head(W_up a_L)``, against the teacher's ``lm_head(b_final)``, so
    the side network becomes a functional mini-replica of the backbone.
    The start is :func:`pruning_init` (or a random adapter) with ``W_up``
    redrawn N(0, 1)·d_a^-0.5 from ``gen``, which lives on the backbone's
    device, where the adapter is made."""
    embed = backbone_params["embed"]
    device = (embed.q if isinstance(embed, QTensor) else embed).device
    if from_pruning:
        adapter = pruning_init(gen, backbone_params, cfg, r, device=device)
    else:
        adapter = init_adapter(gen, cfg, r, device=device)
    # distillation needs a non-zero output path: break W_up's symmetry
    up = adapter["up"]
    adapter["up"] = (torch.randn(up.shape, generator=gen, device=up.device) *
                     up.shape[0] ** -0.5).to(up.dtype)
    adapter, _ = _distill(adapter, backbone_params, cfg, calib_batches, r=r, steps=steps, lr=lr,
                         kernel_impl=kernel_impl)
    return adapter


def _distill(adapter, backbone_params, cfg, calib_batches, *, r: int = 8, steps: int = 50,
            lr: float = 1e-3, kernel_impl: str = "ref"):
    """:func:`distillation_init`'s loop from a given start ``adapter``.

    Each step: the teacher's frozen forward and softmax under no grad,
    then the cross-entropy of the student's log-softmax against it (the
    KL up to the teacher's entropy, which has no gradient), all in f32,
    and one unclipped AdamW update. Returns (adapter', the per-step
    losses as device tensors, each taken before its update)."""
    ops = get_opset(kernel_impl, "f32")
    batches = list(calib_batches)
    opt = adamw_init(adapter)
    losses = []
    for i in range(steps):
        batch = batches[i % len(batches)]
        with torch.no_grad():
            b_final, taps, x, positions = backbone_forward(
                backbone_params, cfg, batch, collect_taps=True, return_inputs=True, ops=ops)
            teacher = torch.softmax(logits_from_hidden(backbone_params, cfg, b_final).float(),
                                    dim=-1)

        def kl_loss(ap):
            side = adapter_forward(ap, cfg, x, taps, positions, r)
            ls = torch.log_softmax(logits_from_hidden(backbone_params, cfg, side).float(),
                                   dim=-1)
            return -torch.mean(torch.sum(teacher * ls, dim=-1))

        loss, adapter, opt = _update(kl_loss, adapter, opt, lr, None)
        losses.append(loss)
    return adapter, losses
