"""Weight initialisation of the Parallel Adapters (paper §IV-C).

Counterpart of ``repro.core.init_methods``: **structural pruning** — the
adapter inherits the backbone's top-norm channels (the L2 norm
criterion): per-matrix row/column selection by importance, with W_down
set to the channel-selection matrix, so the side network starts as a
pruned functional copy of the backbone, and ``W_up`` zero, so the PAC+
model's first output equals the backbone's (the smooth start).

Dense attention backbones only; the knowledge-distillation initialiser
arrives with a later slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.parallel_adapters import adapter_config, init_adapter
from repro_torch.core.quantization import maybe_dequantize_tree


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
        imp = imp + _l2(_dense(pos["mixer"]["wq"]), dim=(0, 2))
    return imp


def _prune_rows_cols(w, row_idx=None, col_idx=None):
    w = _dense(w)
    if row_idx is not None:
        w = torch.index_select(w, w.ndim - 2, row_idx)
    if col_idx is not None:
        w = torch.index_select(w, w.ndim - 1, col_idx)
    return w


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
        if spec.kind != "attn" or spec.moe:
            raise NotImplementedError(
                f"pruning_init covers dense attention blocks; kind {spec.kind!r} "
                f"(moe={spec.moe}) arrives with the SSM/MoE slice of the port")
        src, dst = backbone_params["blocks"][pos_i], params["blocks"][pos_i]
        dst["ln1"] = torch.index_select(_dense(src["ln1"]), -1, keep_d)
        if "ln2" in dst and "ln2" in src:
            dst["ln2"] = torch.index_select(_dense(src["ln2"]), -1, keep_d)
        sm, dm = src["mixer"], dst["mixer"]
        H, hd, Ha, hda = cfg.n_heads, cfg.hd, acfg.n_heads, acfg.hd
        for nm in ("wq", "wk", "wv"):
            kv = nm in ("wk", "wv")
            dm[nm] = _prune_heads(sm[nm], keep_d, cfg.n_kv_heads if kv else H, hd,
                                  acfg.n_kv_heads if kv else Ha, hda)
        dm["wo"] = _prune_heads(sm["wo"], keep_d, H, hd, Ha, hda, transpose=True)
        if "ffn" in dst:
            wi, wg, wo = (_dense(src["ffn"][n]) for n in ("wi", "wg", "wo"))
            keep_ff = _topk_idx(_l2(wi, dim=(0, 1)), dst["ffn"]["wi"].shape[-1])
            dst["ffn"]["wi"] = _prune_rows_cols(wi, keep_d, keep_ff)
            dst["ffn"]["wg"] = _prune_rows_cols(wg, keep_d, keep_ff)
            dst["ffn"]["wo"] = _prune_rows_cols(wo, keep_ff, keep_d)
    return params
