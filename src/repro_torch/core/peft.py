"""The baseline fine-tuning techniques the paper compares PAC+ against
(§II, §VI; counterpart of ``repro.core.peft``):

* **Full fine-tuning**: every backbone parameter trainable
  (``core/steps.py`` ``full_train_step``; nothing to initialise).
* **LoRA** (Hu et al.): a low-rank ΔW = A·B on W_q and W_v, A Gaussian,
  B zero (the start PAC+'s §IV-C analysis builds on). An mLSTM adapts
  its q and v, an sLSTM its ``wz``, a Mamba block its ``in_proj``, as in
  the reference.
* **Adapters** (Houlsby et al.): a bottleneck MLP after each layer, a
  residual around it.

LoRA and Adapters keep their trainable parts *inside* the backbone, so
the gradient backpropagates through the whole frozen model: the cost
PAC+ removes. As in the reference, both run on plain PyTorch ops
outside any kernel (each block dequantized first), and their steps take
the gradient with plain autograd: neither package has a backward kernel
for ``quant_matmul`` or flash attention.

Every layer kind: attention and the SSM kinds, with a dense or an MoE
FFN (the MoE one routed as in the backbone). Parameters
are drawn from an explicit ``torch.Generator`` on the caller's device;
block leaves are stacked over periods, as the reference's are, so trees
bridge over unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor, index_tree, maybe_dequantize_tree, tree_leaves
from repro_torch.models.backbone import apply_block, embed_inputs, logits_from_hidden
from repro_torch.models.layers import LeafMaker, attention_forward, mlp_forward, rms_norm
from repro_torch.models.moe import moe_forward
from repro_torch.models.ssm import MIXERS

LORA_TARGETS = ("wq", "wv")  # the paper follows Hu et al.: the q and v projections


def _lora_widths(cfg, spec) -> tuple:
    """(out width of the q-side ΔW, of the v-side ΔW) for a layer kind;
    the v side of an sLSTM and a Mamba block is drawn but unused, as in
    the reference."""
    d = cfg.d_model
    if spec.kind == "attn":
        return cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    if spec.kind == "mlstm":
        return cfg.n_heads * cfg.hd, cfg.n_heads * cfg.hd
    if spec.kind == "slstm":
        return d, d
    return 2 * cfg.d_inner, d  # mamba: in_proj


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def init_lora(gen: torch.Generator, cfg, rank: int = 8, *, device=None,
              dtype=torch.float32) -> dict:
    """One (A, B) pair each for W_q and W_v (or the kind's counterparts)
    per layer position, stacked over periods: A ~ N(0, 1)·d^-0.5, B zero;
    ``alpha`` = 2·rank (a trainable leaf, as in the reference), so the
    rank scale starts at 2."""
    d, n_p = cfg.d_model, cfg.n_periods
    leaf = LeafMaker(gen, device=device, dtype=dtype, lead=(n_p,))
    layers = []
    for spec in cfg.pattern:
        dq, dv = _lora_widths(cfg, spec)
        a_q = leaf.normal((d, rank), d ** -0.5)
        a_v = leaf.normal((d, rank), d ** -0.5)
        layers.append({"a_q": a_q, "b_q": leaf.zeros((rank, dq)),
                       "a_v": a_v, "b_v": leaf.zeros((rank, dv))})
    return {"layers": layers,
            "alpha": torch.tensor(2.0 * rank, dtype=torch.float32, device=device)}


def lora_delta(lp, x, which: str, rank_scale):
    a, b = lp[f"a_{which}"], lp[f"b_{which}"]
    return ((x @ a) @ b) * rank_scale


#: per layer kind, the mixer leaves the q-side and v-side ΔW go to
_LORA_LEAVES = {"attn": ("wq", "wv"), "mlstm": ("wq", "wv"), "slstm": ("wz", None),
                "mamba": ("in_proj", None)}


def apply_block_lora(p, lp, x, cfg, spec, positions, rank_scale):
    """One block with the LoRA ΔW materialised on its targets
    (``W + (A @ B)·scale``: W_q and W_v, an sLSTM's ``wz``, a Mamba
    block's ``in_proj``), the rest the plain block: the block is
    dequantized first, then norm, mixer, residual, norm, MLP (or MoE)."""
    p = maybe_dequantize_tree(p)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = dict(p["mixer"])
    for side, name in zip("qv", _LORA_LEAVES[spec.kind]):
        if name is not None:
            mixer[name] = mixer[name] + (lp[f"a_{side}"] @ lp[f"b_{side}"]) * rank_scale
    if spec.kind == "attn":
        x = x + attention_forward(mixer, h, cfg, spec, positions)
    else:
        x = x + MIXERS[spec.kind][1](mixer, h, cfg)
    if "ffn" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe and cfg.moe is not None:
            x = x + moe_forward(p["ffn"], h, cfg.moe)
        else:
            x = x + mlp_forward(p["ffn"], h)
    return x


def lora_logits(backbone_params, lora_params, cfg, batch):
    """The backbone's logits with LoRA on every block. batch:
    {"tokens"} or {"embeds"}, optional {"positions"}."""
    x, positions = embed_inputs(backbone_params, cfg, batch)
    rank = lora_params["layers"][0]["a_q"].shape[-1]
    rank_scale = lora_params["alpha"] / rank
    blocks, layers = backbone_params["blocks"], lora_params["layers"]
    for i in range(cfg.n_periods):
        for spec, p, lp in zip(cfg.pattern, index_tree(blocks, i), index_tree(layers, i)):
            x = apply_block_lora(p, lp, x, cfg, spec, positions, rank_scale)
    return logits_from_hidden(backbone_params, cfg, x)


# ---------------------------------------------------------------------------
# Houlsby Adapters (a serial bottleneck inside the backbone)
# ---------------------------------------------------------------------------


def init_houlsby(gen: torch.Generator, cfg, bottleneck: int = 64, *, device=None,
                 dtype=torch.float32) -> dict:
    """Per layer position, stacked over periods: ``down`` ~ N(0, 1)·d^-0.5,
    ``up`` and the norm gain ``ln`` zero (the identity start)."""
    d, n_p = cfg.d_model, cfg.n_periods
    leaf = LeafMaker(gen, device=device, dtype=dtype, lead=(n_p,))
    return {"layers": [{"down": leaf.normal((d, bottleneck), d ** -0.5),
                        "up": leaf.zeros((bottleneck, d)),
                        "ln": leaf.zeros((d,))} for _ in cfg.pattern]}


def houlsby_logits(backbone_params, adapters, cfg, batch):
    """The backbone's logits with a bottleneck after each layer:
    ``h + gelu(rms_norm(h) @ down) @ up``. The gelu is the reference's
    ``jax.nn.gelu`` default, the tanh approximation (not PyTorch's
    default erf)."""
    x, positions = embed_inputs(backbone_params, cfg, batch)
    blocks, layers = backbone_params["blocks"], adapters["layers"]
    for i in range(cfg.n_periods):
        for spec, p, ad in zip(cfg.pattern, index_tree(blocks, i), index_tree(layers, i)):
            x = apply_block(p, x, cfg, spec, positions)
            a = rms_norm(x, ad["ln"], cfg.norm_eps)
            x = x + F.gelu(a @ ad["down"], approximate="tanh") @ ad["up"]
    return logits_from_hidden(backbone_params, cfg, x)


def peft_param_count(params) -> int:
    """Elements over a tree's leaves, as the reference counts them
    (``alpha`` counts one; a QTensor its codes and scales)."""
    return sum(int(t.q.numel() + t.scale.numel()) if isinstance(t, QTensor) else int(t.numel())
               for t in tree_leaves(params) if isinstance(t, (torch.Tensor, QTensor)))
