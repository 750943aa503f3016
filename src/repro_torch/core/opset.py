"""OpSet — the dispatch seam between the model math and its kernels.

Counterpart of ``repro.core.opset``. The backbone's forward is built
from a handful of primitive ops (projection matmuls, the attention core,
paged decode attention, the embedding gather, norms and rope); an
:class:`OpSet` bundles one implementation of each. The model layer
(``repro_torch.models``) calls only the OpSet and never imports
``repro_torch.kernels``.

* ``ref`` — plain PyTorch: ``prepare_block`` dequantizes the whole block
  up front and every op is a dense torch op.
* ``cuda`` — the storage-width path, the counterpart of the reference's
  ``PallasOpSet``: INT8/INT4 weights stay :class:`QTensor` and feed the
  ``quant_matmul`` kernel, prefill attention runs the flash kernel,
  decode attention the paged kernel, an SSM block's mixer is dequantized
  and runs dense (as in the reference), and the embedding gathers int8 rows
  and dequantizes only the gathered slice; the adapter's per-period
  λ-mix with one adapter's weight runs the ``adapter_fuse`` kernel. The
  ops go through ``repro_torch.kernels.ops``. The CUDA kernels mask their
  own ragged edges, so none of the TPU path's padding to 128/256 is
  needed. On CPU tensors each kernel wrapper computes its plain version,
  which is how the CPU tests run this OpSet.

Each OpSet instance carries a ``tap_policy`` (the activation cache's
compress policy): ``emit_tap`` hands a PAC+ tap to the cache in that
storage form. Under ``cuda`` an int8 tap leaves the forward as a
:class:`QTensor` (payload + one f32 scale per ``TAP_BLOCK`` values), a
bf16 tap as a bf16 tensor; ``ref`` always emits f32 and leaves
compression to the cache.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, dequantize, maybe_dequantize_tree, quantize

# quantization block of emitted int8 taps — the activation cache's int8
# block, so tap-site quantization equals cache-side compression bit for bit
TAP_BLOCK = 128

TAP_POLICIES = ("f32", "bf16", "int8")


class OpSet:
    """One implementation of the backbone's primitive ops."""

    name: str = "abstract"
    tap_policy: str = "f32"

    def prepare_block(self, p, spec):
        """Make one block's params consumable by this OpSet's ops."""
        raise NotImplementedError

    def matmul(self, x, w):
        """``x @ w`` where ``w`` is a plain tensor or a :class:`QTensor`."""
        raise NotImplementedError

    def attention(self, q, k, v, cfg, spec):
        """Causal prefill attention. q: (B,S,H,hd); k, v: (B,S,Hkv,hd),
        rope applied. Returns (B,S,H·hd)."""
        raise NotImplementedError

    def paged_attention(self, q, k_pages, v_pages, k_scale, v_scale,
                        block_tables, lengths, cfg, spec):
        """Paged-KV decode attention. q: (B, Hkv, n_rep, hd); pages
        (n_pages, page, Hkv, hd) int8/f32/bf16 (+ scales for int8, else
        None); block_tables (B, max_pages) int32; lengths (B,) int32.
        Returns (B, Hkv, n_rep, hd) f32."""
        raise NotImplementedError

    def embed_lookup(self, embed, tokens):
        """Token embedding gather; ``embed`` may be a QTensor."""
        raise NotImplementedError

    def emit_tap(self, h):
        """A PAC+ tap leaving the backbone forward, in the form the
        activation cache stores (identity for the f32 policy)."""
        raise NotImplementedError

    def adapter_mix(self, b, w_down, a, lam):
        """The adapter's per-period mix ``λ·(b @ w_down) + (1−λ)·a``.
        b (B,S,d); a (B,S,d_a); w_down (d, d_a), or (B, d, d_a) with one
        adapter per request row; λ a 0-d tensor in [0, 1] (or (B,1,1)).
        A bf16 ``b`` meets an f32 ``w_down`` in f32, as under JAX."""
        from repro_torch.models.layers import promoted_matmul

        return lam * promoted_matmul(b, w_down) + (1.0 - lam) * a

    def rms_norm(self, x, weight, eps: float = 1e-6):
        from repro_torch.models.layers import rms_norm

        return rms_norm(x, weight, eps)

    def apply_rope(self, x, positions, theta: float = 10_000.0):
        from repro_torch.models.layers import apply_rope

        return apply_rope(x, positions, theta)

    def apply_mrope(self, x, positions, theta: float = 1_000_000.0):
        from repro_torch.models.layers import apply_mrope

        return apply_mrope(x, positions, theta)


class RefOpSet(OpSet):
    """Dequantize-then-dense plain PyTorch ops."""

    name = "ref"

    def __init__(self, tap_policy: str = "f32"):
        # taps leave the ref forward in f32 whatever the cache policy:
        # compression stays the cache's job on this path
        self.tap_policy = "f32"

    def prepare_block(self, p, spec):
        return maybe_dequantize_tree(p)

    def matmul(self, x, w):
        if isinstance(w, QTensor):
            w = dequantize(w)
        return x @ w

    def attention(self, q, k, v, cfg, spec):
        from repro_torch.models.layers import ref_attention_core

        return ref_attention_core(q, k, v, cfg, spec)

    def paged_attention(self, q, k_pages, v_pages, k_scale, v_scale,
                        block_tables, lengths, cfg, spec):
        from repro_torch.kernels.ref import paged_attention_ref

        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            k_scale=k_scale, v_scale=v_scale, window=spec.window,
            attn_softcap=cfg.attn_softcap,
        )

    def embed_lookup(self, embed, tokens):
        return maybe_dequantize_tree(embed)[tokens.long()]

    def emit_tap(self, h):
        return h


class CudaOpSet(OpSet):
    """Storage-width ops on the hand-written CUDA kernels. Plain-tensor
    weights take a dense matmul — the kernels buy nothing unquantized."""

    name = "cuda"

    def __init__(self, tap_policy: str = "f32"):
        if tap_policy not in TAP_POLICIES:
            raise ValueError(f"tap_policy must be one of {TAP_POLICIES}, got {tap_policy!r}")
        self.tap_policy = tap_policy

    def prepare_block(self, p, spec):
        """Keep the projection weights quantized; dequantize only the
        leaves no kernel takes: the norm gains (which ``quantize_tree``
        quantizes too when they are period-stacked), an SSM block's mixer
        (its scans and gates run dense) and an MoE FFN's experts, whose
        batched products run dense, as the reference's pallas OpSet
        dequantizes them. A dense FFN beside an SSM mixer stays quantized."""
        mixer = p["mixer"] if spec.kind == "attn" else maybe_dequantize_tree(p["mixer"])
        out = {"ln1": maybe_dequantize_tree(p["ln1"]), "mixer": mixer}
        if "ffn" in p:
            out["ln2"] = maybe_dequantize_tree(p["ln2"])
            out["ffn"] = maybe_dequantize_tree(p["ffn"]) if spec.moe else p["ffn"]
        return out

    def matmul(self, x, w):
        if not isinstance(w, QTensor):
            return x @ w
        from repro_torch.kernels import ops

        return ops.quant_matmul(x, w)

    def attention(self, q, k, v, cfg, spec):
        from repro_torch.kernels import ops

        B, S, H, hd = q.shape
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=True, window=spec.window, attn_softcap=cfg.attn_softcap)
        return o.transpose(1, 2).reshape(B, S, H * hd)

    def paged_attention(self, q, k_pages, v_pages, k_scale, v_scale,
                        block_tables, lengths, cfg, spec):
        from repro_torch.kernels.paged_attention import paged_attention

        return paged_attention(
            q.contiguous(), k_pages, v_pages, block_tables, lengths,
            k_scale=k_scale, v_scale=v_scale, window=spec.window,
            attn_softcap=cfg.attn_softcap,
        )

    def embed_lookup(self, embed, tokens):
        if not isinstance(embed, QTensor):
            return embed[tokens.long()]
        # gather at storage width, dequantize only the gathered (B,S) rows
        idx = tokens.long()
        return dequantize(QTensor(embed.q[idx], embed.scale[idx], embed.bits, embed.block,
                                  embed.orig_last))

    def adapter_mix(self, b, w_down, a, lam):
        """One adapter's weight: the ``adapter_fuse`` kernel. A request
        axis on ``w_down`` (the engine's adapter bank) keeps the batched
        plain ops: the kernel, like the TPU one, takes a single W."""
        if w_down.ndim != 2:
            return super().adapter_mix(b, w_down, a, lam)
        from repro_torch.kernels import ops

        return ops.adapter_fuse(b, w_down, a, lam)

    def emit_tap(self, h):
        if self.tap_policy == "f32":
            return h
        if self.tap_policy == "bf16":
            return h.to(torch.bfloat16)
        return quantize(h.to(torch.float32), bits=8, block=TAP_BLOCK)


_REGISTRY = {"ref": RefOpSet, "cuda": CudaOpSet}
_INSTANCES: dict = {}


def register_opset(name: str, factory) -> None:
    """Register an OpSet factory (``factory(tap_policy=)``) under ``name``:
    the plug-in point for op variants that must not touch the model code.
    A name registered again drops the instances made by its old factory.
    ``RunSpec.kernels`` still takes only the port's own two names."""
    _REGISTRY[name] = factory
    for key in [k for k in _INSTANCES if k[0] == name]:
        del _INSTANCES[key]


def get_opset(name, tap_policy: str = "f32") -> OpSet:
    """Resolve an OpSet by name (``"ref"`` / ``"cuda"``), one stateless
    instance per (name, tap_policy); an OpSet instance passes through."""
    if isinstance(name, OpSet):
        return name
    key = (name, tap_policy)
    if key not in _INSTANCES:
        if name not in _REGISTRY:
            raise ValueError(f"unknown OpSet {name!r}; registered: {sorted(_REGISTRY)}")
        _INSTANCES[key] = _REGISTRY[name](tap_policy=tap_policy)
    return _INSTANCES[key]

