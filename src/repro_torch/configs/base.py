"""Architecture configuration (counterpart of ``repro.configs.base``).

An :class:`ArchConfig` describes a decoder backbone as a *layer pattern*
(one period of layers, tiled ``n_layers // len(pattern)`` times). The
backbone stacks parameters over periods and loops over them.

``reduced()`` gives the CPU-test variant of the same family (≤2
periods, d_model ≤ 256), with the same rules as the reference so that
both packages build identical shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts settings for layers whose ``LayerSpec.moe`` is True."""

    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    def scaled(self, n_experts: int, d_expert: int) -> "MoESpec":
        return dataclasses.replace(
            self, n_experts=n_experts, top_k=min(self.top_k, n_experts), d_expert=d_expert
        )


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the layer pattern period.

    kind: "attn" | "mamba" | "mlstm" | "slstm"
    window: sliding-window size for attention (None = full causal)
    moe: replace the dense FFN with the arch's MoESpec
    ffn: whether the layer has a separate FFN at all
    """

    kind: str = "attn"
    window: Optional[int] = None
    moe: bool = False
    ffn: bool = True


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoESpec] = None
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    frontend: Optional[str] = None
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    mlstm_chunk: int = 256
    source: str = ""
    serve_window: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.period}")
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        """Mamba inner dim."""
        return self.ssm_expand * self.d_model

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return tuple(self.pattern) * self.n_periods

    def with_window(self, window: int) -> "ArchConfig":
        """Serving variant: force a sliding window on every attention layer."""
        pat = tuple(
            dataclasses.replace(s, window=window if s.kind == "attn" else s.window)
            for s in self.pattern
        )
        return dataclasses.replace(self, pattern=pat, serve_window=window)

    def is_subquadratic(self) -> bool:
        """True if no layer attends over unbounded context."""
        return all(s.kind != "attn" or s.window is not None for s in self.pattern)

    def reduced(self) -> "ArchConfig":
        """CPU-runnable variant of the same family: ≤2 periods, d≤256."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // max(1, self.n_heads // self.n_kv_heads))
        hd = d_model // n_heads
        moe = None
        if self.moe is not None:
            moe = self.moe.scaled(n_experts=min(4, self.moe.n_experts), d_expert=max(32, d_model // 4))
            moe = dataclasses.replace(moe, capacity_factor=float(moe.n_experts))
        pat = tuple(
            dataclasses.replace(s, window=min(s.window, 32) if s.window else s.window)
            for s in self.pattern
        )
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=self.period * min(2, self.n_periods),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=max(64, min(self.d_ff, 4 * d_model)) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            pattern=pat,
            moe=moe,
            ssm_d_state=min(self.ssm_d_state, 8),
            mlstm_chunk=16,
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        for s in self.layer_specs():
            n += 2 * d  # norms
            if s.kind == "attn":
                n += (d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                      + (self.n_heads * hd) * d)
            elif s.kind == "mamba":
                di, ds = self.d_inner, self.ssm_d_state
                n += d * 2 * di + di * self.ssm_d_conv + di * (2 * ds + 1) + di + di * d
            elif s.kind in ("mlstm", "slstm"):
                n += 4 * d * (self.n_heads * hd) + 2 * d * self.n_heads  # q,k,v,o + gates
            if s.ffn:
                if s.moe and self.moe is not None:
                    n += d * self.moe.n_experts  # router
                    n += self.moe.n_experts * 3 * d * self.moe.d_expert
                elif self.d_ff:
                    n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        n = self.param_count()
        if self.moe is None:
            return n
        for s in self.layer_specs():
            if s.moe:
                n -= (self.moe.n_experts - self.moe.top_k) * 3 * self.d_model * self.moe.d_expert
        return n


# ---------------------------------------------------------------------------
# Input shapes of the dry run (twin of ``repro.configs.base.INPUT_SHAPES``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}

def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from repro_torch import configs as _c

    _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    from repro_torch import configs as _c

    _c.load_all()
    return sorted(_REGISTRY)
