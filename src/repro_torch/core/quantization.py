"""Block-wise absmax quantization of the frozen backbone (paper §IV-D).

Counterpart of ``repro.core.quantization``, bit for bit: INT8 or packed
INT4 storage with one f32 scale per block of ``block`` elements along
the last axis, ``inv = 1/max(scale, 1e-30)``, round-half-even, a scale
of 0 for all-zero blocks and the ``orig_last`` unpad.

Parameter trees are plain nested dicts/lists/tuples of tensors;
:class:`QTensor` is a leaf. :func:`tree_map` is the port's stand-in
for ``jax.tree.map``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class QTensor:
    """Block-quantized tensor: int8 storage + per-block f32 scales.

    q:      int8; for bits=4, two nibbles packed per byte along the last
            axis (shape[..., padded_last/2]), low nibble first.
    scale:  f32 (..., n_blocks) — absmax / qmax, one per block.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int, block: int,
                 orig_last: int):
        self.q = q
        self.scale = scale
        self.bits = bits
        self.block = block
        self.orig_last = orig_last

    @property
    def shape(self):
        return tuple(self.q.shape[:-1]) + (self.orig_last,)

    @property
    def dtype(self):  # storage dtype
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4

    def to(self, device) -> "QTensor":
        """Payload and scales on ``device``."""
        return QTensor(self.q.to(device), self.scale.to(device), self.bits, self.block,
                       self.orig_last)

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading axes (e.g. one period of a stacked leaf);
        the quantized last axis is never cut."""
        return QTensor(self.q[idx], self.scale[idx], self.bits, self.block, self.orig_last)

    def __repr__(self):
        return f"QTensor(int{self.bits}, shape={self.shape}, block={self.block})"


def _qmax(bits: int) -> int:
    return {8: 127, 4: 7}[bits]


def quantize(x: torch.Tensor, bits: int = 8, block: int = 128) -> QTensor:
    """Block-wise absmax quantization along the last axis (paper Eq. 1)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    orig_last = x.shape[-1]
    block = min(block, orig_last)
    if bits == 4 and block % 2:
        block += 1  # nibble packing needs an even padded length
    nb = -(-orig_last // block)
    pad = nb * block - orig_last
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(x.shape[:-1] + (nb, block)).to(torch.float32)
    absmax = xb.abs().amax(dim=-1)
    qmax = _qmax(bits)
    scale = absmax / qmax
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xb * inv[..., None]), -qmax, qmax).to(torch.int8)
    del xb
    q = q.reshape(x.shape[:-1] + (nb * block,))
    if bits == 4:
        qi = q.to(torch.int32)
        packed = (qi[..., 0::2] & 0xF) | ((qi[..., 1::2] & 0xF) << 4)  # 0..255
        q = torch.where(packed >= 128, packed - 256, packed).to(torch.int8)
    return QTensor(q, scale, bits, block, orig_last)


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Packed nibbles (..., n) int8 -> sign-extended int32 (..., 2n)."""
    qi = q.to(torch.int32)
    lo = qi & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = (qi >> 4) & 0xF
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[:-1] + (q.shape[-1] * 2,))


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Paper Eq. (2): elementwise q * scale, unpad, cast to compute dtype."""
    q = unpack_int4(t.q) if t.bits == 4 else t.q
    padded_last = q.shape[-1]
    nb = padded_last // t.block
    xb = q.reshape(q.shape[:-1] + (nb, t.block)).to(torch.float32)
    x = (xb * t.scale[..., None]).reshape(q.shape[:-1] + (padded_last,))
    return x[..., : t.orig_last].to(dtype)


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (a
    :class:`QTensor` and ``None`` are leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


# leaves whose path has a component containing one of these substrings stay
# full precision (MoE routers; the same rule as the reference)
QUANT_SKIP_NAMES = ("router",)


def should_quantize(path, x, min_size: int = 4096, skip_names=QUANT_SKIP_NAMES) -> bool:
    """The reference's ``quantize_tree`` leaf rule: every tensor with
    ``ndim >= 2`` and ``numel >= min_size`` whose path names no skip
    name — including period-stacked norm gains ``(n_p, d)``."""
    if isinstance(skip_names, str):
        skip_names = (skip_names,)
    if any(s in n for n in path for s in skip_names):
        return False
    return isinstance(x, torch.Tensor) and x.ndim >= 2 and x.numel() >= min_size


def quantize_tree(tree, bits: int = 8, block: int = 128, min_size: int = 4096,
                  skip_names=QUANT_SKIP_NAMES):
    """Quantize every large weight leaf; leave small/1-D leaves untouched."""

    def f(path, x):
        if should_quantize(path, x, min_size, skip_names):
            return quantize(x, bits, block)
        return x

    return _map_with_path(f, tree)


def maybe_dequantize_tree(tree, dtype=torch.float32):
    """Identity on plain tensors; dequantizes any QTensor leaves."""
    return tree_map(lambda x: dequantize(x, dtype) if isinstance(x, QTensor) else x, tree)


def tree_storage_bytes(tree) -> int:
    """Total storage bytes (int bytes for QTensors, tensor bytes otherwise)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def stack(parts, dim: int = 0):
    """``torch.stack`` of tensors, or of QTensors of one layout
    (payloads and scales stacked alike; ``dim`` counts leading axes)."""
    first = parts[0]
    if isinstance(first, QTensor):
        return QTensor(torch.stack([p.q for p in parts], dim),
                       torch.stack([p.scale for p in parts], dim),
                       first.bits, first.block, first.orig_last)
    return torch.stack(parts, dim)


def index_tree(tree, idx: Any):
    """``t[idx]`` on every leaf — e.g. one period of a stacked block tree."""
    return tree_map(lambda t: t[idx], tree)
