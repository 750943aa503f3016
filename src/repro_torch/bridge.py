"""Numpy trees to the port's tensors and back.

The JAX package's parameters, exported as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), become the port's parameter trees:

* nested dicts, lists and tuples are kept as they are;
* any object with ``q, scale, bits, block, orig_last`` attributes (the
  reference's ``QTensor``, by duck typing — this module never imports
  the reference) becomes a :class:`~repro_torch.core.quantization.QTensor`;
* bf16 arrays travel as their raw 16 bits (``.view(np.uint16)``) and
  become ``torch.bfloat16`` views, so the card's machine needs no
  ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.quantization import QTensor


class NumpyQTensor(NamedTuple):
    """A quantized leaf in numpy form (duck-type compatible with both
    packages' ``QTensor`` constructors)."""

    q: np.ndarray
    scale: np.ndarray
    bits: int
    block: int
    orig_last: int


def _is_qtensor_like(x) -> bool:
    return all(hasattr(x, a) for a in ("q", "scale", "bits", "block", "orig_last"))


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: numpy views of JAX arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def to_torch(tree, device="cpu"):
    """Numpy (or array-like) tree -> tree of tensors on ``device``."""
    if _is_qtensor_like(tree) and not isinstance(tree, QTensor):
        return QTensor(_to_tensor(tree.q, device), _to_tensor(tree.scale, device),
                       int(tree.bits), int(tree.block), int(tree.orig_last))
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None or isinstance(tree, (int, float, bool, str)):
        return tree
    return _to_tensor(tree, device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where a bf16 array must leave the port

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(tree, qtensor: Optional[Callable] = None):
    """Tree of tensors -> numpy tree. ``qtensor(q, scale, bits, block,
    orig_last)`` rebuilds quantized leaves (default :class:`NumpyQTensor`;
    pass the reference's ``QTensor`` to hand a tree back to JAX)."""
    make = qtensor if qtensor is not None else NumpyQTensor
    if isinstance(tree, QTensor):
        return make(_to_numpy(tree.q), _to_numpy(tree.scale), tree.bits, tree.block,
                    tree.orig_last)
    if isinstance(tree, dict):
        return {k: to_numpy(v, qtensor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v, qtensor) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _to_numpy(tree)
    return tree
