"""AdamW and global-norm clipping over parameter trees.

Counterpart of ``repro.optim.optimizers``, written out literally rather
than through ``torch.optim.AdamW``: the reference applies the weight
decay and the eps in its own order (``p - lr·(m̂/(√v̂ + eps) + wd·p)``
with the bias corrections folded into scales), and the port's
parameters must follow it to within the reference's tolerance. Trees
are nested dicts/lists of tensors; every function returns new tensors
(the state never leaves the device: the step count is a tensor too).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import tree_leaves


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def adamw_init(params):
    zeros = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = tree_leaves(params)[0].device
    return {"mu": zeros, "nu": _map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01):
    count = state["count"] + 1
    c = count.to(torch.float32)
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["nu"], grads)
    mu_hat_scale = 1.0 / (1 - b1 ** c)
    nu_hat_scale = 1.0 / (1 - b2 ** c)

    def upd(p, m, v):
        step = m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + eps)
        p32 = p.float()
        return (p32 - lr * (step + weight_decay * p32)).to(p.dtype)

    return _map(upd, params, mu, nu), {"mu": mu, "nu": nu, "count": count}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns (grads, norm); the norm stays a device tensor (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return _map(lambda g: g * scale, grads), norm
