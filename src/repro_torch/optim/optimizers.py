"""AdamW, SGD with momentum, global-norm clipping and the learning-rate
schedules over parameter trees.

Counterpart of ``repro.optim.optimizers``, written out literally rather
than through ``torch.optim.AdamW``: the reference applies the weight
decay and the eps in its own order (``p - lr·(m̂/(√v̂ + eps) + wd·p)``
with the bias corrections folded into scales), and the port's
parameters must follow it to within the reference's tolerance. Trees
are nested dicts/lists of tensors; every function returns new tensors
(the state never leaves the device: the step count is a tensor too).
The schedules take a step number (an int or a tensor) and return the
rate in the same kind.
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


def sgdm_init(params):
    """SGD with momentum's state: an f32 momentum of zeros a leaf."""
    return {"m": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)}


@torch.no_grad()
def sgdm_update(params, grads, state, lr=1e-2, momentum=0.9):
    """``m ← momentum·m + g`` in f32, then ``p ← p − lr·m``, computed in
    f32 and cast back to the parameter's dtype."""
    m = _map(lambda m_, g: momentum * m_ + g.float(), state["m"], grads)
    return _map(lambda p, m_: (p.float() - lr * m_).to(p.dtype), params, m), {"m": m}


def _min1(x):
    return torch.clamp(x, max=1.0) if isinstance(x, torch.Tensor) else min(1.0, x)


def linear_warmup(step, warmup_steps: int, peak_lr: float):
    """``peak_lr · min(1, (step + 1) / warmup_steps)``."""
    return peak_lr * _min1((step + 1) / warmup_steps)


def cosine_schedule(step, total_steps: int, peak_lr: float, warmup_steps: int = 0,
                    final_frac=0.1):
    """Linear warm-up over ``warmup_steps``, then a cosine from ``peak_lr``
    down to ``final_frac · peak_lr`` at ``total_steps``."""
    import math

    warm = _min1((step + 1) / max(warmup_steps, 1))
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    if isinstance(prog, torch.Tensor):
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = torch.cos(math.pi * prog)
    else:
        prog = min(max(prog, 0.0), 1.0)
        cos = math.cos(math.pi * prog)
    return peak_lr * warm * (final_frac + (1 - final_frac) * 0.5 * (1 + cos))
