"""Mixture-of-Experts with capacity-based token dispatch (counterpart of
``repro.models.moe``).

Token-choice top-k routing with a static per-expert capacity
``C = min(T, roundup8(top_k * T / E * capacity_factor))``: each expert
gathers its highest-priority assigned tokens (priority = router
probability), computes a gated MLP, and the results are combined with the
routing weights. Dropped tokens (over capacity) fall back to the residual
stream, the GShard/Switch behaviour. The capacity's round-up to 8 and its
cap at T are semantics, kept from the reference: they decide which tokens
drop.

The router runs in f32. The experts are dense tensors here (the OpSets
dequantize them, as the reference's do) and run as batched products over
the expert axis. No kernel: the reference computes its MoE outside any
Pallas kernel too.

Routing is discontinuous, so ties are resolved as ``jax.lax.top_k`` does,
lower index first, by a stable sort (``torch.topk`` does not promise an
order among equal values). The combine adds each token's K expert outputs
in ascending expert order in a fixed sequence of adds, the order of the
reference's scatter-add, with no atomics: two calls give equal bits.

``n_groups`` splits the tokens into batch-aligned groups routed on their
own with capacity ``C/G`` each, as the reference does on a production
mesh. The port has no GSPMD mesh, so ``_auto_groups`` gives 1, as the
reference does without one.

:func:`record_routes` collects each call's routes (the experts each token
picked and whether each was kept) so that two runs can be compared route
by route. :func:`replay_routes` makes each call take the routes another
run recorded, in call order (each chosen expert's gate is this call's own
probability), so that two runs whose inputs differ by f32 noise follow
one set of routes; the records then hold each call's own choice, so a
layer's flips can be counted without those of the layers before it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import LeafMaker

#: the list of route records while :func:`record_routes` is active
_ROUTES: Optional[list] = None
#: the records :func:`replay_routes` hands out, in call order
_REPLAY: Optional[list] = None


@contextlib.contextmanager
def record_routes():
    """Within the block, every :func:`moe_forward` call appends one record
    to the yielded list, in call order: ``{"top_e": (B, S, K) int64, the
    experts each token picked in descending probability, "kept": (B, S, K)
    bool, whether that expert took the token (False where it was over
    capacity)}``."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


@contextlib.contextmanager
def replay_routes(records: list):
    """Within the block, the i-th :func:`moe_forward` call routes as
    ``records[i]`` says (a :func:`record_routes` record of a call on the
    same (B, S) tokens): each token goes to the recorded experts, and each
    expert keeps exactly the recorded tokens, its dispatch ordered and
    gated by this call's own probabilities. A record :func:`record_routes`
    takes meanwhile is the call's own routing, before the replay. Raises
    when the calls outnumber the records or a shape differs, and at the
    block's end when records are left over."""
    global _REPLAY
    prev, _REPLAY = _REPLAY, list(records)
    try:
        yield
        if _REPLAY:
            raise ValueError(f"{len(_REPLAY)} route records not replayed")
    finally:
        _REPLAY = prev


def init_moe(leaf: LeafMaker, d: int, spec) -> dict:
    """The router (d, E), kept f32 and never quantized, and the experts'
    gated MLPs (E, d, d_e), (E, d, d_e), (E, d_e, d). The expert leaves are
    drawn one period at a time (``by_period``), so a stacked leaf is never
    resident in f32 (mixtral's ``wi`` would be 60 GB)."""
    E, de = spec.n_experts, spec.d_expert
    return {
        "router": leaf.normal((d, E), d ** -0.5, name="router"),
        "wi": leaf.normal((E, d, de), d ** -0.5, by_period=True),
        "wg": leaf.normal((E, d, de), d ** -0.5, by_period=True),
        "wo": leaf.normal((E, de, d), de ** -0.5, by_period=True),
    }


def _capacity(T: int, spec, capacity_factor=None) -> int:
    cf = spec.capacity_factor if capacity_factor is None else capacity_factor
    c = int(spec.top_k * T * cf / spec.n_experts)
    c = -(-max(1, c) // 8) * 8  # the reference's round-up to 8
    return min(T, c)


def _auto_groups(B: int, S: int, spec) -> int:
    """1: the reference groups tokens by its mesh's data shards, and
    without a mesh (as here) routes globally."""
    return 1


def _topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    equal values in ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x: torch.Tensor, spec, capacity_factor=None, n_groups: Optional[int] = None):
    """The routing of :func:`moe_forward`: x (B, S, d) -> a dict of
    ``logits``, ``probs`` (G, Tg, E), ``top_p``, ``top_e`` (G, Tg, K), the
    per-expert dispatch ``gate``, ``idx``, ``valid`` (G, E, C) and the
    group count ``G`` and capacity ``C``."""
    B, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    G = _auto_groups(B, S, spec) if n_groups is None else n_groups
    if B % G:
        raise ValueError(f"batch {B} does not split into {G} groups")
    Tg = (B // G) * S
    C = _capacity(Tg, spec, capacity_factor)
    logits = x.reshape(G, Tg, d).float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _topk(probs, K)
    # priorities (G, E, Tg): a token's probability at its chosen experts, 0 elsewhere
    prio = torch.zeros(G, Tg, E, dtype=torch.float32, device=x.device)
    prio = prio.scatter(2, top_e, top_p).transpose(1, 2)
    gate, idx = _topk(prio, C)  # each expert's C highest-priority tokens
    return {"logits": logits, "probs": probs, "top_p": top_p, "top_e": top_e, "gate": gate,
            "idx": idx, "valid": gate > 0.0, "G": G, "C": C}


def _replayed(r, rec: dict, B: int, S: int):
    """``route``'s dict ``r`` made to follow the record ``rec``: the
    recorded experts, gated by ``r``'s probabilities, each expert keeping
    the recorded tokens (at most C: the record came from a call on as many
    tokens) in this call's priority order."""
    G, C, (Tg, E) = r["G"], r["C"], r["probs"].shape[1:]
    K = r["top_e"].shape[-1]
    if tuple(rec["top_e"].shape) != (B, S, K) or tuple(rec["kept"].shape) != (B, S, K):
        raise ValueError(f"route record {tuple(rec['top_e'].shape)} does not match the call's "
                         f"{(B, S, K)}")
    top_e = rec["top_e"].reshape(G, Tg, K).to(r["top_e"].device)
    kept = rec["kept"].reshape(G, Tg, K).to(top_e.device)
    top_p = torch.gather(r["probs"], 2, top_e)
    prio = torch.zeros(G, Tg, E, dtype=torch.float32, device=top_e.device)
    prio = prio.scatter(2, top_e, torch.where(kept, top_p, torch.zeros_like(top_p)))
    gate, idx = _topk(prio.transpose(1, 2), C)
    return dict(r, top_p=top_p, top_e=top_e, gate=gate, idx=idx, valid=gate > 0.0)


def _kept(r, Tg: int) -> torch.Tensor:
    """(G, Tg, K) bool: whether each of a token's K experts took it."""
    G, E, _ = r["idx"].shape
    taken = torch.zeros(G, E, Tg + 1, dtype=torch.bool, device=r["idx"].device)
    slot = torch.where(r["valid"], r["idx"], torch.full_like(r["idx"], Tg))
    taken.scatter_(2, slot, torch.ones_like(r["valid"]))
    return torch.gather(taken[:, :, :Tg].transpose(1, 2), 2, r["top_e"])


def moe_forward(p, x: torch.Tensor, spec, return_aux: bool = False, capacity_factor=None,
                n_groups: Optional[int] = None):
    """x: (B, S, d) -> (B, S, d) [+ the aux dict: ``load_balance``,
    ``router_z``, ``dropped_frac``]."""
    B, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    r = route(p, x, spec, capacity_factor, n_groups)
    G, C = r["G"], r["C"]
    Tg = (B // G) * S
    if _ROUTES is not None:  # the call's own routing, before any replay
        _ROUTES.append({"top_e": r["top_e"].reshape(B, S, K),
                        "kept": _kept(r, Tg).reshape(B, S, K)})
    if _REPLAY is not None:
        if not _REPLAY:
            raise ValueError("more MoE calls than route records to replay")
        r = _replayed(r, _REPLAY.pop(0), B, S)
    xg = x.reshape(G, Tg, d)
    gate, idx, valid = r["gate"], r["idx"], r["valid"]

    # dispatch: each expert's C tokens (G, E, C, d), then the gated MLP
    xe = xg[torch.arange(G, device=x.device)[:, None, None], idx]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", xe, p["wi"])
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])
    w = torch.where(valid, gate, torch.zeros_like(gate)).to(ye.dtype)
    yw = ye * w[..., None]

    # combine: token t's slot in expert e's list (C where e did not take
    # it), then its K outputs added in ascending expert order
    slot = torch.full((G, E, Tg + 1), C, dtype=torch.long, device=x.device)
    where = torch.where(valid, idx, torch.full_like(idx, Tg))
    slot.scatter_(2, where, torch.arange(C, device=x.device).expand(G, E, C).contiguous())
    slot = slot[:, :, :Tg]
    yw = torch.cat([yw, torch.zeros_like(yw[:, :, :1])], dim=2)  # slot C: nothing
    order = torch.sort(r["top_e"], dim=-1).values  # (G, Tg, K), ascending experts
    gi = torch.arange(G, device=x.device)[:, None]
    ti = torch.arange(Tg, device=x.device)[None, :]
    out = torch.zeros(G, Tg, d, dtype=yw.dtype, device=x.device)
    for k in range(K):
        e = order[:, :, k]
        out = out + yw[gi, e, slot[gi, e, ti]]
    out = out.reshape(B, S, d).to(x.dtype)

    if not return_aux:
        return out
    me = r["probs"].mean(dim=(0, 1))
    fe = F.one_hot(r["top_e"], E).float().sum(dim=2).mean(dim=(0, 1))
    aux = {
        "load_balance": E * torch.sum(me * fe),
        "router_z": torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1))),
        "dropped_frac": 1.0 - valid.sum().float() / (G * Tg * K),
    }
    return out, aux


def moe_forward_dense(p, x: torch.Tensor, spec) -> torch.Tensor:
    """Dense (every expert on every token) reference, for checks at small
    scale: what :func:`moe_forward` gives when no token drops."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    top_p, top_e = _topk(probs, spec.top_k)
    w = torch.zeros(T, spec.n_experts, dtype=torch.float32, device=x.device)
    w = w.scatter(1, top_e, top_p)
    h = F.silu(torch.einsum("td,edf->etf", xt, p["wg"])) * torch.einsum(
        "td,edf->etf", xt, p["wi"])
    ye = torch.einsum("etf,efd->etd", h, p["wo"])
    out = torch.einsum("te,etd->td", w.to(ye.dtype), ye)
    return out.reshape(B, S, d).to(x.dtype)
