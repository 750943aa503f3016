"""The hybrid data + pipeline parallel runtime (paper §V-A) on
``torch.distributed`` (counterpart of ``repro.core.pipeline``).

* **Schedule** — :func:`build_1f1b_schedule` emits the paper's
  one-forward-one-backward micro-batch order (Fig. 10b) and
  :func:`validate_schedule` checks it (dependencies, in-flight bound).
* **Stage slabs** — :func:`stack_stages` and :func:`stack_stages_ragged`
  re-chunk period-stacked block parameters into per-stage slabs, even
  or along a planner partition's uneven boundaries.
* **Runtime** — :func:`pipeline_apply` runs one dp row's stages as a
  point-to-point pipeline, forward only: the trainer's backbone is
  frozen (the reference stops the gradient at the activations), so no
  backward crosses the stages. Stage ``s`` takes the micro-batches in
  order (every stage's F order in the 1F1B schedule), taking micro ``m``
  from stage ``s-1`` and handing its output on with a non-blocking send,
  so stages overlap across micro-batches.

* **Simulator** — :func:`simulate_plan` replays a planner
  :class:`~repro_torch.core.planner.Plan` through a discrete-event model
  of the 1F1B schedule over the plan's stage times (the planner's
  estimate for its modelled devices, not a time on this machine).

``pipeline_grads`` (backward through the pipeline, which no trainer path
uses) is queued in the roadmap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.quantization import QTensor, stack, tree_map

# ---------------------------------------------------------------------------
# 1F1B schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Op:
    stage: int
    micro: int
    kind: str  # "F" | "B"


def build_1f1b_schedule(n_stages: int, n_micro: int) -> List[List[Op]]:
    """Per-stage op order for 1F1B (PipeDream-flush). Returns ops[stage] lists."""
    out: List[List[Op]] = []
    for s in range(n_stages):
        warmup = min(n_stages - s - 1, n_micro)
        ops: List[Op] = [Op(s, m, "F") for m in range(warmup)]
        f, b = warmup, 0
        while b < n_micro:
            if f < n_micro:
                ops.append(Op(s, f, "F"))
                f += 1
            ops.append(Op(s, b, "B"))
            b += 1
        # dedupe while preserving order (warmup overlap)
        seen = set()
        ops = [o for o in ops if not ((o.kind, o.micro) in seen or seen.add((o.kind, o.micro)))]
        out.append(ops)
    return out


def validate_schedule(sched: List[List[Op]], n_micro: int) -> None:
    """Raise ``ValueError`` where the schedule breaks a pipeline
    dependency or 1F1B's in-flight bound."""
    n_stages = len(sched)
    for s, ops in enumerate(sched):
        fs = [o.micro for o in ops if o.kind == "F"]
        bs = [o.micro for o in ops if o.kind == "B"]
        if fs != sorted(fs) or len(fs) != n_micro:
            raise ValueError(f"stage {s}: bad F order")
        if bs != sorted(bs) or len(bs) != n_micro:
            raise ValueError(f"stage {s}: bad B order")
        # 1F1B memory bound: in-flight microbatches <= n_stages - s
        inflight = 0
        for o in ops:
            inflight += 1 if o.kind == "F" else -1
            if inflight > n_stages - s:
                raise ValueError(f"stage {s}: {inflight} in flight")


# ---------------------------------------------------------------------------
# Discrete-event simulator
# ---------------------------------------------------------------------------


def simulate_plan(plan, comm_bytes_per_stage: Optional[Sequence[float]] = None) -> dict:
    """Replay 1F1B through the plan's stage times (``comm_bytes_per_stage``:
    bytes each stage hands on, over its slowest device's bandwidth).
    Returns ``minibatch_time``, ``bubble_fraction`` and
    ``per_stage_busy``, in the plan's units (modelled seconds)."""
    S, M = plan.n_stages, plan.micro_batches
    sched = build_1f1b_schedule(S, M)
    # per-stage fwd/bwd split as recorded from LayerCost by the planner's
    # _phase_latencies; hand-built stages without recorded times fall back
    # to the historical tf:tb = 1:2 approximation
    tf, tb = [], []
    for st in plan.stages:
        if getattr(st, "fwd_time", 0.0) or getattr(st, "bwd_time", 0.0):
            tf.append(st.fwd_time)
            tb.append(st.bwd_time)
        else:
            tf.append(st.stage_time / 3.0)
            tb.append(2.0 * st.stage_time / 3.0)
    if comm_bytes_per_stage is None:
        comm = [0.0] * S
    else:
        comm = [
            b / min(d.bandwidth for d in st.devices)
            for b, st in zip(comm_bytes_per_stage, plan.stages)
        ]
    f_done = {}
    b_done = {}
    dev_free = [0.0] * S
    idx = [0] * S
    remaining = sum(len(x) for x in sched)
    while remaining:
        progressed = False
        for s in range(S):
            if idx[s] >= len(sched[s]):
                continue
            op = sched[s][idx[s]]
            if op.kind == "F":
                ready = 0.0 if s == 0 else f_done.get((s - 1, op.micro), None)
                if ready is None:
                    continue
                start = max(dev_free[s], ready + (comm[s - 1] if s else 0.0))
                f_done[(s, op.micro)] = start + tf[s]
                dev_free[s] = start + tf[s]
            else:
                ready = f_done.get((s, op.micro))
                up = 0.0 if s == S - 1 else b_done.get((s + 1, op.micro), None)
                if up is None or ready is None:
                    continue
                start = max(dev_free[s], ready, up + (comm[s] if s < S - 1 else 0.0))
                b_done[(s, op.micro)] = start + tb[s]
                dev_free[s] = start + tb[s]
            idx[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:
            raise RuntimeError("schedule deadlock")
    total = max(b_done.values())
    busy = sum(M * (tf[s] + tb[s]) for s in range(S))
    return {
        "minibatch_time": total,
        "bubble_fraction": 1.0 - busy / (total * S),
        "per_stage_busy": [M * (tf[s] + tb[s]) for s in range(S)],
    }


# ---------------------------------------------------------------------------
# Stage slabs
# ---------------------------------------------------------------------------


def map_arrays(fn: Callable, tree):
    """``fn`` over every tensor of ``tree``, a QTensor's payload and
    scales alike (the reference's tree map over its QTensor pytree)."""

    def f(x):
        if isinstance(x, QTensor):
            return QTensor(fn(x.q), fn(x.scale), x.bits, x.block, x.orig_last)
        return fn(x)

    return tree_map(f, tree)


def stack_stages(blocks, n_stages: int):
    """Re-chunk period-stacked block params (n_p, ...) -> (n_stages, n_p/s, ...)."""

    def f(x):
        n_p = x.shape[0]
        if n_p % n_stages:
            raise ValueError(f"{n_p} periods not divisible by {n_stages} stages")
        return x.reshape((n_stages, n_p // n_stages) + tuple(x.shape[1:]))

    return map_arrays(f, blocks)


def stack_stages_ragged(blocks, boundaries: Sequence[int]):
    """Uneven re-chunk: stage ``s`` owns periods ``[boundaries[s],
    boundaries[s+1])``; every stage's slab is zero-padded to the max
    periods-per-stage so the leaves stay rectangular —
    (n_stages, max_pp, ...). Padded slots must run as identity (the
    partition's ``masks()``)."""
    counts = [b - a for a, b in zip(boundaries, boundaries[1:])]
    if not counts or min(counts) < 1:
        raise ValueError(f"bad boundaries {boundaries}")
    max_pp = max(counts)

    def f(x):
        if x.shape[0] != boundaries[-1]:
            raise ValueError(f"{x.shape[0]} periods but boundaries end at {boundaries[-1]}")
        slabs = []
        for a, b in zip(boundaries, boundaries[1:]):
            s = x[a:b]
            if b - a < max_pp:
                pad = torch.zeros((max_pp - (b - a),) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
                s = torch.cat([s, pad], dim=0)
            slabs.append(s)
        return torch.stack(slabs)

    return map_arrays(f, blocks)


# ---------------------------------------------------------------------------
# The point-to-point pipeline
# ---------------------------------------------------------------------------


def _cat(parts, dim: int):
    """``torch.cat`` of tensors, or of QTensors of one layout."""
    first = parts[0]
    if isinstance(first, QTensor):
        return QTensor(torch.cat([p.q for p in parts], dim),
                       torch.cat([p.scale for p in parts], dim),
                       first.bits, first.block, first.orig_last)
    return torch.cat(parts, dim)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, mesh, *,
                   collect_taps: bool = False,
                   periods_per_stage: Optional[Sequence[int]] = None):
    """Run this rank's stage of its dp row's pipeline over the micro-batches.

    Forward only (no backward crosses the stages): a stage takes the
    micro-batches in order, which is the F order of every stage in
    :func:`build_1f1b_schedule`, and sends each on as soon as it is done,
    so the stages overlap across micro-batches.

    ``stage_fn(stage_params, h) -> h'`` is one stage's compute (same
    shape in and out); with ``collect_taps=True`` it returns ``(h',
    taps)``, ``taps`` a tensor or QTensor whose arrays lead with
    (periods of the stage, mb, ...): the per-period activations PAC+
    caches. ``x_micro`` (n_micro, mb, ...) is the row's input; only the
    first stage reads its values, later stages its length (a ``meta``
    tensor will do).

    Returns, on the row's first stage, the LAST stage's outputs
    (n_micro, mb, ...), or with ``collect_taps`` ``(outs, taps)`` with
    every tap array (n_micro, n_periods, mb, ...) assembled across the
    stages in layer order; None on the row's other stages (they send
    theirs to the first). ``periods_per_stage`` declares a ragged
    partition: each stage keeps its first ``periods_per_stage[s]`` tap
    slots (the rest are its slab's padding) before sending them.
    """
    S, s = mesh.stages, mesh.stage
    n_micro = x_micro.shape[0]
    row = mesh.row_ranks
    outs, taps, pending = [], [], []
    for m in range(n_micro):
        h = x_micro[m] if s == 0 else mesh.recv_tree(row[s - 1], group=mesh.row_group)
        y = stage_fn(stage_params, h)
        if collect_taps:
            y, t = y
            if periods_per_stage is not None:
                t = t[: periods_per_stage[s]]
            taps.append(t)
        if s < S - 1:
            pending.append(mesh.send_tree(y, row[s + 1], group=mesh.row_group, slot=m,
                                          wait=False))
        else:
            outs.append(y)
    for work in pending:
        work.wait()

    mine = stack(taps, 0) if collect_taps else None  # (n_micro, pp_s, mb, ...)
    if s > 0:  # hand the row's first stage this stage's taps, and the outputs from the last
        if collect_taps:
            mesh.send_tree(mine, row[0], group=mesh.row_group)
        if s == S - 1:
            mesh.send_tree(torch.stack(outs), row[0], group=mesh.row_group)
        return None
    parts = [mine] + ([mesh.recv_tree(row[k], group=mesh.row_group) for k in range(1, S)]
                      if collect_taps else [])
    outs = torch.stack(outs) if S == 1 else mesh.recv_tree(row[S - 1], group=mesh.row_group)
    if not collect_taps:
        return outs
    return outs, _cat(parts, 1)
