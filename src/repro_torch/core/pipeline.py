"""The hybrid data + pipeline parallel runtime (paper §V-A) on
``torch.distributed`` (counterpart of ``repro.core.pipeline``).

* **Schedule** — :func:`build_1f1b_schedule` emits the paper's
  one-forward-one-backward micro-batch order (Fig. 10b) and
  :func:`validate_schedule` checks it (dependencies, in-flight bound).
* **Stage slabs** — :func:`stack_stages` and :func:`stack_stages_ragged`
  re-chunk period-stacked block parameters into per-stage slabs, even
  or along a planner partition's uneven boundaries.
* **Runtime** — :func:`pipeline_apply` runs one dp row's stages as a
  point-to-point pipeline. Stage ``s`` takes the micro-batches in order
  (every stage's F order in the 1F1B schedule), taking micro ``m`` from
  stage ``s-1`` and handing its output on with a non-blocking send, so
  stages overlap across micro-batches. The PAC+ trainer's backbone is
  frozen (the reference stops the gradient at the activations), so its
  run is the forward alone.
* **Backward** — :func:`pipeline_grads` (the reference's
  ``value_and_grad`` of a pipelined loss) differentiates through
  :func:`pipeline_apply` when stages require grad: the gradients of the
  outputs and taps gathered on a row's first stage go back to the
  stages that made them, and each stage runs its backward in its 1F1B
  order (:class:`_StageRecord`: at most ``S − s`` micro-batches' graphs
  alive, the rest rebuilt from their saved inputs), sending its input's
  gradient to the stage before. The gradients of a stage's parameters
  are summed over its micro-batches in micro order, then over the dp
  rows.

* **Simulator** — :func:`simulate_plan` replays a planner
  :class:`~repro_torch.core.planner.Plan` through a discrete-event model
  of the 1F1B schedule over the plan's stage times (the planner's
  estimate for its modelled devices, not a time on this machine).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.quantization import QTensor, stack, tree_leaves, tree_map

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


def _grad_inputs(tree) -> list:
    """The tensors of ``tree`` that require grad, in tree order."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.requires_grad]


def _detach(x):
    """``x`` (a tensor, a QTensor or None) cut from its graph."""
    return None if x is None else map_arrays(lambda a: a.detach(), x)


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, mesh, *,
                   collect_taps: bool = False,
                   periods_per_stage: Optional[Sequence[int]] = None):
    """Run this rank's stage of its dp row's pipeline over the micro-batches.

    A stage takes the micro-batches in order, which is the F order of
    every stage in :func:`build_1f1b_schedule`, and sends each on as soon
    as it is done, so the stages overlap across micro-batches.

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

    **Differentiable** inside :func:`pipeline_grads`. A stage *engages*
    when grad mode is on and a tensor of its ``stage_params``, or its
    input (the first stage's ``x_micro``, or the activations an engaged
    stage sent), requires grad: it sends its activations with the
    header's grad flag, so the stages after it engage too, and keeps
    what its backward needs (:class:`_StageRecord`). On the first stage
    the outputs and taps then carry a graph: their gradients go back to
    the stages that made them, and each engaged stage runs its backward
    in its 1F1B order. When no stage engages (PAC+'s frozen backbone)
    the run is the forward alone: the same messages and bytes, no graph
    kept. An engaged call outside :func:`pipeline_grads` raises
    ``RuntimeError``, since nothing would drive the later stages'
    backward.
    """
    S, s = mesh.stages, mesh.stage
    n_micro = x_micro.shape[0]
    row = mesh.row_ranks
    pp = None if periods_per_stage is None else periods_per_stage[s]
    grad_on = torch.is_grad_enabled()
    trainable = grad_on and bool(_grad_inputs(stage_params))
    rec, outs, taps, pending = None, [], [], []
    for m in range(n_micro):
        h = x_micro[m] if s == 0 else mesh.recv_tree(row[s - 1], group=mesh.row_group)
        if m == 0 and (trainable or (grad_on and h.requires_grad)):
            rec = _StageRecord(stage_fn, stage_params, mesh, n_micro, collect_taps, pp,
                               input_grad=h.requires_grad)
        if rec is not None:
            y, t = rec.forward(m, h)
        else:
            y = stage_fn(stage_params, h)
            if collect_taps:
                y, t = y
                if pp is not None:
                    t = t[:pp]
        if collect_taps:
            taps.append(t)
        if s < S - 1:
            pending.append(mesh.send_tree(y, row[s + 1], group=mesh.row_group, slot=m,
                                          wait=False, grad=rec is not None))
        else:
            outs.append(y)
    for work in pending:
        work.wait()

    mine = stack(taps, 0) if collect_taps else None  # (n_micro, pp_s, mb, ...)
    if s > 0:  # hand the row's first stage this stage's taps, and the outputs from the last
        if collect_taps:
            mesh.send_tree(mine, row[0], group=mesh.row_group, grad=rec is not None)
        if s == S - 1:
            mesh.send_tree(torch.stack(outs), row[0], group=mesh.row_group, grad=rec is not None)
        if rec is not None:
            tape = _engaged_tape()
            tape.rec = rec
            tape.node = _StageNode.apply(rec, tape.anchor, *rec.inputs)
        return None
    parts = [mine] + ([mesh.recv_tree(row[k], group=mesh.row_group) for k in range(1, S)]
                      if collect_taps else [])
    outs = torch.stack(outs) if S == 1 else mesh.recv_tree(row[S - 1], group=mesh.row_group)
    if rec is None and not outs.requires_grad:
        return (outs, _cat(parts, 1)) if collect_taps else outs
    # the row engaged: the gathered values enter the graph through one node
    tape = _engaged_tape()
    tape.rec = rec
    first = _RowRecord(mesh, rec, outs, parts if collect_taps else None)
    node, outs, *rest = _RowNode.apply(first, tape.anchor, x_micro,
                                       *(rec.inputs if rec is not None else ()))
    tape.node = node
    if not collect_taps:
        return outs
    return outs, rest[0] if rest else first.taps


# ---------------------------------------------------------------------------
# The backward through the pipeline
# ---------------------------------------------------------------------------


class _Tape:
    """One :func:`pipeline_grads` call on this rank: the anchor leaf that
    the engaged call's autograd node takes as an input (so that autograd
    runs the node even where no trainable leaf lies behind it), the node
    and this stage's :class:`_StageRecord`."""

    def __init__(self, device):
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.node = None
        self.rec = None


_TAPE: Optional[_Tape] = None  # the open pipeline_grads call on this rank


def _engaged_tape() -> _Tape:
    if _TAPE is None:
        raise RuntimeError("pipeline_apply: a stage requires grad, so the call must run inside "
                           "pipeline_grads, which drives the later stages' backward")
    if _TAPE.node is not None:
        raise RuntimeError("pipeline_grads takes one pipeline_apply whose stages require grad "
                           "in its loss_fn")
    return _TAPE


class _StageRecord:
    """One engaged stage's half of the backward pipeline.

    The forward keeps the graph of the first ``S − s`` micro-batches (the
    ones 1F1B runs forward before this stage's first backward) and only
    the input of the others. The backward walks this stage's ops of
    :func:`build_1f1b_schedule`: an F rebuilds a micro-batch's graph from
    its saved input, a B takes the gradient of the micro-batch's output
    (from stage s+1, or from the row's first stage for the last stage)
    and of its taps, runs autograd on that graph alone, sends the
    input's gradient to stage s−1 (non-blocking, like the forward's
    sends) and adds the parameters' gradients to their sum, in micro
    order. So no more than ``S − s`` graphs are ever alive, the bound
    :func:`validate_schedule` checks; ``ops`` lists the F and B ops run
    with a graph, in order."""

    def __init__(self, stage_fn, params, mesh, n_micro: int, collect_taps: bool, pp,
                 input_grad: bool):
        self.fn, self.mesh, self.M = stage_fn, mesh, n_micro
        self.S, self.s = mesh.stages, mesh.stage
        self.collect_taps, self.pp, self.input_grad = collect_taps, pp, input_grad
        self.inputs = _grad_inputs(params)  # the caller's tensors: the node's inputs
        # the graphs are built on detached copies, so each micro-batch's
        # autograd stops at this stage's parameters
        self.params = tree_map(lambda t: t.detach().requires_grad_(True)
                               if isinstance(t, torch.Tensor) and t.requires_grad else t, params)
        self.leaves = _grad_inputs(self.params)
        self.keep = min(self.S - self.s, n_micro)
        self.graphs, self.saved, self.ops = {}, {}, []
        self.tap_grad = False

    def _split(self, out):
        y, t = out if self.collect_taps else (out, None)
        if t is not None and self.pp is not None:
            t = t[:self.pp]
        return y, t

    def _run(self, m: int, h):
        h = h.detach().requires_grad_(self.input_grad)
        with torch.enable_grad():
            y, t = self._split(self.fn(self.params, h))
        self.tap_grad = _differentiable(t)
        self.graphs[m] = (h, y, t)
        self.ops.append(Op(self.s, m, "F"))
        return y, t

    def forward(self, m: int, h):
        """The forward's micro-batch ``m``: (output, taps), cut from the graph."""
        if m < self.keep:
            y, t = self._run(m, h)
        else:
            self.saved[m] = h.detach()
            with torch.no_grad():
                y, t = self._split(self.fn(self.params, self.saved[m]))
        return y.detach(), _detach(t)

    def backward(self, g_out=None, g_taps=None):
        """This stage's backward; on later stages the gradients of the
        outputs (last stage) and of the taps come from the row's first
        stage. Returns (the input's gradient stacked over the
        micro-batches, on the first stage when its input requires grad,
        else None; the gradients of ``inputs``)."""
        mesh, S, s, row = self.mesh, self.S, self.s, self.mesh.row_ranks
        if s > 0:
            if self.tap_grad:
                g_taps = mesh.recv_tree(row[0], group=mesh.row_group)
            if s == S - 1:
                g_out = mesh.recv_tree(row[0], group=mesh.row_group)
        acc, gx, sends = None, [], []
        for op in build_1f1b_schedule(S, self.M)[s]:
            m = op.micro
            if op.kind == "F":
                if m not in self.graphs:
                    self._run(m, self.saved.pop(m))
                continue
            h, y, t = self.graphs.pop(m)
            gy = g_out[m] if s == S - 1 else mesh.recv_tree(row[s + 1], group=mesh.row_group)
            outs, seeds = [y], [gy]
            if self.tap_grad:
                outs.append(t)
                seeds.append(g_taps[m])
            wrt = ([h] if self.input_grad else []) + self.leaves
            g = torch.autograd.grad(outs, wrt, seeds, allow_unused=True, materialize_grads=True)
            del h, y, t, outs
            if self.input_grad:
                if s > 0:
                    sends.append(mesh.send_tree(g[0], row[s - 1], group=mesh.row_group,
                                                slot=m, wait=False))
                else:
                    gx.append(g[0])
                g = g[1:]
            if acc is None:
                acc = list(g)
            else:  # in place: no second slab-sized sum alive at once
                for a, b in zip(acc, g):
                    a.add_(b)
            self.ops.append(op)
        for work in sends:
            work.wait()
        return (torch.stack(gx) if gx else None), acc


class _RowRecord:
    """The row's first stage when its row engaged: the gathered outputs
    and taps, which stage made which tap slots, and which stages' taps
    and outputs carry a gradient back."""

    def __init__(self, mesh, rec, outs, parts):
        self.mesh, self.rec = mesh, rec
        self.outs_grad = outs.requires_grad
        self.outs = outs.detach()
        self.taps = None
        if parts is not None:
            self.tap_grad = [rec is not None and rec.tap_grad] + [
                _differentiable(p) and p.requires_grad for p in parts[1:]]
            parts = [_detach(p) for p in parts]
            self.sizes = [p.shape[1] for p in parts]
            self.taps = _cat(parts, 1)

    def backward(self, g_outs, g_taps):
        mesh, S, row = self.mesh, self.mesh.stages, self.mesh.row_ranks
        sends = []
        pieces = g_taps.split(self.sizes, dim=1) if g_taps is not None else None
        for k in range(1, S):  # in the order the stages' taps arrived, then the outputs
            if pieces is not None and self.tap_grad[k]:
                sends.append(mesh.send_tree(pieces[k].contiguous(), row[k], group=mesh.row_group,
                                            slot=("tap grad", k), wait=False))
        if S > 1 and self.outs_grad:
            sends.append(mesh.send_tree(g_outs.contiguous(), row[S - 1], group=mesh.row_group,
                                        slot="output grad", wait=False))
        gx, grads = None, []
        if self.rec is not None:
            gx, grads = self.rec.backward(g_out=g_outs if S == 1 else None,
                                          g_taps=pieces[0] if self.rec.tap_grad else None)
        for work in sends:
            work.wait()
        return gx, grads


class _StageNode(torch.autograd.Function):
    """A later stage's engaged call in the autograd graph: a 0-d zero that
    :func:`pipeline_grads` seeds; its backward is the stage's
    :meth:`_StageRecord.backward`."""

    @staticmethod
    def forward(ctx, rec, anchor, *inputs):
        ctx.rec = rec
        return anchor.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        _, grads = ctx.rec.backward()
        return (None, None, *grads)


class _RowNode(torch.autograd.Function):
    """The row's first stage: the gathered outputs (and float taps) enter
    the graph here, beside a 0-d zero that :func:`pipeline_grads` seeds.
    Its backward sends their gradients to the stages that made them, then
    runs this stage's own part."""

    @staticmethod
    def forward(ctx, first, anchor, x, *inputs):
        ctx.first = first
        taps = (first.taps.detach(),) if _differentiable(first.taps) else ()
        return (anchor.new_zeros(()), first.outs.detach()) + taps

    @staticmethod
    def backward(ctx, _, g_outs, *g_taps):
        gx, grads = ctx.first.backward(g_outs, g_taps[0] if g_taps else None)
        return (None, None, gx, *grads)


def carry_grad(value: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``value`` (e.g. a loss summed over the dp rows by an all-reduce,
    which autograd does not cross) carrying the gradient of this rank's
    own part ``local``: ``value + (local − local.detach())``, whose value
    is ``value``'s bit for bit."""
    return value + (local - local.detach())


def pipeline_grads(loss_fn: Callable, trainable, frozen, batch_micro, mesh, *,
                   shared: str = "stage", trace: Optional[list] = None):
    """The loss and its gradient over ``trainable``, through the pipeline
    (the reference's ``value_and_grad`` of a micro-batched pipelined loss).

    Run on every rank of the mesh (the spawned layout, as the epoch-1
    step runs). ``loss_fn(trainable, frozen, batch_micro, mesh)`` returns
    the loss where it is known (a dp row's first stage at least, where
    :func:`pipeline_apply` returns the outputs; None elsewhere will do)
    and may call :func:`pipeline_apply` once with stages that require
    grad. ``trainable``: this rank's own float leaves (its stage's slab,
    and on the first stage whatever that stage holds); ``frozen`` and
    ``batch_micro`` pass through.

    The backward runs from the loss on each row's first stage and from
    the engaged stages' nodes elsewhere (:class:`_StageRecord`). Then
    each gradient is summed over the ranks that hold its leaf:
    ``shared="stage"`` over this rank's stage across the dp rows (a
    slab: the reference's sum over the batch axis; nothing to sum at dp
    1), ``shared="world"`` over every rank (a tree every rank holds, such
    as PAC+'s adapter). Returns (loss, grads) on every rank: the loss of
    the row's first stage (a 0-d f32 on the later stages), the gradients
    in ``trainable``'s structure. ``trace``, when a list, gets the F and B
    ops this rank ran with a graph, in order."""
    global _TAPE
    if shared not in ("stage", "world"):
        raise ValueError(f"shared must be 'stage' or 'world', got {shared!r}")
    if _TAPE is not None:
        raise RuntimeError("pipeline_grads calls do not nest")
    mesh = getattr(mesh, "spawned", mesh)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
    flat = tree_leaves(leaves)
    tape = _TAPE = _Tape(mesh.device)
    try:
        loss = loss_fn(leaves, frozen, batch_micro, mesh)
    finally:
        _TAPE = None
    outputs = ([loss] if loss is not None and loss.requires_grad else []) + (
        [tape.node] if tape.node is not None else [])
    if outputs:
        wrt = flat + ([tape.anchor] if tape.node is not None else [])
        grads = torch.autograd.grad(outputs, wrt, [torch.ones_like(o) for o in outputs],
                                    allow_unused=True, materialize_grads=True)[:len(flat)]
    else:
        grads = [torch.zeros_like(t) for t in flat]
    if trace is not None and tape.rec is not None:
        trace.extend(tape.rec.ops)
    if mesh.stage == 0 and loss is None:
        raise ValueError("loss_fn returned None on a dp row's first stage")
    if mesh.stages > 1:
        own = loss.detach() if mesh.stage == 0 else None
        loss = mesh.row_broadcast(own if own is not None else torch.zeros(()))
        loss = own if own is not None else loss
    else:
        loss = loss.detach()
    grads = list(grads)
    if grads:  # every rank that sums with this one holds a tree of this structure
        grads = (mesh.all_reduce_tree(grads) if shared == "world"
                 else mesh.all_reduce_stage_tree(grads))
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), leaves)
