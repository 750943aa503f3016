"""The (dp, stage) mesh of the hybrid DP x PP trainer on
``torch.distributed`` (counterpart of ``repro.launch.mesh.make_edge_mesh``).

Where the reference lays a 2-D device mesh out for ``shard_map``, the
port runs ``dp·stages`` processes, one rank each, and moves tensors
between them explicitly:

* **layout** — rank ``i`` sits at ``(i // stages, i % stages)``, the
  reference's device order: a dp row's ranks are consecutive;
* **groups** — one per dp row (the stage hand-offs) and the world (the
  epoch-1 step's all-reduce, in which ranks whose rows another rank
  counts add zeros, the owner's gather and scatter, and its hit/miss
  flag); one per stage across the dp rows, made at the first
  :meth:`EdgeMesh.all_reduce_stage_tree` (the sum of a stage's
  parameter gradients over the rows). :meth:`EdgeMesh.reshard` makes a sub-mesh of the world's ranks
  active, at another dp: a gloo group over its ranks (none when they
  are the whole world) then carries the cached step's all-reduce and
  the owner's state broadcast, while the epoch-1 step keeps the spawned
  layout (:attr:`EdgeMesh.spawned`). A rank outside the active mesh is
  parked and joins only the world's flag. Each reshard destroys the
  sub-group it replaces, and :meth:`EdgeMesh.close` the rest;
* **device** — rank ``i`` computes on ``cuda:{i % device_count}``, or on
  the CPU when asked, so several ranks may share one card;
* **transfers** — :meth:`EdgeMesh.send_tree`, :meth:`EdgeMesh.recv_tree`,
  :meth:`EdgeMesh.all_reduce_tree` move tensors and :class:`~repro_torch.core.quantization.QTensor`\\ s
  (payload, scales and metadata). A point-to-point message carries a
  fixed-size header first, so the receiver needs no shapes, nor whether
  a float tensor requires grad (a flag the backward pipeline reads). The process
  group is gloo: ranks sharing a card rule NCCL out, and gloo has no
  point-to-point for CUDA tensors, so every tensor that leaves a card is
  staged through pinned host buffers kept for the next message.

:func:`spawn` runs a function on every rank: ``spawn`` start method (the
parent may hold a CUDA context), a ``file://`` store in a temporary
directory (no port), a gloo timeout, and a deadline on the parent's
join. A rank that fails, or one still running at the deadline, fails
the whole run; nothing falls back to one process.

:func:`plan_mesh_shape` is the twin of the reference's
``make_plan_mesh``: the ``(dp, stages)`` a planner partition executes on
over a device pool. The reference's production mesh
(``repro/launch/mesh.py:18``) lays one XLA program over 256–512 devices
and has no twin: the dry run prices one rank of an :class:`EdgeMesh`
layout instead (:mod:`repro_torch.launch.dryrun`). The roofline's
constants (``repro/launch/mesh.py:74-77``) have their twins here, the
card's own: ``PEAK_FLOPS_BF16``, ``PEAK_FLOPS_F32``, ``HBM_BW`` and
``LINK_BW``.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quantization import QTensor, tree_leaves, tree_map

BACKEND = "gloo"

# The card's peaks for the roofline (:mod:`repro_torch.launch.roofline`)
# and every bound ``chip_smoke.py`` writes: NVIDIA H100 SXM5 data sheet, the
# card the smoke reports as ``NVIDIA H100 80GB HBM3, 700.00 W``.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12  # f32 on the CUDA cores, FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
LINK_BW = 450e9  # NVLink 4, bytes/s one direction (900 GB/s both ways)
#: int64 slots of a point-to-point header (:func:`_describe`)
HEADER = 64
#: added to a header's dtype slot: the float tensor requires grad
GRAD_FLAG = 1 << 8
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32, torch.int64,
           torch.uint8, torch.bool)


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` for the
    card, or the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# Point-to-point headers
# ---------------------------------------------------------------------------


def _arrays(x) -> list:
    return [] if x is None else [x.q, x.scale] if isinstance(x, QTensor) else [x]


def _describe(tree, grad: bool = False) -> List[int]:
    """The header of ``tree``: a tensor, a QTensor, None, or a tuple of
    those. Per item: kind (0 None, 1 tensor, 2 QTensor), the QTensor's
    bits, block and orig_last, then each array's dtype, ndim and shape.
    ``grad`` adds :data:`GRAD_FLAG` to the dtype of every float tensor
    item (not a QTensor's arrays)."""
    items = tree if isinstance(tree, tuple) else (tree,)
    head = [int(isinstance(tree, tuple)), len(items)]
    for x in items:
        head.append(0 if x is None else 2 if isinstance(x, QTensor) else 1)
        if isinstance(x, QTensor):
            head += [x.bits, x.block, x.orig_last]
        flag = GRAD_FLAG if grad and isinstance(x, torch.Tensor) and x.is_floating_point() else 0
        for a in _arrays(x):
            head += [_DTYPES.index(a.dtype) + flag, a.ndim, *a.shape]
    if len(head) > HEADER:
        raise ValueError(f"tree too deep for a {HEADER}-slot header: {len(head)} slots")
    return head + [0] * (HEADER - len(head))


def _parse(head: Sequence[int]):
    """(is_tuple, [(kind, qtensor meta, [(dtype, shape, grad), ...]), ...])."""
    it = iter(head)
    is_tuple, n = next(it), next(it)
    items = []
    for _ in range(n):
        kind = next(it)
        meta = (next(it), next(it), next(it)) if kind == 2 else None
        specs = []
        for _ in range(kind):  # kind counts the arrays: 0, 1 or 2
            code, ndim = next(it), next(it)
            specs.append((_DTYPES[code % GRAD_FLAG], tuple(next(it) for _ in range(ndim)),
                          code >= GRAD_FLAG))
        items.append((kind, meta, specs))
    return bool(is_tuple), items


def plan_mesh_shape(partition, pool: int, micro_batch: int) -> tuple:
    """The ``(dp, stages)`` mesh a planner
    :class:`~repro_torch.core.planner.StagePartition` executes on over
    ``pool`` devices: the plan's stage count, and the widest replica
    count up to ``pool // stages`` that divides the micro-batch (the
    uniform-mesh rendering of the plan's per-stage device groups)."""
    stages = partition.n_stages
    dp = max(1, pool // stages)
    while dp > 1 and micro_batch % dp:
        dp -= 1
    return dp, stages


class _Sends:
    """The pending sends of one :meth:`EdgeMesh.send_tree`, holding their
    host buffers until :meth:`wait`."""

    def __init__(self, works, buffers):
        self._works, self._buffers = works, buffers

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._buffers = ()


class EdgeMesh:
    """One rank's view of the ``(dp, stage)`` mesh. Every rank constructs
    it, in the same order as its peers (group creation is collective),
    after ``torch.distributed`` is initialised with ``dp·stages`` ranks.

    ``dp``, ``world``, ``rank`` (the position in the active mesh),
    ``dp_rank``, ``stage`` and ``owner`` describe the active mesh: the
    spawned one until :meth:`reshard`. ``members`` are the world ranks of
    the active mesh in position order; ``world_rank`` is this process's
    rank in the world; ``spawned`` (:class:`SpawnedMesh`) is the mesh as
    spawned, the epoch-1 step's fixed layout over this one's transfers.

    ``device``: this rank's device (default :func:`rank_device`).
    ``stats`` counts the bytes this rank sent point to point,
    all-reduced and broadcast, and the host seconds spent in each."""

    def __init__(self, dp: int, stages: int, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError("EdgeMesh needs torch.distributed initialised (see spawn())")
        world = dist.get_world_size()
        if world != dp * stages:
            raise ValueError(f"a {dp}×{stages} (dp, stage) mesh needs {dp * stages} ranks, "
                             f"the process group has {world}")
        self.stages = stages
        self.world_rank = dist.get_rank()
        self.device = rank_device(self.world_rank) if device is None else torch.device(device)
        row = self.world_rank // stages
        self.row_ranks = list(range(row * stages, (row + 1) * stages))
        rows = [dist.new_group(list(range(r * stages, (r + 1) * stages))) for r in range(dp)]
        self.row_group = rows[row]
        self._groups = [self.row_group]
        self._dp0 = dp
        self._stage_group = None  # made at the first all_reduce_stage_tree
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self.stats = {"p2p_bytes": 0, "p2p_s": 0.0, "allreduce_bytes": 0, "allreduce_s": 0.0,
                      "broadcast_bytes": 0, "broadcast_s": 0.0}
        self._activate(dp, tuple(range(world)), None)
        self.spawned = SpawnedMesh(self, dp)

    def _activate(self, dp: int, members: tuple, group) -> None:
        self.dp, self.members, self.group = dp, members, group
        self.rank = members.index(self.world_rank) if self.world_rank in members else None
        self.dp_rank, self.stage = (None, None) if self.rank is None else divmod(self.rank,
                                                                               self.stages)

    @property
    def world(self) -> int:
        """The active mesh's rank count, ``dp·stages``."""
        return self.dp * self.stages

    @property
    def active(self) -> bool:
        """False on a rank that the last :meth:`reshard` parked."""
        return self.rank is not None

    @property
    def owner(self) -> bool:
        """Rank 0: the single controller that holds the activation cache."""
        return self.rank == 0

    def describe(self) -> str:
        """Backend, ranks and the cards they share, for the ``mesh:`` line."""
        if self.device.type == "cpu":
            return f"{BACKEND}, {self.world} ranks on the CPU"
        cards = min(self.world, torch.cuda.device_count())
        return (f"{BACKEND}, {self.world} ranks on {cards} card{'s' if cards > 1 else ''} "
                f"({torch.cuda.get_device_name(self.device)})")

    def reshard(self, dp: int, ranks: Optional[Sequence[int]] = None) -> None:
        """Make ``ranks`` (world ranks in position order; default the first
        ``dp·stages``) the active mesh at ``dp``, keeping the stage count.
        Every rank of the world calls it, in the same order (a new group
        is collective over the world, members or not). The checks run
        first, alike on every rank: ``ValueError`` for dp < 1, more ranks
        than the world, a rank out of range or repeated, or rank 0 (the
        cache's owner) not at position 0. A rank outside ``ranks`` is
        parked (``active`` False) until a later reshard takes it back."""
        world = self.spawned.world
        n = dp * self.stages
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if n > world:
            raise ValueError(f"a {dp}×{self.stages} (dp, stage) mesh needs {n} ranks, "
                             f"the world has {world}")
        members = tuple(range(n)) if ranks is None else tuple(int(r) for r in ranks)
        if len(members) != n:
            raise ValueError(f"a {dp}×{self.stages} (dp, stage) mesh needs {n} ranks, "
                             f"got {len(members)}")
        if len(set(members)) != n or not all(0 <= r < world for r in members):
            raise ValueError(f"ranks {list(members)} must be distinct ranks of the "
                             f"{world}-rank world")
        if members[0] != 0:
            raise ValueError(f"rank 0 owns the cache and must come first, got {list(members)}")
        group = None if n == world else dist.new_group(sorted(members))
        if self.group is not None:
            self._destroy(self.group)
        mine = self.world_rank in members
        if mine and group is not None:
            self._groups.append(group)
        self._activate(dp, members, group if mine else None)

    def _destroy(self, group) -> None:
        """Destroy ``group`` and drop the pinned buffers kept for it."""
        dist.destroy_process_group(group)
        self._groups.remove(group)
        for key in [k for k in self._pinned if k[0] in ("all_reduce", "broadcast")
                    and k[1] == id(group)]:
            del self._pinned[key]

    def close(self) -> None:
        """Destroy the groups this mesh made (the row group and the active
        sub-group) and drop its pinned buffers; the world group belongs
        to whoever initialised the process group."""
        for g in list(self._groups):
            self._destroy(g)
        self._pinned.clear()

    # -- staging --------------------------------------------------------------

    def _host(self, t: torch.Tensor, key) -> torch.Tensor:
        """``t`` on the host, contiguous: a card's tensor copied into the
        pinned buffer kept under ``key``."""
        if t.device.type != "cuda":
            return t.contiguous()
        buf = self._buffer(key, t.shape, t.dtype)
        buf.copy_(t)
        return buf

    def _buffer(self, key, shape, dtype) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    # -- point to point -------------------------------------------------------

    def send_tree(self, tree, dst: int, *, group=None, slot=0, wait: bool = True,
                  grad: bool = False):
        """Send ``tree`` (a tensor, a QTensor, None, or a tuple of those)
        to global rank ``dst``: its header, then its arrays in order.
        ``wait=False`` returns the pending sends (``.wait()``); ``slot``
        then keeps concurrent sends to one peer in separate buffers.
        ``grad=True`` makes its float tensors arrive requiring grad (the
        header's flag; the bytes sent are the same)."""
        t0 = time.perf_counter()
        head = torch.tensor(_describe(tree, grad), dtype=torch.int64)
        arrays = [a.detach() for x in (tree if isinstance(tree, tuple) else (tree,))
                  for a in _arrays(x)]
        host = [self._host(a, ("send", dst, slot, i)) for i, a in enumerate(arrays)]
        works = [dist.isend(t, dst, group=group) for t in [head] + host]
        self.stats["p2p_bytes"] += sum(h.numel() * h.element_size() for h in host)
        work = _Sends(works, [head] + host)
        if wait:
            work.wait()
        self.stats["p2p_s"] += time.perf_counter() - t0
        return None if wait else work

    def recv_tree(self, src: int, *, group=None):
        """Receive a :meth:`send_tree` from global rank ``src``, on this
        rank's device; a tensor sent with ``grad=True`` arrives as a leaf
        that requires grad."""
        t0 = time.perf_counter()
        head = torch.empty(HEADER, dtype=torch.int64)
        dist.recv(head, src, group=group)
        is_tuple, items = _parse(head.tolist())
        card = self.device.type == "cuda"
        out, i = [], 0
        for kind, meta, specs in items:
            arrays = []
            for dtype, shape, grad in specs:
                buf = (self._buffer(("recv", src, i), shape, dtype) if card
                       else torch.empty(shape, dtype=dtype))
                dist.recv(buf, src, group=group)
                arrays.append((buf.to(self.device) if card else buf).requires_grad_(grad))
                i += 1
            out.append(None if kind == 0 else arrays[0] if kind == 1
                       else QTensor(arrays[0], arrays[1], *meta))
        self.stats["p2p_s"] += time.perf_counter() - t0
        return tuple(out) if is_tuple else out[0]

    # -- collectives ----------------------------------------------------------

    def _flat_collective(self, tree, op: Callable, key) -> list:
        """Run ``op`` on the leaves of ``tree`` (f32 tensors, any nesting)
        packed into one host buffer; returns the leaves' results in
        tree order, on this rank's device."""
        t0 = time.perf_counter()
        leaves = tree_leaves(tree)
        flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        host = self._host(flat, key)
        op(host)
        self.stats["allreduce_bytes"] += host.numel() * host.element_size()
        out = host.to(self.device) if host is not flat else host
        parts, at = [], 0
        for t in leaves:
            parts.append(out[at: at + t.numel()].view(t.shape))
            at += t.numel()
        self.stats["allreduce_s"] += time.perf_counter() - t0
        return parts

    def _active_group(self):
        """The active mesh's group (None: the world); a parked rank joins
        no collective of the active mesh."""
        if not self.active:
            raise RuntimeError(f"rank {self.world_rank} is parked: it joins no collective "
                               f"of the active mesh {list(self.members)}")
        return self.group

    def all_reduce_tree(self, tree):
        """The elementwise sum of ``tree`` over the active mesh, every
        member getting the same bits."""
        return self._all_reduce(tree, self._active_group())

    def broadcast_tree(self, tree):
        """The owner's ``tree`` (tensors of any dtype, in a structure every
        member shares) on every member of the active mesh, bit for bit,
        on this rank's device."""
        return self._broadcast(tree, self._active_group())

    def _all_reduce(self, tree, group):
        parts = iter(self._flat_collective(
            tree, lambda h: dist.all_reduce(h, group=group),
            ("all_reduce", id(group), len(tree_leaves(tree)))))
        return tree_map(lambda _: next(parts), tree)

    def _broadcast(self, tree, group):
        t0 = time.perf_counter()
        leaves = tree_leaves(tree)
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves])
        host = self._host(flat, ("broadcast", id(group)))
        dist.broadcast(host, 0, group=group)
        self.stats["broadcast_bytes"] += host.numel()
        out = host.to(self.device)
        parts, at = [], 0
        for t in leaves:
            n = t.numel() * t.element_size()
            parts.append(out[at: at + n].clone().view(t.dtype).view(t.shape))
            at += n
        self.stats["broadcast_s"] += time.perf_counter() - t0
        it = iter(parts)
        return tree_map(lambda _: next(it), tree)

    def broadcast_flag(self, flag: bool) -> bool:
        """The owner's ``flag`` on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int64)
        dist.broadcast(t, 0)
        return bool(t.item())

    # -- the spawned layout's rows and stages ---------------------------------

    def all_reduce_stage_tree(self, tree):
        """The elementwise sum of ``tree`` over the ranks that hold this
        rank's stage of the spawned layout, one a dp row (every member
        getting the same bits); ``tree`` itself when dp is 1. The first
        call makes one gloo group per stage, which is collective: every
        rank of the world calls it, in the same order."""
        if self._dp0 == 1:
            return tree
        if self._stage_group is None:
            S = self.stages
            # a rank outside a group gets a sentinel that holds nothing
            groups = [dist.new_group([r * S + s for r in range(self._dp0)]) for s in range(S)]
            self._stage_group = groups[self.world_rank % S]
            self._groups.append(self._stage_group)
        return self._all_reduce(tree, self._stage_group)

    def row_broadcast(self, value: torch.Tensor) -> torch.Tensor:
        """The spawned dp row's first stage's ``value`` (a 0-d float
        tensor; its shape and dtype on the other stages are ignored) as a
        0-d f32 tensor on every rank of the row, on this rank's device."""
        t0 = time.perf_counter()
        buf = value.detach().float().reshape(1).cpu() if self.world_rank == self.row_ranks[0] \
            else torch.zeros(1)
        dist.broadcast(buf, self.row_ranks[0], group=self.row_group)
        self.stats["broadcast_bytes"] += buf.numel() * buf.element_size()
        self.stats["broadcast_s"] += time.perf_counter() - t0
        return buf.to(self.device)[0]


class SpawnedMesh:
    """The mesh as spawned, which the epoch-1 step runs on whatever
    sub-mesh :meth:`EdgeMesh.reshard` made active: the world's fixed
    layout (``dp``, ``stages``, ``rank``, ``dp_rank``, ``stage``,
    ``owner``, ``members``, this rank's ``row_ranks`` and ``row_group``)
    over its :class:`EdgeMesh`'s transfers and ``stats``, its collectives
    over the world. It neither reshards nor closes."""

    def __init__(self, mesh: EdgeMesh, dp: int):
        self._mesh = mesh
        self.dp, self.stages, self.device = dp, mesh.stages, mesh.device
        self.rank = mesh.world_rank
        self.dp_rank, self.stage = divmod(self.rank, self.stages)
        self.owner = self.rank == 0
        self.members = tuple(range(dp * self.stages))
        self.row_ranks, self.row_group = mesh.row_ranks, mesh.row_group
        self.send_tree, self.recv_tree = mesh.send_tree, mesh.recv_tree
        self.all_reduce_stage_tree = mesh.all_reduce_stage_tree
        self.row_broadcast = mesh.row_broadcast

    @property
    def world(self) -> int:
        return self.dp * self.stages

    def all_reduce_tree(self, tree):
        """:meth:`EdgeMesh.all_reduce_tree` over the world."""
        return self._mesh._all_reduce(tree, None)

    def broadcast_tree(self, tree):
        """:meth:`EdgeMesh.broadcast_tree` over the world."""
        return self._mesh._broadcast(tree, None)


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, device: str, timeout: float, tmp: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(rank))  # before any allocation
    else:
        torch.set_num_threads(1)  # ranks share the host's cores
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    dist.init_process_group(BACKEND, init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
        path = os.path.join(tmp, f"rank{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, dp: int, stages: int, device: str = "cuda", *, args: tuple = (),
          timeout: float = 300.0, deadline: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on ``dp·stages`` ranks, one process each, with
    the process group initialised (gloo, ``timeout`` seconds for each
    collective); ``fn`` builds its :class:`EdgeMesh`. ``device``:
    ``"cuda"`` (rank ``i`` on ``cuda:{i % device_count}``, set before
    ``fn`` runs) or ``"cpu"`` (one thread a rank). ``fn`` and ``args``
    must pickle: a module-level function.

    ``fn`` and ``args`` reach the ranks, and their return values come
    back in rank order, through ``torch.save`` files in a private
    temporary directory (never through the start pipe, whose write would
    block on a rank that died before reading it). Raises
    ``RuntimeError`` as soon as a rank exits non-zero, or when ranks are
    still running ``deadline`` seconds after the start; every rank still
    alive is then killed."""
    world = dp * stages
    if torch.device(device).type == "cuda":
        rank_device(0)  # refuses without a card
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="edge-mesh-") as tmp:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        procs = [ctx.Process(target=_rank_main, name=f"edge-rank-{r}",
                             args=(r, world, device, timeout, tmp))
                 for r in range(world)]
        end = None if deadline is None else time.monotonic() + deadline
        try:
            for p in procs:
                p.start()
            while True:
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError("rank " + ", rank ".join(
                        f"{r} exited with code {c}" for r, c in failed))
                alive = [p.sentinel for p in procs if p.exitcode is None]
                if not alive:
                    break
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    raise RuntimeError(f"ranks still running after the {deadline} s deadline")
                multiprocessing.connection.wait(alive, timeout=left)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=30)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
