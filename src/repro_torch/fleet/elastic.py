"""ElasticDpRunner — the elastic pure-DP cached train step (counterpart
of ``repro.fleet.elastic``).

Cached epochs are pure data parallelism over activation-cache entries
(no backbone forward), so fleet membership changes are a *resharding*
problem: move work units between devices, replay nothing. The runner
makes resharding **numerically invisible** by construction:

* The work unit is a fixed-size **chunk** of the global batch (default
  one sequence). Each chunk produces its CE parts and the gradient of
  its CE numerator — ``(num_i, den_i, ∇num_i)`` — on whichever member
  device owns it this step (``torch.autograd.grad`` of ``num`` over the
  adapter's leaves; ``den``, the token count, takes none).
* Results are summed **in canonical chunk order** (0, 1, 2, …), in f32,
  starting from chunk 0's tensors, never in member order. The reference
  sums on the host; the port sums on the job's home device, which is as
  placement-invariant (the same additions in the same order) and spares
  copying the adapter's f32 gradient to the host for every chunk. The
  host syncs once a step, for the loss.
* The adapter update then runs once: ``loss = Σnum / max(Σden, 1)``,
  ``grads = Σ∇num / max(Σden, 1)``, then the clip + AdamW of the
  single-device cached step (:func:`repro_torch.core.steps._apply`) —
  the math of :func:`~repro_torch.core.steps.pac_cached_train_step`,
  reassociated at chunk granularity.

Each member holds a **backbone replica** on its device (placement time:
growing onto a joined device ships weights, never recomputes
activations). ``Tensor.to`` is a no-op on the member's own device, so
members that share one card share one backbone. The adapter is
re-replicated every step (it just changed); it is 1/r²-sized, the
paper's asymmetry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.quantization import tree_leaves, tree_map


def assign_chunks(n_chunks: int, n_members: int,
                  weights: Optional[Sequence[float]] = None) -> List[int]:
    """Deterministic proportional chunk counts per member.

    Largest-remainder rounding of ``n_chunks · w_i/Σw`` with ties broken
    by member order — the planner-free fallback for chunk dispatch (the
    scheduler normally prices shares with Eq. (4) via
    :meth:`~repro_torch.fleet.job.SessionJob.plan_shares`)."""
    if n_members < 1:
        raise ValueError("need at least one member")
    w = [1.0] * n_members if weights is None else [float(x) for x in weights]
    if len(w) != n_members or any(x < 0 for x in w) or sum(w) <= 0:
        raise ValueError(f"bad weights {w} for {n_members} members")
    total = sum(w)
    raw = [n_chunks * x / total for x in w]
    counts = [int(r) for r in raw]
    order = sorted(range(n_members), key=lambda i: (-(raw[i] - counts[i]), i))
    for i in order[: n_chunks - sum(counts)]:
        counts[i] += 1
    return counts


def slice_cached(cached: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of a cached training batch. ``taps`` carry the
    batch on axis 1 (``(n_p, B, S, d)``); every other entry (b0,
    b_final, labels) on axis 0. An int8 entry, a
    :class:`~repro_torch.core.quantization.QTensor` leaf, is sliced in
    its payload and its scales alike and keeps ``bits``, ``block`` and
    ``orig_last``. Works on tensors and numpy arrays alike."""
    out = {}
    for k, v in cached.items():
        if k == "taps":
            out[k] = tree_map(lambda t: t[:, lo:hi], v)
        else:
            out[k] = tree_map(lambda t: t[lo:hi], v)
    return out


def _chunk_parts(backbone, adapter, chunk, *, cfg, r, kernel_impl):
    """(num, den, ∇num) for one chunk, on the chunk's device."""
    from repro_torch.core.steps import _cached_positions
    from repro_torch.kernels.cached_step import cached_loss_parts

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), adapter)
    num, den = cached_loss_parts(backbone, leaves, cfg, chunk, _cached_positions(chunk, cfg), r,
                                 impl=kernel_impl)
    grads = iter(torch.autograd.grad(num, tree_leaves(leaves)))
    return num.detach(), den, tree_map(lambda _: next(grads), leaves)


class ElasticDpRunner:
    """Layout-independent cached steps for one job over a member subset.

    ``placement`` at each step is ``[(member, device_or_None, share),
    ...]`` — shares must sum to the batch's chunk count. ``device=None``
    runs the member's chunks on the runner's home ``device`` (the
    backbone's; ``None`` there is the card); numerics are identical
    either way.
    """

    def __init__(self, backbone, cfg, *, r: int = 8, lr=3e-3, clip=1.0,
                 kernel_impl: str = "ref", chunk: int = 1, device=None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.backbone = backbone
        self.cfg = cfg
        self.r, self.lr, self.clip = r, lr, clip
        self.kernel_impl = kernel_impl
        self.chunk = chunk
        self.device = resolve_device(device)
        self._replicas: Dict[str, object] = {}   # member -> backbone on its device
        self.n_reshards = 0

    # -- membership ---------------------------------------------------------

    def reshard(self, members: Sequence[Tuple[str, object]]) -> None:
        """Adopt a new member set: drop replicas of departed members,
        ship the backbone to joiners' devices (weights only — the cache
        already holds every activation, so growth does zero backbone
        forwards). Call between steps."""
        names = {n for n, _ in members}
        for n in list(self._replicas):
            if n not in names:
                del self._replicas[n]
        for n, dev in members:
            if dev is not None and n not in self._replicas:
                self._replicas[n] = tree_map(lambda t: t.to(dev), self.backbone)
        self.n_reshards += 1

    def members(self) -> List[str]:
        return list(self._replicas)

    # -- the step -----------------------------------------------------------

    def n_chunks(self, batch_size: int) -> int:
        if batch_size % self.chunk:
            raise ValueError(
                f"batch {batch_size} not divisible into chunks of {self.chunk}")
        return batch_size // self.chunk

    def loss_and_grads(self, adapter, cached: dict,
                       placement: Sequence[Tuple[str, object, int]]):
        """``(loss, grads)`` of one cached batch, on the home device: the
        chunks run on their owners' devices and their parts are summed in
        canonical chunk order, so both are bit-identical for any placement."""
        n_chunks = self.n_chunks(cached["labels"].shape[0])
        shares = [int(s) for _, _, s in placement]
        if sum(shares) != n_chunks:
            raise ValueError(
                f"placement shares {shares} must cover {n_chunks} chunks")
        owners: List[Tuple[str, object]] = []
        for (name, dev, _), s in zip(placement, shares):
            owners.extend([(name, dev)] * s)

        # one adapter transfer per member device (it changed last step)
        local_adapter: Dict[str, object] = {}
        for name, dev, s in placement:
            if s and dev is not None:
                local_adapter[name] = tree_map(lambda t: t.to(dev), adapter)

        home = self.device
        num = den = grad_sum = None
        for ci in range(n_chunks):
            name, dev = owners[ci]
            piece = slice_cached(cached, ci * self.chunk, (ci + 1) * self.chunk)
            piece = tree_map(lambda t: t.to(home if dev is None else dev), piece)
            n_i, d_i, g_i = _chunk_parts(
                self._replicas.get(name, self.backbone), local_adapter.get(name, adapter),
                piece, cfg=self.cfg, r=self.r, kernel_impl=self.kernel_impl)
            n_i, d_i, g_i = tree_map(lambda t: t.to(home), (n_i, d_i, g_i))
            # canonical-order accumulation: the float sums associate by
            # chunk index, never by device layout — resharding cannot
            # perturb them
            if ci == 0:
                num, den, grad_sum = n_i, d_i, g_i
            else:
                num, den = num + n_i, den + d_i
                g_it = iter(tree_leaves(g_i))
                grad_sum = tree_map(lambda a: a + next(g_it), grad_sum)
        den = torch.clamp_min(den, 1)
        return num / den, tree_map(lambda g: g / den, grad_sum)

    def step(self, adapter, opt_state, cached: dict,
             placement: Sequence[Tuple[str, object, int]]):
        """One elastic cached step. Returns ``(loss, adapter, opt_state)``
        — bit-identical for any placement of the same batch."""
        from repro_torch.core.steps import _apply

        loss, grads = self.loss_and_grads(adapter, cached, placement)
        adapter, opt_state = _apply(adapter, grads, opt_state, self.lr, self.clip)
        return float(loss), adapter, opt_state
