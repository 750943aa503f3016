"""PAC+ training and single-user serving steps (counterpart of
``repro.core.steps``).

* :func:`pac_loss_fn` — the epoch-1 loss of the adapter (the frozen
  forward under no grad, the reference's ``stop_gradient``);
  :func:`pac_train_step` — epoch 1: frozen (possibly quantized) backbone
  forward, then an adapter update; returns the activations for the cache.
* :func:`pac_cached_train_step` — epoch ≥ 2: adapter-only, from cached
  activations.
* :func:`pipeline_pac_train_step` — epoch 1 on a ``(dp, stage)`` mesh of
  ranks: the frozen forward pipelined over the stages, the adapter loss
  data-parallel over dp; :func:`dp_cached_train_step` — epoch ≥ 2 in pure
  data parallelism over the pool's active mesh; :func:`pipeline_pac_loss`
  and :func:`pipeline_lm_loss` — loss functions for
  :func:`~repro_torch.core.pipeline.pipeline_grads` (the adapter's loss
  over the frozen pipeline, and the backbone's own CE with its blocks
  trained through the pipeline's backward).
* :func:`full_train_step`, :func:`lora_train_step`,
  :func:`houlsby_train_step` — the paper's baselines (``core/peft.py``):
  plain ops and plain autograd through the whole backbone (the ``ref``
  attention's blocked backward), as in the reference.
* :func:`prefill_step`, :func:`decode_step`, :func:`pac_decode_step` —
  serving one user's personal model against a linear KV cache (f32, or
  INT8 from ``init_cache(kv_quant=8)``), updated in place.

Gradients are ``torch.autograd.grad`` over the adapter's leaves; the
frozen path runs under ``torch.no_grad()`` (the reference's
``stop_gradient``). Every step is functional, as in the reference: it
returns new adapter and optimizer trees and leaves its inputs alone.
Nothing in a step reads a device value back to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core import peft
from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import adapter_decode, pac_logits
from repro_torch.core.pipeline import carry_grad, map_arrays, stack_stages, stack_stages_ragged
from repro_torch.core.quantization import QTensor, index_tree, tree_leaves, tree_map
from repro_torch.models.backbone import (
    arange_positions,
    backbone_decode,
    backbone_forward,
    backbone_logits,
    cross_entropy,
    cross_entropy_parts,
    decode_periods,
    logits_from_hidden,
    run_periods,
    stage_params,
)
from repro_torch.optim import adamw_update, clip_by_global_norm


def _apply(adapter_params, grads, opt_state, lr, clip):
    """Clip the gradients' global norm (``clip=None``: no clipping), then
    one AdamW update."""
    if clip is not None:
        grads, _ = clip_by_global_norm(grads, clip)
    return adamw_update(adapter_params, grads, opt_state, lr=lr)


def _update(loss_fn, adapter_params, opt_state, lr, clip):
    """Loss, gradients over the leaves of ``adapter_params`` (whatever
    tree is trained), clip, AdamW. A leaf the loss does not read (LoRA's
    v side on an sLSTM or Mamba block) gets a zero gradient, as
    ``jax.grad`` gives it."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), adapter_params)
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), leaves)
    adapter_params, opt_state = _apply(leaves, grads, opt_state, lr, clip)
    return loss.detach(), adapter_params, opt_state


def pac_loss_fn(adapter_params, backbone_params, cfg, batch, r: int = 8):
    """The epoch-1 PAC+ loss of ``adapter_params``: the frozen backbone
    forward under no grad (the gradient highway: nothing upstream of the
    activations is differentiated), then the adapter's logits and the
    mean CE. The head and final norm sit after the side network's sum,
    so a gradient reaches them; no block and no embedding gets one."""
    with torch.no_grad():
        b_final, taps, x, positions = backbone_forward(backbone_params, cfg, batch,
                                                       collect_taps=True, return_inputs=True)
    logits = pac_logits(backbone_params, adapter_params, cfg, x, taps, b_final, positions, r)
    return cross_entropy(logits, batch["labels"])


def pac_train_step(backbone_params, adapter_params, opt_state, batch, *, cfg, r: int = 8,
                   lr=1e-3, clip=1.0, kernel_impl: str = "ref", tap_policy: str = "f32"):
    """Epoch-1 PAC+ step.

    ``kernel_impl="ref"`` runs the plain OpSet and the plain loss;
    ``"cuda"`` runs the frozen forward on still-quantized weights through
    the kernels, emits the activations in the cache's storage form
    (``tap_policy`` = the cache's compress policy) and computes the loss
    on them with the fused cached-step kernels.

    Returns (loss, adapter_params', opt_state', (b0, taps, b_final))."""
    from repro_torch.kernels.cached_step import cached_loss_parts

    ops = get_opset(kernel_impl, tap_policy)  # the ref OpSet always emits f32
    with torch.no_grad():
        b_final, taps, x, positions = backbone_forward(
            backbone_params, cfg, batch, collect_taps=True, return_inputs=True, ops=ops)
    labels = batch["labels"]
    if kernel_impl == "ref":
        def loss_fn(ap):
            return cross_entropy(pac_logits(backbone_params, ap, cfg, x, taps, b_final,
                                            positions, r), labels)

        loss, adapter_params, opt_state = _update(loss_fn, adapter_params, opt_state, lr, clip)
        return loss, adapter_params, opt_state, (x, taps, b_final)

    b0_s, bf_s = ops.emit_tap(x), ops.emit_tap(b_final)
    cached = {"b0": b0_s, "taps": taps, "b_final": bf_s, "labels": labels}

    def loss_fn(ap):
        num, den = cached_loss_parts(backbone_params, ap, cfg, cached, positions, r,
                                     impl=kernel_impl)
        return num / torch.clamp_min(den, 1)

    loss, adapter_params, opt_state = _update(loss_fn, adapter_params, opt_state, lr, clip)
    return loss, adapter_params, opt_state, (b0_s, taps, bf_s)


def _cached_positions(cached_batch, cfg):
    if "positions" in cached_batch:
        return cached_batch["positions"]
    labels = cached_batch["labels"]
    return arange_positions(cfg, *labels.shape, labels.device)


def pac_cached_train_step(backbone_params, adapter_params, opt_state, cached_batch, *, cfg,
                          r: int = 8, lr=1e-3, clip=1.0, kernel_impl: str = "ref"):
    """Epoch ≥ 2 PAC+ step: the activation cache replaces the backbone.

    cached_batch: {"b0": (B,S,d), "taps": (n_p,B,S,d), "b_final": (B,S,d),
    "labels": (B,S), optional "positions"}; each activation may be in its
    storage form (f32/bf16 tensor or int8 QTensor), decompressed on the
    device inside the step. ``kernel_impl="cuda"`` fuses the per-period
    dequant × down-projection × λ-mix and streams the LM-head CE, so
    neither f32 taps nor the logits are ever resident; ``"ref"`` upcasts
    and materialises the (B,S,vocab) logits. Only the head and final norm
    of ``backbone_params`` are read.

    Returns (loss, adapter_params', opt_state')."""
    from repro_torch.kernels.cached_step import cached_loss_parts

    positions = _cached_positions(cached_batch, cfg)

    def loss_fn(ap):
        num, den = cached_loss_parts(backbone_params, ap, cfg, cached_batch, positions, r,
                                     impl=kernel_impl)
        return num / torch.clamp_min(den, 1)

    return _update(loss_fn, adapter_params, opt_state, lr, clip)


# ---------------------------------------------------------------------------
# Hybrid DP x PP PAC+ steps (paper Fig. 10/11: the edge pool's epochs)
# ---------------------------------------------------------------------------


def _backbone_stage_fn(cfg, masked: bool = False, ops=None, collect_taps: bool = True):
    """One pipeline stage of the backbone: run the stage's periods,
    emitting each period's hidden state (a PAC+ tap) through
    ``ops.emit_tap`` (identity under the ref OpSet, the default);
    ``collect_taps=False`` returns the hidden state alone.

    ``masked=True`` is the ragged-partition variant: the stage params are
    ``{"blocks": padded_slab, "mask": (max_pp,)}`` (see
    ``pipeline.stack_stages_ragged``); periods whose mask is False run as
    identity, and ``pipeline_apply`` drops their tap slots."""
    ops = get_opset("ref") if ops is None else ops

    def positions_of(h):
        return arange_positions(cfg, *h.shape[:2], h.device)

    def stage_fn(local, h):
        blocks, active = (local["blocks"], local["mask"]) if masked else (local, None)
        out = run_periods(blocks, cfg, h, positions_of(h), ops=ops, collect_taps=collect_taps,
                          active=active)
        return out if collect_taps else out[0]

    return stage_fn


def stage_backbone(backbone_params, cfg, mesh, *, partition=None, loss: bool = True,
                   copy: bool = False) -> dict:
    """This rank's stage of the whole backbone tree: its periods' slab
    (``stack_stages``, or ``stack_stages_ragged`` with its ``"mask"``
    along a ragged ``partition``), the embedding on stage 0, and the
    final norm and head where ``loss`` runs; ``"periods"`` records the
    range ``[a, b)``. ``copy=True`` copies the slab, so the whole tree
    can be freed."""
    S, s = mesh.stages, mesh.stage
    blocks = backbone_params["blocks"]
    mask = None
    if partition is None or partition.is_uniform:
        pp = cfg.n_periods // S
        a, b = s * pp, (s + 1) * pp
        slab = index_tree(stack_stages(blocks, S), s)
    else:
        a, b = partition.boundaries[s], partition.boundaries[s + 1]
        slab = index_tree(stack_stages_ragged(blocks, partition.boundaries), s)
        mask = tuple(bool(m) for m in partition.masks()[s])
    if copy:
        slab = map_arrays(torch.clone, slab)
    out = stage_params(backbone_params, cfg, slab, first=s == 0, loss=loss)
    out["periods"] = (a, b)
    if mask is not None:
        out["mask"] = mask
    return out


def _dp_mean(parts, mesh):
    """The global mean CE from this rank's (num, den) parts (None on a rank
    that counts no rows): the value ``Σnum / max(Σden, 1)`` summed by
    ``mesh.all_reduce_tree``, carrying the gradient of ``num_local /
    max(Σden, 1)``, this rank's share."""
    if parts is None:
        local = torch.zeros(2, device=mesh.device)
    else:
        num, den = parts
        local = torch.stack([num.detach().float(), den.detach().float()])
    total = mesh.all_reduce_tree(local)
    den_g = torch.clamp_min(total[1], 1)
    value = total[0] / den_g
    return value if parts is None else carry_grad(value, num / den_g)


def _dp_loss_and_grads(parts_fn, adapter_params, mesh, *, counted: bool):
    """The global mean CE and its gradient over the ranks of ``mesh``'s
    active mesh. Each rank's (summed NLL, token count) parts are
    summed before the division (the exact global mean, not a mean of
    local means); each rank takes the gradient of ``num_local /
    max(den_global, 1)`` and the gradients are summed. A rank that is
    not ``counted`` (its rows counted by another) adds zeros. Every
    member ends with the same bits."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), adapter_params)
    flat = tree_leaves(leaves)
    loss = _dp_mean(parts_fn(leaves) if counted else None, mesh)
    grads = (torch.autograd.grad(loss, flat) if counted
             else [torch.zeros_like(t) for t in flat])
    it = iter(mesh.all_reduce_tree(list(grads)))
    return loss.detach(), tree_map(lambda _: next(it), adapter_params)


def _sample_order(parts, n_micro: int, dim: int):
    """dp rows' parts, each with its rows on axis ``dim`` micro-major
    (micro m's q rows together), as one part in the single-process
    sample order: row j of dp row r in micro m at ``m·dp·q + r·q + j``."""

    def one(xs):
        shape = tuple(xs[0].shape)
        q = shape[dim] // n_micro
        split = [x.reshape(shape[:dim] + (n_micro, q) + shape[dim + 1:]) for x in xs]
        return torch.stack(split, dim + 1).reshape(
            shape[:dim] + (n_micro * len(xs) * q,) + shape[dim + 1:])

    first = parts[0]
    if isinstance(first, QTensor):
        return QTensor(one([p.q for p in parts]), one([p.scale for p in parts]), first.bits,
                       first.block, first.orig_last)
    return one(parts)


def _gather_to_owner(acts, mesh, n_micro: int):
    """Every dp row's activation triple (held by the row's first stage)
    on the owner, rank 0, in the single-process sample order; None on
    the other ranks."""
    if mesh.stage != 0:
        return None
    if not mesh.owner:
        mesh.send_tree(acts, 0)
        return None
    rows = [acts] + [mesh.recv_tree(r * mesh.stages) for r in range(1, mesh.dp)]
    return tuple(_sample_order([row[i] for row in rows], n_micro, dim)
                 for i, dim in enumerate((0, 1, 0)))


def _check_layout(cfg, mesh, partition, batch):
    """``partition`` checked against the mesh and ``cfg`` (None when it is
    the even split), the even split's divisibility, and implicit
    positions; raised alike on every rank before any transfer."""
    S = mesh.stages
    if partition is not None:
        if partition.n_stages != S:
            raise ValueError(f"plan has {partition.n_stages} stages but the mesh's "
                             f"'stage' axis has {S}")
        if partition.n_periods != cfg.n_periods:
            raise ValueError(f"plan partitions {partition.n_periods} periods but "
                             f"{cfg.name} has {cfg.n_periods}")
        if partition.is_uniform:
            partition = None  # identical to the even split: take that path
    if partition is None and cfg.n_periods % S:
        raise ValueError(f"{cfg.n_periods} periods not divisible by {S} pipeline stages")
    if "positions" in batch:
        # the stage function rebuilds arange positions; custom ones would
        # cache wrong activations for every later epoch
        raise NotImplementedError(
            "pipeline_pac_train_step supports implicit (arange) positions only")
    return partition


def _row_micro(batch, mesh, n_micro: int):
    """The batch's tokens and labels as ``DataPipeline.dp_microbatches``
    lays them out, and this rank's dp row's slice of dim 1."""
    from repro_torch.data import DataPipeline

    micro = DataPipeline.dp_microbatches(
        {"tokens": batch["tokens"], "labels": batch["labels"]}, n_micro, mesh.dp)
    q = micro["tokens"].shape[1] // mesh.dp
    return micro, slice(mesh.dp_rank * q, (mesh.dp_rank + 1) * q), q


def _pipeline_pac_forward(backbone_params, batch, *, cfg, mesh, n_micro, r, partition,
                          kernel_impl, tap_policy):
    """The frozen staged forward of :func:`pipeline_pac_loss_and_grads` on
    ``mesh`` (the spawned layout). Returns (the row's CE parts of an
    adapter, ``parts_fn(adapter) -> (num, den)``, on a row's first stage,
    else None; the row's activation triple there, else None)."""
    from repro_torch.core.pipeline import pipeline_apply
    from repro_torch.kernels.cached_step import cached_loss_parts

    partition = _check_layout(cfg, mesh, partition, batch)
    micro, mine, q = _row_micro(batch, mesh, n_micro)
    ops = get_opset(kernel_impl, tap_policy)
    local = (backbone_params if "periods" in backbone_params
             else stage_backbone(backbone_params, cfg, mesh, partition=partition))
    ragged = "mask" in local
    n_rows = n_micro * q
    with torch.no_grad():
        if mesh.stage == 0:
            x_micro = ops.embed_lookup(local["embed"], micro["tokens"][:, mine])
        else:  # later stages read only the micro count
            x_micro = torch.empty((n_micro, q, batch["tokens"].shape[1], cfg.d_model),
                                  device="meta")
        res = pipeline_apply(
            _backbone_stage_fn(cfg, masked=ragged, ops=ops),
            {"blocks": local["blocks"], "mask": local["mask"]} if ragged else local["blocks"],
            x_micro, mesh, collect_taps=True,
            periods_per_stage=partition.periods_per_stage if ragged else None)
    if mesh.stage != 0:
        return None, None
    outs, taps = res
    b0 = ops.emit_tap(x_micro.reshape((n_rows,) + tuple(x_micro.shape[2:])))
    b_final = ops.emit_tap(outs.reshape((n_rows,) + tuple(outs.shape[2:])))
    # (n_micro, n_p, q, ...) -> (n_p, n_micro·q, ...): micro-major rows
    taps = map_arrays(lambda t: t.movedim(1, 0).reshape(
        (t.shape[1], n_rows) + tuple(t.shape[3:])), taps)
    labels = micro["labels"][:, mine].reshape(n_rows, -1)
    positions = arange_positions(cfg, *labels.shape, labels.device)

    def parts_fn(ap):
        if kernel_impl == "ref":
            return cross_entropy_parts(
                pac_logits(local, ap, cfg, b0, taps, b_final, positions, r), labels)
        cached = {"b0": b0, "taps": taps, "b_final": b_final, "labels": labels}
        return cached_loss_parts(local, ap, cfg, cached, positions, r, impl=kernel_impl)

    return parts_fn, (b0, taps, b_final)


def pipeline_pac_loss_and_grads(backbone_params, adapter_params, batch, *, cfg, mesh, n_micro,
                                r: int = 8, partition=None, kernel_impl: str = "ref",
                                tap_policy: str = "f32"):
    """Distributed epoch-1 forward and gradients, run on every rank of
    ``mesh`` (:class:`~repro_torch.launch.mesh.EdgeMesh`) with the same
    ``batch`` (B, S) and adapter.

    The frozen backbone runs staged over the mesh's stages:
    ``DataPipeline.dp_microbatches`` splits the batch into ``n_micro``
    micro-batches whose rows dp row ``r`` shares out; each row's stage 0
    embeds its rows and :func:`~repro_torch.core.pipeline.pipeline_apply`
    carries them through the stages, every stage emitting its periods'
    taps (in ``tap_policy`` storage form under the ``cuda`` OpSet), which
    reach the row's stage 0 with the last stage's output. There the
    adapter loss runs on the row's rows (``kernel_impl="cuda"``: the
    fused cached-step kernels on the storage-form activations), and the
    CE parts and gradients are all-reduced over the world, the later
    stages adding zeros. The step runs on the mesh as spawned
    (``mesh.spawned``), whatever sub-mesh :meth:`EdgeMesh.reshard` made
    active: each rank holds its spawned stage's periods.

    ``backbone_params``: the whole tree, or this rank's
    :func:`stage_backbone`. ``partition``: any object with ``n_stages``,
    ``n_periods``, ``is_uniform``, ``boundaries``, ``masks()`` and
    ``periods_per_stage`` (a planner ``StagePartition``): its period
    boundaries choose each stage's periods; a uniform one is the even
    split.

    Returns (loss, adapter_grads, (b0, taps, b_final)) on every rank,
    the same loss and gradients everywhere; the activation triple, what
    the cache captures, is the whole batch's in the single-process
    sample order on the owner (rank 0) and None elsewhere."""
    mesh = mesh.spawned
    parts_fn, acts = _pipeline_pac_forward(
        backbone_params, batch, cfg=cfg, mesh=mesh, n_micro=n_micro, r=r, partition=partition,
        kernel_impl=kernel_impl, tap_policy=tap_policy)
    # one world all-reduce: the stage-0 ranks (one a dp row) count their
    # rows, the later stages add zeros
    loss, grads = _dp_loss_and_grads(parts_fn, adapter_params, mesh, counted=mesh.stage == 0)
    return loss, grads, _gather_to_owner(acts, mesh, n_micro)


def pipeline_pac_loss(adapter_params, backbone_params, batch, mesh, *, cfg, n_micro,
                      r: int = 8, partition=None, kernel_impl: str = "ref",
                      tap_policy: str = "f32"):
    """The epoch-1 PAC+ loss as a ``loss_fn`` of
    :func:`~repro_torch.core.pipeline.pipeline_grads` (trainable: the
    adapter; frozen: the backbone, whole or this rank's
    :func:`stage_backbone`): :func:`pipeline_pac_loss_and_grads`'s frozen
    staged forward and adapter loss. Its value on every rank is the
    global mean CE; its gradient on a row's first stage that of the row's
    part. No stage requires grad, so no gradient crosses the stages, and
    ``pipeline_grads(..., shared="world")`` returns
    :func:`pipeline_pac_loss_and_grads`'s loss and gradients bit for bit."""
    mesh = getattr(mesh, "spawned", mesh)
    parts_fn, _ = _pipeline_pac_forward(
        backbone_params, batch, cfg=cfg, mesh=mesh, n_micro=n_micro, r=r, partition=partition,
        kernel_impl=kernel_impl, tap_policy=tap_policy)
    return _dp_mean(None if parts_fn is None else parts_fn(adapter_params), mesh)


def pipeline_lm_loss(blocks, frozen, batch, mesh, *, cfg, n_micro, partition=None,
                     kernel_impl: str = "ref"):
    """The backbone's own mean CE as a ``loss_fn`` of
    :func:`~repro_torch.core.pipeline.pipeline_grads`, with the blocks
    trained: ``blocks`` is this rank's stage slab (trainable), ``frozen``
    its :func:`stage_backbone` (the embedding and the final norm and head
    on a row's first stage, a ragged slab's ``"mask"``). The batch (B, S)
    is micro-batched as :func:`pipeline_pac_loss_and_grads` does; each
    row's first stage embeds its rows, :func:`pipeline_apply` carries
    them through the stages (which require grad, so the backward crosses
    them), and the final norm, LM head and CE run there on the last
    stage's outputs. Value: the global mean CE on every rank; gradient:
    the row's part (``pipeline_grads(..., shared="stage")`` sums the
    rows)."""
    from repro_torch.core.pipeline import pipeline_apply

    mesh = getattr(mesh, "spawned", mesh)
    partition = _check_layout(cfg, mesh, partition, batch)
    micro, mine, q = _row_micro(batch, mesh, n_micro)
    ops = get_opset(kernel_impl)
    ragged = "mask" in frozen
    if mesh.stage == 0:
        with torch.no_grad():
            x_micro = ops.embed_lookup(frozen["embed"], micro["tokens"][:, mine])
    else:
        x_micro = torch.empty((n_micro, q, batch["tokens"].shape[1], cfg.d_model), device="meta")
    outs = pipeline_apply(
        _backbone_stage_fn(cfg, masked=ragged, ops=ops, collect_taps=False),
        {"blocks": blocks, "mask": frozen["mask"]} if ragged else blocks, x_micro, mesh,
        periods_per_stage=partition.periods_per_stage if ragged else None)
    parts = None
    if mesh.stage == 0:
        h = outs.reshape((n_micro * q,) + tuple(outs.shape[2:]))
        parts = cross_entropy_parts(logits_from_hidden(frozen, cfg, h),
                                    micro["labels"][:, mine].reshape(n_micro * q, -1))
    return _dp_mean(parts, mesh)


def pipeline_pac_train_step(backbone_params, adapter_params, opt_state, batch, *, cfg, mesh,
                            n_micro, r: int = 8, lr=1e-3, clip=1.0, partition=None,
                            kernel_impl: str = "ref", tap_policy: str = "f32"):
    """Epoch-1 PAC+ step on a ``(dp, stage)`` mesh of ranks: the
    distributed twin of :func:`pac_train_step`
    (:func:`pipeline_pac_loss_and_grads`, then clip and AdamW, run alike
    on every rank on the same all-reduced gradients, so every rank ends
    with bit-equal adapter and optimizer state). Returns (loss,
    adapter_params', opt_state', (b0, taps, b_final) on the owner, else
    None)."""
    loss, grads, acts = pipeline_pac_loss_and_grads(
        backbone_params, adapter_params, batch, cfg=cfg, mesh=mesh, n_micro=n_micro, r=r,
        partition=partition, kernel_impl=kernel_impl, tap_policy=tap_policy)
    adapter_params, opt_state = _apply(adapter_params, grads, opt_state, lr, clip)
    return loss, adapter_params, opt_state, acts


def dp_cached_train_step(backbone_params, adapter_params, opt_state, cached_batch, *, cfg, mesh,
                         batch_axes, r: int = 8, lr=1e-3, clip=1.0, kernel_impl: str = "cuda"):
    """Epoch ≥ 2 cached step in pure data parallelism over the pool: the
    distributed twin of :func:`pac_cached_train_step`, run on every rank.

    ``cached_batch``: this rank's rows of the cached batch
    (``launch.sharding.rank_rows`` over ``batch_axes``, from
    ``launch.sharding.cached_batch_axes``), in the form
    :func:`pac_cached_train_step` takes; a rank whose rows another rank
    of its dp row counts (``rows_count`` False) may pass None. The CE
    parts are summed over the active mesh (the spawned one, or the
    sub-mesh of :meth:`~repro_torch.launch.mesh.EdgeMesh.reshard`)
    before the division, the gradients summed, and the update runs
    alike on every member; a parked rank does not call it. Returns
    (loss, adapter_params', opt_state')."""
    from repro_torch.kernels.cached_step import cached_loss_parts
    from repro_torch.launch.sharding import rows_count

    def parts_fn(ap):
        return cached_loss_parts(backbone_params, ap, cfg, cached_batch,
                                 _cached_positions(cached_batch, cfg), r, impl=kernel_impl)

    loss, grads = _dp_loss_and_grads(parts_fn, adapter_params, mesh,
                                     counted=rows_count(mesh, batch_axes))
    adapter_params, opt_state = _apply(adapter_params, grads, opt_state, lr, clip)
    return loss, adapter_params, opt_state


# ---------------------------------------------------------------------------
# Baseline fine-tuning steps (the paper's comparisons)
# ---------------------------------------------------------------------------


def full_train_step(params, opt_state, batch, *, cfg, lr=1e-4, clip=1.0):
    """Full fine-tuning: the gradient of every backbone leaf, clip, AdamW.
    With a tied head the embedding gets both gradients (lookup and head).

    The logits come through ``logits_from_hidden`` (the head read from
    ``params`` each step), never the session's cached ``loss_head``: the
    head changes every step here. Returns (loss, params', opt_state')."""
    if any(isinstance(t, QTensor) for t in tree_leaves(params)):
        raise TypeError("full_train_step differentiates every backbone leaf, and a quantized "
                        "(QTensor) leaf's integer codes have no gradient: pass a dense backbone")

    def loss_fn(p):
        return cross_entropy(backbone_logits(p, cfg, batch), batch["labels"])

    return _update(loss_fn, params, opt_state, lr, clip)


def lora_train_step(backbone_params, lora_params, opt_state, batch, *, cfg, lr=1e-3, clip=1.0):
    """LoRA: the gradient of the (A, B) pairs and ``alpha`` through the
    frozen backbone, clip, AdamW. Returns (loss, lora_params', opt_state')."""

    def loss_fn(lp):
        return cross_entropy(peft.lora_logits(backbone_params, lp, cfg, batch), batch["labels"])

    return _update(loss_fn, lora_params, opt_state, lr, clip)


def houlsby_train_step(backbone_params, ad_params, opt_state, batch, *, cfg, lr=1e-3, clip=1.0):
    """Houlsby adapters: the gradient of the bottlenecks through the frozen
    backbone, clip, AdamW. Returns (loss, ad_params', opt_state')."""

    def loss_fn(ap):
        return cross_entropy(peft.houlsby_logits(backbone_params, ap, cfg, batch),
                             batch["labels"])

    return _update(loss_fn, ad_params, opt_state, lr, clip)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(params, batch, *, cfg, kernel_impl: str = "ref"):
    """Full-prompt forward through the ``kernel_impl`` OpSet. Returns the
    last position's logits (B,1,V)."""
    h, _ = backbone_forward(params, cfg, batch, ops=get_opset(kernel_impl))
    return logits_from_hidden(params, cfg, h[:, -1:, :])


@torch.no_grad()
def decode_step(params, token_batch, cache, pos, *, cfg, kernel_impl: str = "ref"):
    """One-token decode against the linear cache. Returns (logits, cache)."""
    return backbone_decode(params, cfg, token_batch, cache, pos, ops=get_opset(kernel_impl))


@torch.no_grad()
def pac_decode_step(backbone_params, adapter_params, token_batch, cache, adapter_cache, pos,
                    *, cfg, r: int = 8, kernel_impl: str = "ref"):
    """Serve the personal model: backbone decode plus side-network decode.

    token_batch: {"tokens": (B,1)} or {"embeds": (B,1,d)}; cache: the
    backbone's linear cache (``init_cache``, f32 or ``kv_quant=8``);
    adapter_cache: ``init_adapter_cache``; pos: the index the token is
    written at (an int or a (B,) tensor). The frozen backbone runs on the
    ``kernel_impl`` OpSet, so does the adapter's per-period λ-mix (under
    ``cuda`` the ``adapter_fuse`` kernel); the adapter's blocks and the
    LM head stay on plain ops, as in the reference. Returns (logits
    (B,1,V), cache, adapter_cache) — both caches updated in place."""
    ops = get_opset(kernel_impl)
    if "embeds" in token_batch:
        x = token_batch["embeds"]
    else:
        x = ops.embed_lookup(backbone_params["embed"], token_batch["tokens"])
    pos = torch.as_tensor(pos, device=x.device).long().expand(x.shape[0])
    b_final, taps = decode_periods(backbone_params, cfg, x, cache, pos, ops=ops)
    side, adapter_cache = adapter_decode(adapter_params, cfg, x, taps, adapter_cache, pos, r,
                                         ops=ops)
    return logits_from_hidden(backbone_params, cfg, b_final + side), cache, adapter_cache
