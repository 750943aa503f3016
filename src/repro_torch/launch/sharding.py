"""Which rank holds which rows of the epoch >= 2 cached batch
(counterpart of ``repro.launch.sharding.cached_batch_axes``).

From epoch 2 the backbone no longer runs, so the whole pool trains the
adapter data-parallel: the cached batch shards over ``dp`` and, when
the batch divides the pool, over ``stage`` too. Otherwise a dp row's
ranks hold the same rows and :func:`rows_count` lets one of them count.
The pool is the mesh's active one (``mesh.dp``, ``mesh.world``,
``mesh.rank``): after ``EdgeMesh.reshard`` a sub-mesh of the spawned
ranks, in which a rank is named by its position (``mesh.members`` maps
positions to world ranks).

The reference's other placement helpers (``param_specs``,
``batch_specs``, ``cache_specs``, ``replicated``, ``to_named``,
``cached_step_shardings``) describe GSPMD shardings of one program over
a device mesh. The port's ranks are processes that hold their own
tensors, so those have no twin: parameters are replicated by every rank
drawing them, and batches are split by :func:`rank_rows`.
"""

from __future__ import annotations

from typing import Optional


def _batch_size(cached_batch) -> int:
    return int(cached_batch) if isinstance(cached_batch, int) else cached_batch["labels"].shape[0]


def cached_batch_axes(cached_batch, mesh) -> tuple:
    """Mesh axes the cached batch shards over: ``("dp",)``, plus
    ``"stage"`` when its batch (``labels``' leading size, or an int)
    divides the pool."""
    if _batch_size(cached_batch) % mesh.world == 0:
        return ("dp", "stage")
    return ("dp",)


def rank_rows(cached_batch, mesh, batch_axes, rank: Optional[int] = None) -> slice:
    """Rank ``rank``'s (default: this rank's) rows of the batch, in the
    reference's order: dp-major, then stage (over ``("dp", "stage")``),
    or its dp row's rows."""
    B = _batch_size(cached_batch)
    rank = mesh.rank if rank is None else rank
    parts, idx = ((mesh.world, rank) if "stage" in batch_axes
                  else (mesh.dp, rank // mesh.stages))
    if B % parts:
        raise ValueError(f"batch {B} does not divide over {parts} ranks ({batch_axes})")
    n = B // parts
    return slice(idx * n, (idx + 1) * n)


def rows_count(mesh, batch_axes, rank: Optional[int] = None) -> bool:
    """True when rank ``rank``'s (default: this rank's) rows enter the
    loss: every rank's when the stage axis shards too, else those of one
    rank (stage 0) of each dp row, so each row counts once."""
    rank = mesh.rank if rank is None else rank
    return "stage" in batch_axes or rank % mesh.stages == 0
