"""Cost models for the planner (counterpart of ``repro.launch.costs``).

The planner (:mod:`repro_torch.core.planner`) consumes one
:class:`~repro_torch.core.planner.LayerCost` per *period*, the unit the
pipeline cuts on. Two backends answer :class:`CostModel`:

* :class:`AnalyticCostModel` — the paper's closed-form accounting
  (FLOPs from matmul shapes, paper Fig. 3 / Table I), the reference's;
* :class:`CalibratedCostModel` — the ``--calibrate`` switch: the
  analytic per-period FLOPs scaled so that their totals match a count of
  the real PAC+ loss and its backward at the trainer's micro-batch and
  sequence, by the reference's method (the slope/intercept split of
  ``HloCalibratedCostModel``). The count is
  ``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device:
  nothing is computed or allocated, so the full-width LM head costs no
  memory. It always runs the ``ref`` OpSet (the plain versions of what
  the kernels compute), because the counter sees aten ops, not the
  hand-written kernels. It counts matmuls and attention only, where the
  reference's HLO count holds elementwise ops too, so the calibrated
  FLOPs are the port's own numbers. Memory stays analytic.

* :func:`price_case` — the twin of the reference's ``price_lowered``:
  the :class:`~repro_torch.launch.op_cost.Cost` of a
  :class:`~repro_torch.launch.specs.Case` priced on the meta device
  (the ``cuda`` OpSet's program, kernels as units), the one entry point
  the roofline and the dry run share. The calibrated model keeps its
  ``FlopCounterMode`` count, so its numbers are unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Protocol, runtime_checkable

from repro_torch.core.planner import LayerCost, period_costs

#: adapter reduction factor the calibration measures at (the trainer's default)
CALIBRATION_R = 8


@runtime_checkable
class CostModel(Protocol):
    """Anything that prices a backbone for the planner: one
    :class:`LayerCost` per *period*, so that
    ``HybridParallelismPlanner`` fed these makes plans whose
    ``stage_partition()`` the trainer executes as it is."""

    def period_costs(self, cfg, technique: str = "pac", seq_len: int = 128) -> List[LayerCost]:
        ...


@dataclass(frozen=True)
class AnalyticCostModel:
    """The paper's closed-form accounting (nothing is run)."""

    dtype_bytes: int = 4
    quant_bits: Optional[int] = None

    def period_costs(self, cfg, technique: str = "pac", seq_len: int = 128) -> List[LayerCost]:
        return period_costs(cfg, technique, dtype_bytes=self.dtype_bytes, seq_len=seq_len,
                            quant_bits=self.quant_bits)


def count_step_flops(cfg, technique: str, micro_batch: int, seq_len: int,
                     quant_bits: Optional[int] = None, r: int = CALIBRATION_R) -> float:
    """FLOPs of one PAC+ loss and its backward over the adapter, counted
    by ``FlopCounterMode`` on the ``meta`` device under the ``ref``
    OpSet, at (``micro_batch``, ``seq_len``). ``technique``: ``"pac"``
    (the epoch-1 step: the frozen backbone's forward, then the adapter
    loss) or ``"pac_cached"`` (the cached step: the adapter loss on
    cached activations). The trees are built without drawing; the
    optimizer is not counted (the counter sees no elementwise work)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.opset import get_opset
    from repro_torch.core.parallel_adapters import init_adapter, pac_logits
    from repro_torch.core.quantization import tree_leaves, tree_map
    from repro_torch.kernels.cached_step import cached_loss_parts
    from repro_torch.models.backbone import (arange_positions, backbone_forward, cross_entropy,
                                             init_backbone)

    meta = torch.device("meta")
    bp = init_backbone(None, cfg, device=meta, quant_bits=quant_bits)
    ap = tree_map(lambda t: t.requires_grad_(True), init_adapter(None, cfg, r=r, device=meta))
    tokens = torch.zeros((micro_batch, seq_len), dtype=torch.int64, device=meta)
    positions = arange_positions(cfg, micro_batch, seq_len, meta)
    with FlopCounterMode(display=False) as counter:
        if technique == "pac":
            with torch.no_grad():
                b_final, taps, x, positions = backbone_forward(
                    bp, cfg, {"tokens": tokens}, collect_taps=True, return_inputs=True,
                    ops=get_opset("ref"))
            loss = cross_entropy(pac_logits(bp, ap, cfg, x, taps, b_final, positions, r), tokens)
        elif technique == "pac_cached":
            h = torch.zeros((micro_batch, seq_len, cfg.d_model), device=meta)
            cached = {"b0": h, "b_final": h, "labels": tokens,
                      "taps": torch.zeros((cfg.n_periods,) + tuple(h.shape), device=meta)}
            num, den = cached_loss_parts(bp, ap, cfg, cached, positions, r, impl="ref")
            loss = num / torch.clamp_min(den, 1)
        else:
            raise ValueError(f"technique must be 'pac' or 'pac_cached', got {technique!r}")
        torch.autograd.grad(loss, tree_leaves(ap))
    return float(counter.get_total_flops())


@dataclass(frozen=True)
class CalibratedCostModel:
    """Analytic memory model + counted compute (counterpart of the
    reference's ``HloCalibratedCostModel``, same method).

    Calibration counts small cases at the *actual* trainer shape
    (micro-batch x seq): the ``pac`` step and the ``pac_cached`` step on
    a one-period model, whose difference isolates one period's backbone
    forward; and the cached step again on a two-period model, so the
    *slope* between the two cached counts prices one period of the
    trainable side while the intercept is the shared head/CE overhead
    (spread evenly over periods — without that split a one-period count
    divided by n_periods would under-count the adapter by ~n_periods x).
    Scales apply uniformly over periods, so per-period shape
    heterogeneity still comes from the analytic ratios."""

    micro_batch: int = 4
    dtype_bytes: int = 4
    quant_bits: Optional[int] = None

    def _measure(self, cfg, technique: str, seq_len: int, periods: int = 1) -> float:
        cfg_n = dataclasses.replace(cfg, n_layers=periods * cfg.period)
        return count_step_flops(cfg_n, technique, self.micro_batch, seq_len, self.quant_bits)

    def period_costs(self, cfg, technique: str = "pac", seq_len: int = 128) -> List[LayerCost]:
        base = period_costs(cfg, technique, dtype_bytes=self.dtype_bytes, seq_len=seq_len,
                            quant_bits=self.quant_bits)
        if technique not in ("pac", "pac_cached"):
            return base  # calibration targets the PAC+ trainer path
        mb = self.micro_batch
        pac = self._measure(cfg, "pac", seq_len)
        cached1 = self._measure(cfg, "pac_cached", seq_len)
        # per-sample counted FLOPs: pac minus cached on the same 1-period
        # model ≈ one backbone period's forward
        meas_fwd = max(pac - cached1, 0.0) / mb
        if cfg.n_periods > 1:
            cached2 = self._measure(cfg, "pac_cached", seq_len, periods=2)
            # slope = one period of adapter fwd+bwd; intercept = the
            # period-count-independent head/CE overhead
            per_period = max(cached2 - cached1, 0.0) / mb
            overhead = max(cached1 / mb - per_period, 0.0)
        else:
            per_period, overhead = cached1 / mb, 0.0
        # every period tiles the same pattern, so the analytic per-period
        # costs are identical — one counted period calibrates them all
        ana_fwd = base[0].fwd_flops
        ana_bwd = base[0].bwd_flops
        s_fwd = meas_fwd / ana_fwd if ana_fwd else 1.0
        s_bwd = per_period / ana_bwd if ana_bwd else 1.0
        extra_bwd = overhead / len(base)  # shared overhead, spread evenly
        return [dataclasses.replace(c, fwd_flops=c.fwd_flops * s_fwd,
                                    bwd_flops=c.bwd_flops * s_bwd + extra_bwd)
                for c in base]


def price_case(case):
    """The :class:`~repro_torch.launch.op_cost.Cost` of ``case``
    (:func:`repro_torch.launch.specs.build_case`): one rank's, or for a
    layout the rank's whose largest roofline term is the largest (the
    rank that bounds the step)."""
    from repro_torch.launch.roofline import analyze

    costs = [p.cost for p in case.price()]

    def longest(cost):
        t = analyze(cost, arch=case.cfg.name, shape=case.shape, layout=case.layout,
                    technique="")
        return max(t.t_compute, t.t_memory, t.t_collective)

    return max(costs, key=longest)


def resolve_cost_model(calibrate: bool, micro_batch: int = 4,
                       quant_bits: Optional[int] = None) -> CostModel:
    """The trainer's ``--calibrate`` switch in one place."""
    if calibrate:
        return CalibratedCostModel(micro_batch=micro_batch, quant_bits=quant_bits)
    return AnalyticCostModel(quant_bits=quant_bits)
