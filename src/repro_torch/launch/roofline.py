"""Three-term roofline of a priced step (twin of ``repro.launch.roofline``).

Per (arch x shape x layout) cell, from the rank's priced
:class:`~repro_torch.launch.op_cost.Cost` (each term is already one
card's, as the reference's per-device module is):

    compute    = FLOPs              / PEAK_FLOPS_BF16
    memory     = bytes              / HBM_BW
    collective = Σ collective bytes / LINK_BW

with the card's constants (``repro_torch.launch.mesh``, an NVIDIA H100
SXM). The compute term divides by the bf16 tensor cores' peak, the
reference's convention; ``t_compute_f32`` divides the same FLOPs by the
f32 peak of the CUDA cores, since the port computes in f32 (its kernels
split f32 operands into bf16 terms; PERF.md's kernel table gives both
bounds). The dominant term is the bottleneck; MODEL_FLOPS =
6·N_active·D (train) or 2·N_active·D (inference), technique-aware as in
the reference, and the useful-compute ratio are the reference's formulas
(``roofline.py:115-138``).

The reference parses collective bytes out of XLA's HLO text
(``collective_bytes(hlo_text)``); that has no twin here, since the port's
collectives are its mesh's own calls, which :mod:`repro_torch.launch.dryrun`
counts into the cost.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
from repro_torch.launch.op_cost import COLLECTIVES, Cost


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    technique: str
    note: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_compute_ratio: float
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    memory_analysis: str = ""
    t_compute_f32: float = 0.0

    def as_dict(self) -> dict:
        return asdict(self)


def model_flops(shape, technique: str, n_active_params: float, n_adapter_params: float) -> float:
    """MODEL_FLOPS, technique-aware: PAC+ pays 2·N·D backbone forward +
    6·N_a·D side network (no backbone backward, the paper's saving); the
    cached variant drops the backbone forward entirely."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        D = B * S
        if technique == "pac":
            return 2.0 * n_active_params * D + 6.0 * n_adapter_params * D
        if technique == "pac_cached":
            return 6.0 * n_adapter_params * D
        return 6.0 * n_active_params * D  # full / lora / adapters: backward through the backbone
    if shape.mode == "prefill":
        return 2.0 * n_active_params * B * S
    return 2.0 * n_active_params * B  # one token per sequence


def analyze(cost: Cost, *, arch: str, shape, layout=(1, 1), technique: str, note: str = "",
            n_active_params: float = 0.0, n_adapter_params: float = 0.0,
            argument_bytes: int = 0) -> RooflineTerms:
    """The roofline of one rank's ``cost`` on a ``layout`` = (dp, stages)
    mesh of ``dp·stages`` cards. ``argument_bytes`` (the case's
    parameters, batch, optimizer state and cache) fills
    ``memory_analysis``, where the reference prints XLA's."""
    flops, byts = cost.flops, cost.bytes
    coll = {k: cost.collectives.get(k, 0.0) for k in COLLECTIVES}
    coll_weighted = cost.collective_bytes

    t_comp = flops / PEAK_FLOPS_BF16
    t_mem = byts / HBM_BW
    t_coll = coll_weighted / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    n_chips = layout[0] * layout[1]
    mf = model_flops(shape, technique, n_active_params, n_adapter_params)
    ratio = mf / (flops * n_chips) if flops else 0.0
    return RooflineTerms(
        arch=arch,
        shape=shape.name,
        mesh="x".join(map(str, layout)),
        technique=technique,
        note=note,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes_per_device=coll_weighted,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        bottleneck=bottleneck,
        model_flops_total=mf,
        useful_compute_ratio=ratio,
        collective_breakdown={**coll, "n_total": cost.collective_count},
        memory_analysis=f"argument bytes {argument_bytes} (parameters, batch, optimizer "
                        f"state, cache)",
        t_compute_f32=flops / PEAK_FLOPS_F32,
    )


def format_row(t: RooflineTerms) -> str:
    return (
        f"{t.arch:24s} {t.shape:12s} {t.mesh:8s} {t.technique:10s} {t.note:6s} "
        f"comp={t.t_compute * 1e3:9.3f}ms mem={t.t_memory * 1e3:9.3f}ms "
        f"coll={t.t_collective * 1e3:9.3f}ms -> {t.bottleneck:10s} "
        f"useful={t.useful_compute_ratio * 100:6.2f}%"
    )
