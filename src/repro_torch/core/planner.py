"""Heterogeneity-aware hybrid-parallelism planner (paper §V-A, Alg. 1;
counterpart of ``repro.core.planner``, plain Python, its arithmetic in
the reference's order so that both give equal plans).

Faithful implementation of the paper's two nested dynamic programs:

* **Eq. (4)** ``H_{x→y}(b, G_n)`` — optimal dispatch of ``b`` samples of a
  micro-batch across a device group running stage layers ``x..y`` in data
  parallel, minimising the slowest device under per-device memory budgets
  (OOM ⇒ +inf).
* **Eq. (3)** ``W(0→y, D_n, s)`` — optimally balanced partition of layers
  ``0..y`` over the first ``n`` devices into ``s`` pipeline stages.
* **Eqs. (5)–(7)** — stage-count selection σ from the beginning /
  execution / ending phase latencies of the 1F1B schedule, including
  AllReduce of the *trainable* parameters only (tiny for PAC+, the whole
  model for the full-FT baselines — exactly the asymmetry the paper
  exploits).

The planner is offline and hardware-agnostic: it consumes per-layer
``LayerCost`` records (analytic FLOPs/bytes here; measured times on a
real testbed) and ``DeviceProfile``s. Its :class:`StagePartition` is
what the port's hybrid DP x PP trainer executes
(:func:`repro_torch.core.steps.pipeline_pac_train_step`); a plan saved
as JSON by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

INF = float("inf")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceProfile:
    """An edge device. Paper Table IV uses Jetson Nano/TX2 at two power modes."""

    name: str
    flops: float  # effective FLOP/s
    memory_bytes: float  # budget u_d
    bandwidth: float = 125e6  # bytes/s to its peers (1000 Mbps LAN default)

    def t(self, flops: float) -> float:
        return flops / self.flops


# paper Table IV (effective sustained FLOP/s, not peak)
JETSON_NANO_H = DeviceProfile("nano-h", 235e9, 4 * 2 ** 30)
JETSON_NANO_L = DeviceProfile("nano-l", 160e9, 4 * 2 ** 30)
JETSON_TX2_H = DeviceProfile("tx2-h", 665e9, 8 * 2 ** 30)
JETSON_TX2_L = DeviceProfile("tx2-l", 435e9, 8 * 2 ** 30)


@dataclass(frozen=True)
class LayerCost:
    """Per-layer workload, per sample (analytic or measured)."""

    fwd_flops: float
    bwd_flops: float
    param_bytes: float
    trainable_bytes: float  # params that need grads + AllReduce
    act_bytes: float  # output activation bytes per sample (inter-stage comm)
    resident_act_bytes: float  # activations that must stay live for bwd, per sample


def model_layer_costs(cfg, technique: str = "pac", dtype_bytes: int = 4, seq_len: int = 128, quant_bits: Optional[int] = None) -> List[LayerCost]:
    """Analytic per-layer costs for a backbone + fine-tuning technique.

    technique ∈ {"pac", "pac_cached", "lora", "adapters", "full"}.
    Mirrors the paper's Fig. 3 / Table I accounting: LoRA/Adapters still
    pay a full backward through the backbone (~2× fwd FLOPs); PAC+ pays
    backward only on the (1/r²-sized) side network; the cached variant
    drops the backbone forward too.
    """
    from repro_torch.core.parallel_adapters import adapter_config

    d, s = cfg.d_model, seq_len
    specs = cfg.layer_specs()
    acfg = adapter_config(cfg)
    w_bytes = dtype_bytes if quant_bits is None else quant_bits / 8.0
    costs: List[LayerCost] = []
    for spec in specs:
        # params
        p_attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd + cfg.n_heads * cfg.hd * d
        if spec.kind != "attn":
            p_attn = 4 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_heads  # ssm-ish
        if spec.moe and cfg.moe is not None:
            p_ffn = cfg.moe.n_experts * 3 * d * cfg.moe.d_expert
            p_ffn_active = cfg.moe.top_k * 3 * d * cfg.moe.d_expert
        elif spec.ffn and cfg.d_ff:
            p_ffn = p_ffn_active = 3 * d * cfg.d_ff
        else:
            p_ffn = p_ffn_active = 0
        p_total = p_attn + p_ffn
        p_active = p_attn + p_ffn_active
        # FLOPs (per sample of seq_len s): 2·params_active·s + attention quadratic
        f_fwd = 2.0 * p_active * s
        if spec.kind == "attn":
            win = min(spec.window or s, s)
            f_fwd += 4.0 * s * win * cfg.n_heads * cfg.hd
        f_bwd = 2.0 * f_fwd
        # adapter-side costs for PAC+
        a_p = (
            d * acfg.d_model  # W_down
            + acfg.d_model * (acfg.n_heads + 2 * acfg.n_kv_heads) * acfg.hd
            + acfg.n_heads * acfg.hd * acfg.d_model
            + (3 * acfg.d_model * acfg.d_ff if acfg.d_ff else 0)
        )
        a_fwd = 2.0 * a_p * s
        a_bwd = 2.0 * a_fwd
        act = s * d * dtype_bytes
        if technique == "full":
            # resident-for-backward per block ≈ q,k,v,o (4) + attn probs/
            # softmax (~4 at s≈128) + ffn input/mid/gate (~5 in d units) +
            # norms (calibrated to Table I: T5-Large b16 s128 -> 5.3 GB)
            costs.append(
                LayerCost(f_fwd, f_bwd, p_total * dtype_bytes, p_total * dtype_bytes, act,
                          14 * act if spec.kind == "attn" else 9 * act)
            )
        elif technique in ("lora", "adapters"):
            # frozen weights skip the weight-grad matmuls but still need the
            # activation-grad pass — the paper's "only ~49% backward
            # reduction" (Fig. 13a): bwd ≈ 1× fwd instead of 2× fwd.
            # Resident acts ≈ 0.8× of full (paper: 4.0-4.3 vs 5.3 GB) —
            # weight-grad inputs can be dropped, everything else stays.
            extra = 2 * d * 8 * s * 2  # bottleneck/low-rank FLOPs (rank≈8)
            costs.append(
                LayerCost(f_fwd + extra, f_fwd + 3 * extra, p_total * w_bytes,
                          (2 * d * 8) * dtype_bytes, act,
                          12 * act if spec.kind == "attn" else 8 * act)
            )
        elif technique == "pac":
            costs.append(
                LayerCost(f_fwd + a_fwd, a_bwd, p_total * w_bytes + a_p * dtype_bytes,
                          a_p * dtype_bytes, act, 2 * act // max(1, cfg.d_model // acfg.d_model))
            )
        elif technique == "pac_cached":
            costs.append(
                LayerCost(a_fwd, a_bwd, a_p * dtype_bytes, a_p * dtype_bytes,
                          s * acfg.d_model * dtype_bytes,
                          2 * s * acfg.d_model * dtype_bytes)
            )
        else:
            raise ValueError(technique)
    return costs


def aggregate_periods(costs: Sequence[LayerCost], layers_per_period: int) -> List[LayerCost]:
    """Collapse per-layer costs to per-*period* costs (the runtime's unit).

    The backbone stacks parameters over periods and scans whole periods, so
    an executable plan must cut on period boundaries. FLOPs and memory sum
    over the period's layers; inter-stage activation bytes are the *last*
    layer's output (the only tensor that crosses a period boundary).
    """
    if layers_per_period < 1 or len(costs) % layers_per_period:
        raise ValueError(
            f"{len(costs)} layer costs not divisible into periods of {layers_per_period}"
        )
    out: List[LayerCost] = []
    for i in range(0, len(costs), layers_per_period):
        chunk = costs[i : i + layers_per_period]
        out.append(
            LayerCost(
                fwd_flops=sum(c.fwd_flops for c in chunk),
                bwd_flops=sum(c.bwd_flops for c in chunk),
                param_bytes=sum(c.param_bytes for c in chunk),
                trainable_bytes=sum(c.trainable_bytes for c in chunk),
                act_bytes=chunk[-1].act_bytes,
                resident_act_bytes=sum(c.resident_act_bytes for c in chunk),
            )
        )
    return out


def period_costs(cfg, technique: str = "pac", dtype_bytes: int = 4, seq_len: int = 128, quant_bits: Optional[int] = None) -> List[LayerCost]:
    """Per-period costs for ``cfg`` — what a runtime-executable plan consumes
    (one planner "layer" == one backbone period)."""
    return aggregate_periods(
        model_layer_costs(cfg, technique, dtype_bytes, seq_len, quant_bits), cfg.period
    )


# ---------------------------------------------------------------------------
# Plan data model
# ---------------------------------------------------------------------------


@dataclass
class Stage:
    layer_start: int  # inclusive
    layer_end: int  # inclusive
    devices: Tuple[DeviceProfile, ...]
    samples_per_device: Tuple[int, ...]  # micro-batch split
    stage_time: float  # max over devices of fwd+bwd for its share
    # recorded from LayerCost by _phase_latencies (fwd_time + bwd_time ==
    # stage_time); 0.0 on hand-built stages — simulate_plan falls back to
    # its historical 1:2 approximation then
    fwd_time: float = 0.0
    bwd_time: float = 0.0


@dataclass(frozen=True)
class StagePartition:
    """Runtime-facing view of a :class:`Plan`: the executable contract.

    ``boundaries`` are cumulative *period* indices — stage ``s`` owns
    periods ``[boundaries[s], boundaries[s+1])``. ``masks`` pads every
    stage to ``max_periods`` (the padded slots run as identity periods in
    the SPMD pipeline); ``samples_per_device`` is the planner's Eq. (4)
    dispatch per stage, carried so the runtime/report layer can consume
    and validate it against the executed micro-batch size.
    """

    boundaries: Tuple[int, ...]  # len n_stages + 1, boundaries[0] == 0
    samples_per_device: Tuple[Tuple[int, ...], ...]
    n_micro: int

    def __post_init__(self):
        b = self.boundaries
        if len(b) < 2 or b[0] != 0 or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"bad stage boundaries {b}")
        if len(self.samples_per_device) != self.n_stages:
            raise ValueError(
                f"{len(self.samples_per_device)} sample splits for {self.n_stages} stages"
            )

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_periods(self) -> int:
        return self.boundaries[-1]

    @property
    def periods_per_stage(self) -> Tuple[int, ...]:
        return tuple(y - x for x, y in zip(self.boundaries, self.boundaries[1:]))

    @property
    def max_periods(self) -> int:
        return max(self.periods_per_stage)

    @property
    def is_uniform(self) -> bool:
        pps = self.periods_per_stage
        return all(p == pps[0] for p in pps)

    def masks(self) -> Tuple[Tuple[bool, ...], ...]:
        """(n_stages, max_periods) active-period masks (False == padding)."""
        m = self.max_periods
        return tuple(
            tuple(i < pp for i in range(m)) for pp in self.periods_per_stage
        )


@dataclass
class Plan:
    stages: List[Stage]
    n_stages: int
    micro_batches: int
    latency_begin: float
    latency_exec: float
    latency_end: float

    @property
    def minibatch_latency(self) -> float:
        return self.latency_begin + self.latency_exec + self.latency_end

    def describe(self) -> str:
        out = [f"{self.n_stages} stages, minibatch latency {self.minibatch_latency:.3f}s"]
        for i, st in enumerate(self.stages):
            devs = ",".join(d.name for d in st.devices)
            out.append(
                f"  stage {i}: layers [{st.layer_start}..{st.layer_end}] on {{{devs}}} "
                f"split={st.samples_per_device} time={st.stage_time * 1e3:.1f}ms"
            )
        return "\n".join(out)

    # -- executable artifact -------------------------------------------------
    def stage_partition(self, layers_per_period: int = 1) -> StagePartition:
        """Derive the runtime contract. The plan's layer indices convert to
        period indices; every stage boundary must fall on a period boundary
        (guaranteed when the planner was fed :func:`period_costs`)."""
        bounds = [0]
        for i, st in enumerate(self.stages):
            if st.layer_start != (self.stages[i - 1].layer_end + 1 if i else 0):
                raise ValueError("plan stages are not contiguous")
            end = st.layer_end + 1
            if end % layers_per_period:
                raise ValueError(
                    f"stage {i} ends at layer {st.layer_end}, not a period "
                    f"boundary (period = {layers_per_period} layers); plan at "
                    f"period granularity (planner.period_costs) to execute"
                )
            bounds.append(end // layers_per_period)
        return StagePartition(
            boundaries=tuple(bounds),
            samples_per_device=tuple(tuple(st.samples_per_device) for st in self.stages),
            n_micro=self.micro_batches,
        )

    # -- JSON round-trip (save once, replay on the pool) ---------------------
    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(
            {
                "version": 1,
                "n_stages": self.n_stages,
                "micro_batches": self.micro_batches,
                "latency_begin": self.latency_begin,
                "latency_exec": self.latency_exec,
                "latency_end": self.latency_end,
                "stages": [
                    {
                        "layer_start": st.layer_start,
                        "layer_end": st.layer_end,
                        "devices": [
                            {
                                "name": d.name,
                                "flops": d.flops,
                                "memory_bytes": d.memory_bytes,
                                "bandwidth": d.bandwidth,
                            }
                            for d in st.devices
                        ],
                        "samples_per_device": list(st.samples_per_device),
                        "stage_time": st.stage_time,
                        "fwd_time": st.fwd_time,
                        "bwd_time": st.bwd_time,
                    }
                    for st in self.stages
                ],
            },
            indent=indent,
        )

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        d = json.loads(text)
        if d.get("version") != 1:
            raise ValueError(f"unsupported plan version {d.get('version')!r}")
        stages = [
            Stage(
                layer_start=s["layer_start"],
                layer_end=s["layer_end"],
                devices=tuple(DeviceProfile(**dev) for dev in s["devices"]),
                samples_per_device=tuple(s["samples_per_device"]),
                stage_time=s["stage_time"],
                fwd_time=s.get("fwd_time", 0.0),
                bwd_time=s.get("bwd_time", 0.0),
            )
            for s in d["stages"]
        ]
        return cls(
            stages=stages,
            n_stages=d["n_stages"],
            micro_batches=d["micro_batches"],
            latency_begin=d["latency_begin"],
            latency_exec=d["latency_exec"],
            latency_end=d["latency_end"],
        )

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


class HybridParallelismPlanner:
    """Paper Alg. 1. ``plan()`` returns the σ-optimal configuration."""

    def __init__(
        self,
        layer_costs: Sequence[LayerCost],
        devices: Sequence[DeviceProfile],
        micro_batch_size: int = 4,
        n_micro_batches: int = 4,
        heterogeneity_aware: bool = True,
    ):
        self.costs = list(layer_costs)
        self.devices = list(devices)
        self.B = micro_batch_size
        self.M = n_micro_batches
        self.L = len(self.costs)
        self.het = heterogeneity_aware
        self._h_cache: dict = {}
        self._w_cache: dict = {}
        # the device subset the current plan() call may use, as absolute
        # indices into self.devices — plan(available=...) re-plans after a
        # pool-membership change without rebuilding the planner, and the
        # Eq. (4) memo (keyed on absolute-index groups) carries over
        self._avail: Tuple[int, ...] = tuple(range(len(self.devices)))

    # -- Eq. (4): sample dispatch inside one stage --------------------------
    def _device_time(self, d: DeviceProfile, x: int, y: int, b: int) -> float:
        """fwd+bwd time + OOM check for b samples of layers x..y on d."""
        if b == 0:
            return 0.0
        fl = sum(c.fwd_flops + c.bwd_flops for c in self.costs[x : y + 1]) * b
        mem = sum(c.param_bytes + 2 * c.trainable_bytes for c in self.costs[x : y + 1])
        mem += sum(c.resident_act_bytes for c in self.costs[x : y + 1]) * b * self.M
        if mem > d.memory_bytes:
            return INF
        return d.t(fl)

    def stage_dispatch(self, x: int, y: int, group: Tuple[int, ...], b: int):
        """Returns (H_{x→y}(b, G), split) via the Eq. (4) DP."""
        if not self.het:
            # heterogeneity-oblivious (PAC, the older conference version):
            # equal split regardless of device speed
            per = [b // len(group)] * len(group)
            for i in range(b % len(group)):
                per[i] += 1
            t = max(self._device_time(self.devices[g], x, y, p) for g, p in zip(group, per))
            return t, tuple(per)
        key = (x, y, group, b)
        if key in self._h_cache:
            return self._h_cache[key]
        if len(group) == 1:
            t = self._device_time(self.devices[group[0]], x, y, b)
            self._h_cache[key] = (t, (b,))
            return self._h_cache[key]
        best, best_split = INF, None
        rest = group[:-1]
        last = self.devices[group[-1]]
        for i in range(b + 1):
            t_last = self._device_time(last, x, y, i)
            if t_last == INF:
                continue  # larger i only worse
            t_rest, split_rest = self.stage_dispatch(x, y, rest, b - i)
            t = max(t_rest, t_last)
            if t < best:
                best, best_split = t, split_rest + (i,)
        self._h_cache[key] = (best, best_split if best_split else tuple([0] * len(group)))
        return self._h_cache[key]

    # -- Eq. (3): balanced pipeline partition --------------------------------
    def _w(self, y: int, n: int, s: int):
        """W(0→y, first n of the available devices, s stages):
        (slowest-stage time, config list). Groups are tuples of absolute
        device indices, so the Eq. (4) memo survives ``available=``
        subset changes."""
        key = (y, n, s, self._avail)
        if key in self._w_cache:
            return self._w_cache[key]
        if s == 1:
            group = self._avail[:n]
            t, split = self.stage_dispatch(0, y, group, self.B)
            cfgs = [(0, y, group, split)]
            self._w_cache[key] = (t, cfgs)
            return self._w_cache[key]
        best, best_cfg = INF, None
        for q in range(s - 2, y):  # at least s-1 layers before the last stage
            for m in range(1, n - (s - 1) + 1):
                group = self._avail[n - m : n]
                t_stage, split = self.stage_dispatch(q + 1, y, group, self.B)
                if t_stage >= best:
                    continue
                t_prev, cfg_prev = self._w(q, n - m, s - 1)
                t = max(t_prev, t_stage)
                if t < best:
                    best = t
                    best_cfg = cfg_prev + [(q + 1, y, group, split)]
        self._w_cache[key] = (best, best_cfg)
        return self._w_cache[key]

    # -- Eqs. (5)-(7): stage-count selection ---------------------------------
    def _phase_latencies(self, cfgs) -> Tuple[float, float, float, List[Stage]]:
        s = len(cfgs)
        stages: List[Stage] = []
        e = []  # (e_f, e_b) per stage
        c_f, c_b, ar = [], [], []
        for x, y, group, split in cfgs:
            devs = tuple(self.devices[g] for g in group)
            tf = max(
                (d.t(sum(c.fwd_flops for c in self.costs[x : y + 1]) * b) if b else 0.0)
                for d, b in zip(devs, split)
            )
            tb = max(
                (d.t(sum(c.bwd_flops for c in self.costs[x : y + 1]) * b) if b else 0.0)
                for d, b in zip(devs, split)
            )
            e.append((tf, tb))
            bw = min(d.bandwidth for d in devs)
            act = self.costs[y].act_bytes * self.B
            c_f.append(act / bw)
            c_b.append(act / bw)
            train_bytes = sum(c.trainable_bytes for c in self.costs[x : y + 1])
            # ring AllReduce within the group
            k = len(devs)
            ar.append(2.0 * train_bytes * (k - 1) / (k * bw) if k > 1 else 0.0)
            stages.append(Stage(x, y, devs, split, tf + tb, fwd_time=tf, bwd_time=tb))
        # Eq. (5)
        L_b = sum(e[i][0] + c_f[i] for i in range(s - 1))
        L_e = self.M * (e[-1][0] + e[-1][1])
        # Eq. (6)
        L_n = max(
            ar[i] + sum(e[j][1] + c_b[j] for j in range(i, s - 1))
            for i in range(s)
        )
        return L_b, L_e, L_n, stages

    def plan(self, max_stages: Optional[int] = None,
             available: Optional[Sequence[int]] = None) -> Plan:
        """σ-optimal plan over the pool — or, with ``available=`` (absolute
        device indices), over a surviving subset: the fleet scheduler's
        incremental re-plan after a device is lost or joins. Eq. (4)
        dispatch results are memoized on absolute-index groups, so
        re-planning a subset reuses every group the two pools share."""
        if available is None:
            self._avail = tuple(range(len(self.devices)))
        else:
            avail = tuple(int(i) for i in available)
            if len(set(avail)) != len(avail):
                raise ValueError(f"available has duplicates: {avail}")
            bad = [i for i in avail if i < 0 or i >= len(self.devices)]
            if bad or not avail:
                raise ValueError(
                    f"available must be non-empty indices into the "
                    f"{len(self.devices)}-device pool, got {avail}")
            self._avail = avail
        n = len(self._avail)
        best: Optional[Plan] = None
        smax = min(self.L, n, max_stages or n)
        for s in range(1, smax + 1):
            t, cfgs = self._w(self.L - 1, n, s)
            if cfgs is None or t == INF:
                continue
            L_b, L_e, L_n, stages = self._phase_latencies(cfgs)
            plan = Plan(stages, s, self.M, L_b, L_e, L_n)
            if best is None or plan.minibatch_latency < best.minibatch_latency:
                best = plan
        if best is None:
            raise RuntimeError(
                "no feasible plan: aggregate device memory cannot hold the model"
            )
        return best


# ---------------------------------------------------------------------------
# Baseline planners for the paper's comparisons
# ---------------------------------------------------------------------------


def plan_pure_dp(layer_costs, devices, micro_batch_size, n_micro_batches) -> Optional[Plan]:
    """EDDL-style pure data parallelism (every device hosts the full model)."""
    p = HybridParallelismPlanner(layer_costs, devices, micro_batch_size, n_micro_batches)
    group = tuple(range(len(devices)))
    t, split = p.stage_dispatch(0, p.L - 1, group, micro_batch_size)
    if t == INF:
        return None
    L_b, L_e, L_n, stages = p._phase_latencies([(0, p.L - 1, group, split)])
    return Plan(stages, 1, n_micro_batches, L_b, L_e, L_n)


def plan_pure_pp(layer_costs, devices, micro_batch_size, n_micro_batches) -> Optional[Plan]:
    """Eco-FL-style straight pipeline: one stage per device."""
    p = HybridParallelismPlanner(layer_costs, devices, micro_batch_size, n_micro_batches)
    n = len(devices)
    t, cfgs = p._w(p.L - 1, n, n)
    if cfgs is None or t == INF:
        return None
    L_b, L_e, L_n, stages = p._phase_latencies(cfgs)
    return Plan(stages, n, n_micro_batches, L_b, L_e, L_n)


def brute_force_plan(layer_costs, devices, micro_batch_size, n_micro_batches, max_stages=None):
    """Exponential-search reference for planner-optimality tests (small inputs)."""
    import itertools

    p = HybridParallelismPlanner(layer_costs, devices, micro_batch_size, n_micro_batches)
    L, n = p.L, len(devices)
    best = None
    smax = min(L, n, max_stages or n)
    for s in range(1, smax + 1):
        # all layer cut points and all contiguous device groupings
        for cuts in itertools.combinations(range(L - 1), s - 1):
            bounds = [(a + 1, b) for a, b in zip((-1,) + cuts, cuts + (L - 1,))]
            for dev_cuts in itertools.combinations(range(1, n), s - 1):
                dbounds = [(a, b) for a, b in zip((0,) + dev_cuts, dev_cuts + (n,))]
                cfgs = []
                ok = True
                for (x, y), (da, db) in zip(bounds, dbounds):
                    group = tuple(range(da, db))
                    t, split = p.stage_dispatch(x, y, group, micro_batch_size)
                    if t == INF:
                        ok = False
                        break
                    cfgs.append((x, y, group, split))
                if not ok:
                    continue
                L_b, L_e, L_n, stages = p._phase_latencies(cfgs)
                plan = Plan(stages, s, n_micro_batches, L_b, L_e, L_n)
                if best is None or plan.minibatch_latency < best.minibatch_latency:
                    best = plan
    return best
