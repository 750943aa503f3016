"""RunSpec — the typed, serializable description of one fine-tuning run
(counterpart of ``repro.runtime.spec``).

The fields are the reference's, so a spec saved by either package loads
in the other. ``dp``, ``stages`` and ``micro`` lay out the hybrid DP x PP
trainer (``dp·stages`` ranks on ``torch.distributed``); ``plan`` hands
that layout to the planner instead: ``"auto"`` (Alg. 1 picks the stage
count, the period boundaries and the micro count over a ``pool`` of
devices) or a plan JSON saved with ``save_plan`` (replayed);
``calibrate`` prices the periods by a FLOP count of the real step.
``kernels`` is the port's own: ``"cuda"`` (the default: the hand-written
kernels) or ``"ref"`` (plain PyTorch).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

INIT_METHODS = ("pruning", "random")
KERNEL_IMPLS = ("ref", "cuda")
QUANT_BITS = (4, 8)
COMPRESS_POLICIES = ("f32", "bf16", "int8")


class RunSpecError(ValueError):
    """An invalid or inconsistent RunSpec."""


@dataclass(frozen=True)
class RunSpec:
    """One run of the paper's workflow (Fig. 4), as data. Defaults match
    the trainer CLI's; ``use_cache`` inverts ``--no-cache``. ``plan`` is
    ``None`` (the CLI-pinned dp x stages), ``"auto"`` or a saved plan's
    path."""

    # model / workload
    arch: str = "internlm2-1.8b"
    reduced: bool = False
    epochs: int = 3
    steps_per_epoch: int = 8
    batch: int = 4
    seq: int = 32
    seed: int = 0
    # adapter + backbone treatment
    r: int = 8
    init: str = "pruning"
    quant: Optional[int] = None
    lr: float = 3e-3
    # activation cache
    use_cache: bool = True
    cache_dir: Optional[str] = None
    cache_compress: str = "f32"
    cache_budget_mb: int = 4096
    # parallelism (dp x stages ranks) / planning
    dp: int = 1
    stages: int = 1
    micro: Optional[int] = None
    plan: Optional[str] = None
    pool: Optional[int] = None
    save_plan: Optional[str] = None
    calibrate: bool = False
    # compute path of both the epoch-1 frozen forward and the cached step
    kernels: str = "cuda"
    # outputs: the adapter checkpoint written by EdgeSession.finish()
    ckpt: Optional[str] = None

    @property
    def plan_mode(self) -> bool:
        return self.plan is not None

    @property
    def total_devices(self) -> int:
        """Ranks of the CLI-pinned (dp, stage) mesh (a plan may choose
        another)."""
        return self.dp * self.stages

    def default_micro(self) -> Optional[int]:
        """The micro-batch count when the spec pins one: ``micro`` if set,
        else the stage count when distributed, else the reference's
        planning-report default. ``None`` in plan mode with no ``micro``
        (the plan supplies or sweeps it)."""
        if self.micro is not None:
            return self.micro
        if self.plan_mode:
            return None
        return self.stages if self.total_devices > 1 else 4

    def arch_config(self):
        """The effective ArchConfig (``reduced`` applied)."""
        from repro_torch.configs import get_arch

        cfg = get_arch(self.arch)
        return cfg.reduced() if self.reduced else cfg

    def validate(self) -> "RunSpec":
        """Raise :class:`RunSpecError` on a bad value or an impossible
        layout; a saved plan is loaded (pure JSON) to check the pool
        against its stages. The plan's period count is checked when the
        session resolves it. Returns self."""
        def bad(msg):
            raise RunSpecError(msg)

        for name in ("epochs", "steps_per_epoch", "batch", "seq", "r", "dp", "stages",
                     "cache_budget_mb"):
            if getattr(self, name) < 1:
                bad(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.init not in INIT_METHODS:
            bad(f"init must be one of {INIT_METHODS}, got {self.init!r}")
        if self.kernels not in KERNEL_IMPLS:
            bad(f"kernels must be one of {KERNEL_IMPLS}, got {self.kernels!r}")
        if self.quant is not None and self.quant not in QUANT_BITS:
            bad(f"quant must be one of {QUANT_BITS} or None, got {self.quant!r}")
        if self.cache_compress not in COMPRESS_POLICIES:
            bad(f"cache_compress must be one of {COMPRESS_POLICIES}, got {self.cache_compress!r}")
        try:
            cfg = self.arch_config()
        except KeyError as e:
            bad(e.args[0])
        if self.micro is not None:
            if self.micro < 1:
                bad(f"micro must be >= 1, got {self.micro}")
            if self.batch % self.micro:
                bad(f"batch {self.batch} must be divisible by micro={self.micro}")
        if self.pool is not None and self.pool < 1:
            bad(f"pool must be >= 1, got {self.pool}")
        if self.plan_mode and self.plan != "auto":
            from repro_torch.core.planner import Plan

            try:
                saved = Plan.load(self.plan)
            except (OSError, ValueError, KeyError) as e:
                bad(f"cannot load plan file {self.plan!r}: {e}")
            if self.pool is not None and self.pool < saved.n_stages:
                bad(f"pool {self.pool} is smaller than the saved plan's "
                    f"{saved.n_stages} stages; pass pool >= "
                    f"{saved.n_stages} or replan with plan='auto'")
        if not self.plan_mode and self.total_devices > 1:
            n_micro = self.default_micro()
            if self.batch % n_micro:
                bad(f"batch {self.batch} must be divisible by the {n_micro} micro-batches")
            if (self.batch // n_micro) % self.dp:
                bad(f"micro-batch size {self.batch // n_micro} must be divisible by "
                    f"dp={self.dp}")
            if cfg.n_periods % self.stages:
                bad(f"stages {self.stages} must divide n_periods={cfg.n_periods} of "
                    f"{cfg.name} (or use plan='auto' for uneven boundaries)")
        return self

    def replace(self, **changes) -> "RunSpec":
        """A modified, re-validated copy."""
        return dataclasses.replace(self, **changes).validate()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise RunSpecError(f"unknown RunSpec field(s): {unknown}")
        return cls(**d)

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_args(cls, ns) -> "RunSpec":
        """From the trainer CLI's parsed flags."""
        return cls(arch=ns.arch, reduced=ns.reduced, epochs=ns.epochs,
                   steps_per_epoch=ns.steps_per_epoch, batch=ns.batch, seq=ns.seq,
                   seed=ns.seed, r=ns.r, init=ns.init, quant=ns.quant, lr=ns.lr,
                   use_cache=not ns.no_cache, cache_dir=ns.cache_dir,
                   cache_compress=ns.cache_compress, cache_budget_mb=ns.cache_budget_mb,
                   dp=ns.dp, stages=ns.stages, micro=ns.micro, plan=ns.plan, pool=ns.pool,
                   save_plan=ns.save_plan, calibrate=ns.calibrate, kernels=ns.kernels,
                   ckpt=ns.ckpt)
