"""EdgeSession — one engine owning the model, the cache and the train
steps of a run (counterpart of ``repro.runtime.session``, single device).

An :class:`EdgeSession` takes a validated
:class:`~repro_torch.runtime.spec.RunSpec` and owns the run:

* **device** — ``device=None`` means the card; with no card only an
  explicit ``device="cpu"`` runs (no silent fallback);
* **model** — the frozen backbone, drawn from a seeded generator leaf by
  leaf on the device and quantized as drawn (``quant``), so the f32 tree
  is never resident; the adapter (pruning or random init) and AdamW;
* **cache** — an :class:`~repro_torch.core.activation_cache.ActivationCache`
  with the spec's policy and budget;
* **steps** — :meth:`step` runs one batch: on a cache miss the epoch-1
  step (frozen forward + adapter update) and the cache fill, on a hit
  the cached step. Under ``kernels="cuda"`` the taps leave the forward
  already in the cache's storage form and reach the cached step in it.

    spec = RunSpec(arch="internlm2-1.8b", reduced=True, epochs=3)
    reports = EdgeSession(spec, device="cpu").run()   # one EpochReport per epoch

Observability attaches as hooks (:class:`~repro_torch.runtime.runner.RunHooks`);
pass ``log=print`` for the CLI's informational lines. The planner's
report line arrives with the cost-model slice of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.runtime.spec import RunSpec
from repro_torch.serve.engine import resolve_device


@dataclass
class StepEvent:
    """One training step, as seen by hooks and the runner."""

    epoch: int
    index: int
    loss: float
    cache_hit: bool
    mode: str          # "full" | "cached"
    wall_s: float


class EdgeSession:
    """The run engine. ``open()``/``close()`` (or ``with``) bracket the
    heavy state; :meth:`step` is the one dispatch the epoch loop calls."""

    def __init__(self, spec: RunSpec, *, device=None, log=None):
        spec.validate()
        self.spec = spec
        self.device = resolve_device(device)
        self._log = log if log is not None else (lambda *a: None)
        self._opened = False
        # populated by open():
        self.cfg = None
        self.backbone = None      # the (possibly quantized) frozen tree
        self.adapter = None
        self.opt = None
        self.corpus = None
        self.pipe = None
        self.cache = None

    def __enter__(self) -> "EdgeSession":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def open(self) -> "EdgeSession":
        if self._opened:
            return self
        from repro_torch.core.activation_cache import ActivationCache
        from repro_torch.core.init_methods import pruning_init
        from repro_torch.core.parallel_adapters import init_adapter
        from repro_torch.core.quantization import tree_leaves, tree_storage_bytes
        from repro_torch.data import DataPipeline, SyntheticPersonalCorpus
        from repro_torch.models.backbone import init_backbone
        from repro_torch.optim import adamw_init

        spec, log, dev = self.spec, self._log, self.device
        cfg = self.cfg = spec.arch_config()
        log(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M device={dev}")
        gen = torch.Generator(device=dev).manual_seed(spec.seed)
        self.backbone = init_backbone(gen, cfg, device=dev, quant_bits=spec.quant)
        if spec.quant:
            log(f"backbone quantized INT{spec.quant}: "
                f"{tree_storage_bytes(self.backbone)/2**20:.1f} MB")
        agen = torch.Generator(device=dev).manual_seed(spec.seed + 1)
        if spec.init == "pruning":
            self.adapter = pruning_init(agen, self.backbone, cfg, r=spec.r, device=dev)
        else:
            self.adapter = init_adapter(agen, cfg, r=spec.r, device=dev)
        n_train = sum(t.numel() for t in tree_leaves(self.adapter))
        log(f"trainable (adapter) params: {n_train/1e6:.2f}M "
            f"({n_train/cfg.param_count():.2%} of backbone)")
        self.opt = adamw_init(self.adapter)

        self.corpus = SyntheticPersonalCorpus(cfg.vocab, spec.seq + 1,
                                              spec.steps_per_epoch * spec.batch, seed=spec.seed)
        self.pipe = DataPipeline(self.corpus, global_batch=spec.batch, shuffle=True,
                                 seed=spec.seed)
        self.cache = ActivationCache(budget_bytes=spec.cache_budget_mb << 20,
                                     compress=spec.cache_compress)
        self._opened = True
        return self

    def close(self) -> None:
        """Release per-run state (the cache's entries and spill files)."""
        if self.cache is not None:
            self.cache.clear()
        self._opened = False

    def step(self, batch: dict, *, epoch: int = 0, index: int = 0) -> StepEvent:
        """One training step: cache lookup, then the epoch-1 step and the
        cache fill on a miss, or the cached step on a hit. ``batch`` is
        one :meth:`DataPipeline.epoch` item (numpy; ``seq_ids`` is
        consumed here). Updates the session's adapter and optimizer."""
        from repro_torch.core import steps

        if not self._opened:
            raise RuntimeError("EdgeSession.step() before open(): use "
                               "`with EdgeSession(spec) as s:` or s.open()")
        spec, dev = self.spec, self.device
        t0 = time.perf_counter()
        ids = batch["seq_ids"]
        tokens = torch.from_numpy(batch["tokens"]).to(dev)
        labels = torch.from_numpy(batch["labels"]).to(dev)
        hit = None
        if spec.use_cache:
            hit = self.cache.get_batch(ids, with_final=True, dtype=None,
                                       compressed=spec.kernels == "cuda")
        if hit is None:
            loss, self.adapter, self.opt, (b0, taps, bf) = steps.pac_train_step(
                self.backbone, self.adapter, self.opt, {"tokens": tokens, "labels": labels},
                cfg=self.cfg, r=spec.r, lr=spec.lr, kernel_impl=spec.kernels,
                # under cuda the taps leave the forward in the cache's
                # storage form, and put_batch adopts them as they are
                tap_policy=spec.cache_compress)
            if spec.use_cache:
                self.cache.put_batch(ids, b0, taps, bf, orig_last=self.cfg.d_model)
        else:
            b0, taps, bf = (h.to(dev) for h in hit)  # tensors or int8 QTensors
            cached = {"b0": b0, "taps": taps, "b_final": bf, "labels": labels}
            loss, self.adapter, self.opt = steps.pac_cached_train_step(
                self.backbone, self.adapter, self.opt, cached, cfg=self.cfg, r=spec.r,
                lr=spec.lr, kernel_impl=spec.kernels)
        loss = float(loss)
        return StepEvent(epoch=epoch, index=index, loss=loss, cache_hit=hit is not None,
                         mode=self.mode(hit is not None), wall_s=time.perf_counter() - t0)

    def mode(self, cache_hit: bool) -> str:
        """The run-mode label the trainer reports."""
        return "cached" if cache_hit else "full"

    def run(self, hooks=()) -> list:
        """open → every epoch through an
        :class:`~repro_torch.runtime.runner.EpochRunner` → close. Returns
        the list of :class:`~repro_torch.runtime.runner.EpochReport`."""
        from repro_torch.runtime.runner import EpochRunner

        with self:
            return EpochRunner(self, hooks=hooks).run()
