"""Dry run: price every (arch x input shape) on the meta device and emit
the roofline terms (twin of ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_out
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --dp 2 --stages 2

Everything runs on ``meta``: the step of each cell runs at full width and
depth through the ``cuda`` OpSet's program with nothing allocated or
computed, and :class:`~repro_torch.launch.op_cost.OpPricer` charges its
ops. That is the design, as the reference's placeholder devices are: it
needs no card, and it is no fallback for one.

The reference compiles for its production meshes (``--multi-pod``); the
port has none. ``--dp``/``--stages`` price instead each rank of the
port's own :class:`~repro_torch.launch.mesh.EdgeMesh` layout: every
rank's step runs in a thread of its own on meta over a
:class:`PricedMesh`, which passes the trees the ranks send one another
and counts each rank's bytes as ``EdgeMesh.stats`` does. A rank holds its
share of the rows and periods (the even split of
``pipeline_pac_train_step``, ``stage_backbone``): the epoch-1 step
(``pac``) moves the stage hand-offs, the taps and the outputs to a row's
first stage, and the owner's gather (``send_tree``); the cached step
(``pac_cached``) the owner's scatter of the cached rows; both all-reduce
the loss parts and the adapter's gradients (``_flat_collective``).

A failing case is reported with its cause and the run exits 1; no case
is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
import traceback
from typing import List, Optional

import torch

from repro_torch.configs import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.core.quantization import QTensor, tree_leaves
from repro_torch.launch.op_cost import OpPricer
from repro_torch.launch.roofline import analyze, format_row

ASSIGNED = [
    "musicgen-large",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "kimi-k2-1t-a32b",
    "qwen2-vl-7b",
    "xlstm-125m",
    "gemma2-2b",
    "jamba-1.5-large-398b",
    "internlm2-1.8b",
    "granite-20b",
]

#: seconds a priced rank waits for a peer's message before it gives up
RECV_TIMEOUT = 600.0


# ---------------------------------------------------------------------------
# A mesh of threads on meta
# ---------------------------------------------------------------------------


class _Done:
    def wait(self) -> None:
        pass


class _Hub:
    """The mailboxes of one priced layout: a queue a (src, dst) pair."""

    def __init__(self):
        self._boxes = {}
        self._lock = threading.Lock()

    def box(self, src: int, dst: int) -> queue.Queue:
        with self._lock:
            return self._boxes.setdefault((src, dst), queue.Queue())


class PricedMesh:
    """One rank's stand-in for :class:`~repro_torch.launch.mesh.EdgeMesh`,
    as spawned (no reshard), on the meta device, with what the priced
    steps read of it: ``send_tree`` posts the tree itself to the peer's
    mailbox, ``recv_tree`` takes it, ``all_reduce_tree`` returns its
    input. ``stats`` counts what ``EdgeMesh.stats`` counts: the bytes of
    every array a send carries (``p2p_bytes``), and those of the flat f32
    buffer of each all-reduce (``allreduce_bytes``); ``calls`` the
    transfers."""

    def __init__(self, hub: _Hub, rank: int, dp: int, stages: int):
        self._hub = hub
        self.dp, self.stages = dp, stages
        self.rank = rank
        self.dp_rank, self.stage = divmod(rank, stages)
        self.owner = rank == 0
        self.members = tuple(range(dp * stages))
        row = rank // stages
        self.row_ranks = list(range(row * stages, (row + 1) * stages))
        self.row_group = None
        self.device = torch.device("meta")
        self.spawned = self
        self.stats = {"p2p_bytes": 0, "allreduce_bytes": 0}
        self.calls = 0

    @property
    def world(self) -> int:
        return self.dp * self.stages

    def send_tree(self, tree, dst: int, *, group=None, slot=0, wait: bool = True,
                  grad: bool = False):
        # ``grad`` is a header flag on the card: it moves no byte, and the
        # priced steps' stages never require grad
        items = tree if isinstance(tree, tuple) else (tree,)
        arrays = [a for x in items if x is not None
                  for a in ((x.q, x.scale) if isinstance(x, QTensor) else (x,))]
        self.stats["p2p_bytes"] += sum(a.numel() * a.element_size() for a in arrays)
        self.calls += 1
        self._hub.box(self.rank, dst).put(tree)
        return None if wait else _Done()

    def recv_tree(self, src: int, *, group=None):
        try:
            return self._hub.box(src, self.rank).get(timeout=RECV_TIMEOUT)
        except queue.Empty:
            raise RuntimeError(f"priced rank {self.rank}: no message from rank {src} within "
                               f"{RECV_TIMEOUT} s") from None

    def all_reduce_tree(self, tree):
        self.stats["allreduce_bytes"] += 4 * sum(t.numel() for t in tree_leaves(tree))
        self.calls += 1
        return tree


def run_ranks(rank_fn, dp: int, stages: int) -> List[OpPricer]:
    """``rank_fn(mesh)`` for every rank of a ``dp`` x ``stages`` layout,
    each in its own thread under its own pricer; a rank's mesh bytes go
    to its cost's collectives (``p2p``, ``all-reduce``). Raises the first
    rank's error, if any."""
    hub = _Hub()
    world = dp * stages
    pricers: List[Optional[OpPricer]] = [None] * world
    errors: List[BaseException] = []

    def run(rank: int) -> None:
        mesh = PricedMesh(hub, rank, dp, stages)
        try:
            with OpPricer() as pricer:
                rank_fn(mesh)
        except BaseException as e:  # re-raised by the caller after every join
            errors.append(e)
            return
        pricer.cost.collectives = {"p2p": float(mesh.stats["p2p_bytes"]),
                                   "all-reduce": float(mesh.stats["allreduce_bytes"])}
        pricer.cost.collective_count = mesh.calls
        pricers[rank] = pricer

    threads = [threading.Thread(target=run, args=(r,), name=f"priced-rank-{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return pricers


def layout_case(cfg: ArchConfig, shape: InputShape, dp: int, stages: int, *, technique: str,
                quant_bits: Optional[int], r: int, dtype, tap_policy: str, note: str):
    """The :class:`~repro_torch.launch.specs.Case` of a train shape on a
    ``dp`` x ``stages`` EdgeMesh: ``pac`` prices the epoch-1 step
    (``pipeline_pac_train_step`` with ``stages`` micro-batches, the
    session's default), ``pac_cached`` the cached step (the owner's
    scatter, then ``dp_cached_train_step``)."""
    from repro_torch.core import steps
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.launch.sharding import cached_batch_axes, rank_rows
    from repro_torch.launch.specs import META, Case, abstract_params, input_specs, storage_form
    from repro_torch.models.backbone import loss_head
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.session import scatter_hit

    if shape.mode != "train" or technique not in ("pac", "pac_cached"):
        raise ValueError(f"an EdgeMesh layout prices the PAC+ training steps (pac, pac_cached) "
                         f"of a train shape, got {technique} x {shape.mode}")
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    params = abstract_params(cfg, quant_bits, dtype)
    loss_head(params, cfg)  # made once a session, before its steps (as in build_case)
    batch = input_specs(cfg, shape, dtype)
    if "tokens" not in batch or "positions" in batch:
        raise ValueError(f"{cfg.name}: the distributed steps take tokens with implicit "
                         f"positions, as the port's trainer does")

    def rank_fn(mesh):
        adapter = init_adapter(None, cfg, r, device=META, dtype=dtype)
        opt = adamw_init(adapter)
        if technique == "pac":
            local = steps.stage_backbone(params, cfg, mesh)
            steps.pipeline_pac_train_step(local, adapter, opt, batch, cfg=cfg, mesh=mesh,
                                          n_micro=stages, r=r, kernel_impl="cuda",
                                          tap_policy=tap_policy)
            return
        axes = cached_batch_axes(B, mesh)
        hit = None
        if mesh.owner:  # the owner's cached batch, in its storage form
            hit = (storage_form((B, S, d), tap_policy),
                   storage_form((cfg.n_periods, B, S, d), tap_policy),
                   storage_form((B, S, d), tap_policy))
        local = scatter_hit(mesh, hit, B, axes, META)
        cached = None
        if local is not None:
            cached = dict(zip(("b0", "taps", "b_final"), local),
                          labels=batch["labels"][rank_rows(B, mesh, axes)])
        steps.dp_cached_train_step(params, adapter, opt, cached, cfg=cfg, mesh=mesh,
                                   batch_axes=axes, r=r, kernel_impl="cuda")

    def run(params, batch):  # the arguments only size ``Case.argument_bytes``
        return run_ranks(rank_fn, dp, stages)

    return Case(name=f"{cfg.name}×{shape.name}", fn=run, args=(params, batch), cfg=cfg,
                shape=shape, note=note, layout=(dp, stages))


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def run_case(arch, shape, *, technique: str = "pac", quant_bits=None, kv_quant=None,
             dtype: str = "f32", layout=(1, 1), tap_policy: str = "f32", out_dir=None,
             verbose: bool = True) -> dict:
    """Price one cell and return its record: the roofline terms of the
    rank whose largest term is the largest (the rank that bounds the
    step), each rank's terms and mesh bytes under ``ranks``, and the
    seconds the build and the pricing took."""
    from repro_torch.core.parallel_adapters import adapter_param_count
    from repro_torch.launch.specs import build_case

    torch_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    t0 = time.perf_counter()
    case = build_case(arch, shape, layout, technique=technique, quant_bits=quant_bits,
                      kv_quant=kv_quant, dtype=torch_dtype, tap_policy=tap_policy)
    t_build = time.perf_counter() - t0
    pricers = case.price()
    t_price = time.perf_counter() - t0 - t_build
    n_adapter = adapter_param_count(case.cfg) if technique.startswith("pac") else 0
    arch_name = arch if isinstance(arch, str) else arch.name
    terms = [analyze(p.cost, arch=arch_name, shape=case.shape, layout=layout,
                     technique=technique, note=case.note,
                     n_active_params=case.cfg.active_param_count(),
                     n_adapter_params=n_adapter, argument_bytes=case.argument_bytes())
             for p in pricers]
    slowest = max(range(len(terms)), key=lambda i: max(
        terms[i].t_compute, terms[i].t_memory, terms[i].t_collective))
    rec = terms[slowest].as_dict()
    rec.update(rank=slowest, build_s=round(t_build, 2), price_s=round(t_price, 2),
               status="ok", product_flops=pricers[slowest].cost.product_flops,
               units={k: {"calls": pricers[slowest].unit_calls[k], "flops": u.flops,
                          "bytes": u.bytes} for k, u in pricers[slowest].units.items()})
    if len(pricers) > 1:
        rec["ranks"] = [{"rank": i, "flops": p.cost.flops, "bytes": p.cost.bytes,
                         "p2p_bytes": p.cost.collectives["p2p"],
                         "allreduce_bytes": p.cost.collectives["all-reduce"],
                         "t_compute": t.t_compute, "t_memory": t.t_memory,
                         "t_collective": t.t_collective}
                        for i, (p, t) in enumerate(zip(pricers, terms))]
    if verbose:
        print(format_row(terms[slowest]), flush=True)
        print(f"  {terms[slowest].memory_analysis}; build={t_build:.1f}s price={t_price:.1f}s",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_name}_{case.shape.name}_{'x'.join(map(str, layout))}_{technique}"
        if quant_bits:
            tag += f"_int{quant_bits}"
        if kv_quant:
            tag += f"_kv{kv_quant}"
        if dtype != "f32":
            tag += f"_{dtype}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all assigned)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES), help="input shape")
    ap.add_argument("--technique", default="pac",
                    choices=["pac", "pac_cached", "full", "lora"],
                    help="fine-tuning technique for train shapes")
    ap.add_argument("--quant", type=int, default=None, choices=[4, 8],
                    help="backbone quantization bits")
    ap.add_argument("--kv-quant", type=int, default=None, choices=[8],
                    help="INT8 KV cache for decode shapes")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="activation/param dtype")
    ap.add_argument("--dp", type=int, default=1, help="EdgeMesh data-parallel rows")
    ap.add_argument("--stages", type=int, default=1, help="EdgeMesh pipeline stages")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--all", action="store_true", help="run the full 10x4 matrix")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    layout = (args.dp, args.stages)
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} × {shape} × {args.dp}x{args.stages}"
            try:
                run_case(arch, shape, technique=args.technique, quant_bits=args.quant,
                         kv_quant=args.kv_quant, dtype=args.dtype, layout=layout,
                         out_dir=args.out)
            except Exception as e:  # every case is tried; each failure is named below
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall dry-run cases priced OK")


if __name__ == "__main__":
    main()
