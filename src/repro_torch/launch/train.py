"""PAC+ trainer CLI of the PyTorch port (counterpart of
``repro.launch.train``).

Runs the paper's workflow (Fig. 4): quantize → init the adapter →
epoch 1 (frozen backbone forward + adapter update, cache capture) →
epochs ≥ 2 (cache hit, adapter only). The flags are a thin veneer over
:class:`~repro_torch.runtime.RunSpec`; ``main()`` is flags → RunSpec →
``EdgeSession.run()``. It runs on the card unless ``--device cpu``:

    python -m repro_torch.launch.train --quant 8 --cache-compress int8 \\
        --epochs 3 --steps-per-epoch 2 --batch 4 --seq 512

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --epochs 3 --steps-per-epoch 4 --batch 2 --seq 16 --quant 8 --cache-compress int8 \\
        --cache-dir act_cache --ckpt adapter.msgpack

``--ckpt`` writes the trained adapter when the run ends (the reference's
msgpack format); ``--cache-dir`` keeps the activation cache on disk with
a manifest, so a second run with the same backbone, corpus and policy
resumes warm (every epoch cached, no backbone forward) and a changed
one is invalidated and re-captured.

``--kernels cuda`` (the default) runs epoch 1's frozen forward on the
quantized weights through the CUDA kernels, emits the taps in the
cache's storage form, and trains every epoch through the fused adapter
mix and blockwise LM-head cross-entropy kernels; ``--kernels ref`` is
plain PyTorch. On CPU tensors every kernel wrapper computes its plain
version.

``--dp N --stages S`` (``dp·stages > 1``) runs the hybrid DP x PP
trainer: the command spawns ``dp·stages`` ranks itself (gloo; on the
card every rank on ``cuda:{rank % device_count}``, the kernels built
once here first). Epoch 1 pipelines the frozen forward over each dp
row's stages (``--micro`` micro-batches, default the stage count) with
the adapter step data-parallel; later epochs run the cached step over
the whole pool. Rank 0 prints the lines; a failing rank fails the run:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --dp 2 --stages 2 --epochs 3 --steps-per-epoch 2 --batch 4 --seq 16

With ``--plan`` the planner's plan is the run's contract (paper §V-A,
Alg. 1): ``--plan auto`` plans over a ``--pool`` of devices at period
granularity and the winning plan chooses the stage count, the (possibly
uneven) period boundaries and, without ``--micro``, the micro-batch
count; ``--plan <file.json>`` replays a plan written earlier with
``--save-plan`` (either package's). The plan is resolved once, here,
before the ranks start: the command spawns the plan's ``dp x stages``
ranks and hands each the one plan. ``--calibrate`` prices the periods by
a FLOP count of the real step (on the ``meta`` device) instead of the
closed form:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --plan auto --pool 4 --epochs 2 --steps-per-epoch 2 --batch 4 --seq 16 \\
        --save-plan plan.json
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --plan plan.json --pool 4 --epochs 2 --steps-per-epoch 2 --batch 4 --seq 16
"""

from __future__ import annotations

import argparse

from repro_torch.configs import list_archs
from repro_torch.runtime import ConsoleHook, EdgeSession, RunSpec, RunSpecError
from repro_torch.runtime.session import resolve_layout


def _train_rank(spec: RunSpec, layout: str, device) -> None:
    """One rank of a distributed run (``launch.mesh.spawn`` calls it),
    executing the layout the parent resolved (JSON)."""
    import torch.distributed as dist

    lead = dist.get_rank() == 0
    EdgeSession(spec, device=device, log=print if lead else None, layout=layout).run(
        hooks=(ConsoleHook(),) if lead else ())


def _train_pool(spec: RunSpec, layout, device) -> None:
    """Spawn the ``dp·stages`` ranks of ``layout`` and wait for them."""
    from repro_torch.core.device import resolve_device
    from repro_torch.launch.mesh import spawn

    kind = resolve_device(device).type  # refuses without a card unless asked for the CPU
    if kind == "cuda" and spec.kernels == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # once here, not in every rank at once
    spawn(_train_rank, layout.dp, layout.stages, kind,
          args=(spec, layout.to_json(), None if kind == "cuda" else "cpu"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help=f"one of the ported configs: {', '.join(list_archs())}")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale variant")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--r", type=int, default=8, help="adapter reduction factor")
    ap.add_argument("--quant", type=int, default=None, choices=[4, 8])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--init", default="pruning", choices=["pruning", "random"])
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent activation-cache directory: a later run with the same "
                         "backbone, corpus and policy resumes warm (no backbone forward)")
    ap.add_argument("--cache-compress", default="f32", choices=["f32", "bf16", "int8"],
                    help="activation-cache entry compression policy")
    ap.add_argument("--cache-budget-mb", type=int, default=4096,
                    help="RAM budget for cache entries (compressed bytes)")
    ap.add_argument("--ckpt", default=None,
                    help="write the trained adapter here (msgpack, the reference's format)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel replicas (ranks a stage)")
    ap.add_argument("--stages", type=int, default=1, help="pipeline stages of epoch 1")
    ap.add_argument("--micro", type=int, default=None,
                    help="micro-batches per minibatch (default: --stages; a "
                         "replayed plan's micro count with --plan <file>; "
                         "swept and selected by the planner with --plan auto)")
    ap.add_argument("--plan", default=None,
                    help="'auto' (run Alg. 1 and execute its winning plan: "
                         "stage count, layer boundaries, micro count) or a "
                         "plan JSON saved with --save-plan")
    ap.add_argument("--pool", type=int, default=None,
                    help="device-pool size for --plan auto (default: "
                         "max(dp*stages, 4); the mesh uses dp*stages <= pool)")
    ap.add_argument("--save-plan", default=None,
                    help="write the executed plan as JSON for later replay")
    ap.add_argument("--calibrate", action="store_true",
                    help="price the periods by a FLOP count of the real step "
                         "(meta device) and plan from the counted LayerCosts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="cuda", choices=["cuda", "ref"],
                    help="'cuda' = the hand-written kernels; 'ref' = plain PyTorch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; no silent CPU fallback)")
    args = ap.parse_args(argv)
    try:
        spec = RunSpec.from_args(args)
        layout = resolve_layout(spec)  # validates; once, before any rank starts
        if layout.ranks > 1:
            _train_pool(spec, layout, args.device)
        else:
            EdgeSession(spec, device=args.device, log=print, layout=layout).run(
                hooks=(ConsoleHook(),))
    except RunSpecError as e:
        raise SystemExit(str(e))


if __name__ == "__main__":
    main()
