"""PAC+ trainer CLI of the PyTorch port (counterpart of
``repro.launch.train``, one device).

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
"""

from __future__ import annotations

import argparse

from repro_torch.runtime import ConsoleHook, EdgeSession, RunSpec, RunSpecError


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="cuda", choices=["cuda", "ref"],
                    help="'cuda' = the hand-written kernels; 'ref' = plain PyTorch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card; no silent CPU fallback)")
    args = ap.parse_args(argv)
    try:
        spec = RunSpec.from_args(args)
        EdgeSession(spec, device=args.device, log=print).run(hooks=(ConsoleHook(),))
    except RunSpecError as e:
        raise SystemExit(str(e))


if __name__ == "__main__":
    main()
