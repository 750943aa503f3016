#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit; TF32 off for float32
   matmuls and convolutions, so every plain version runs in full f32.
2. Build: compile the kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one process per source, all at once).
3. Serving kernels: ``quant_matmul``, flash and paged attention against
   their plain PyTorch versions at the serving path's shapes, with the
   stated tolerance; the device time per call (CUDA graph replays, L2
   cold; see ``Timer``) of the kernel, the plain version and one
   PyTorch call for the same function (a yardstick the port never
   calls), and the least time the card could take. ``quant_matmul`` at
   the decode step's M = 8 (the skinny path: one launch of
   ``skinny::gemv``, the contraction split over a thread block cluster
   and summed through distributed shared memory) and at M = 2048 and 4096
   (the tiled path, ``qmm_mma`` on the bf16 tensor cores with x·s split
   in three terms: the epoch-1 step's and the prefill's rows), one
   layer's seven projections summed at each M (``quant_matmul_layer``
   lines), each tiled line beside both its bounds (the tensor cores' with
   3 products, and f32's); int4 at M = 8 and 4096; the skinny path at
   M = 3, K = 1000 (a partial last slice), the tiled path at its smallest
   M = 9 and at M = 1001 with K = 1000 (masked M and K) and K = 998 (rows
   unaligned for 16-byte loads), N = 384, int8 and int4
   (``quant_matmul_ragged`` lines), and twice at M = 4096, K = 2048,
   N = 8192 and at M = 1, K = 8192, N = 2048
   (``quant_matmul_deterministic``: bit-equal). Flash attention
   (on the bf16 tensor cores, Q, K, V and P split in three terms) at the
   prefill shape beside both its bounds (12 bf16 products, and f32's) and
   SDPA's kernel names, with window 128 and soft-cap 30, at Sq = Sk = 37
   and 1001, hd 64 and 128, n_rep 1 and 2, each causal or not, window 32
   or none, soft-cap 30 or none (``flash_attention_ragged`` lines), and
   twice at the prefill shape (``flash_attention_deterministic``:
   bit-equal), and with Sq = 300 queries over Sk = 100 keys, window 32,
   where rows 131.. have no key and get V's mean, the reference's answer
   (``flash_attention_keyless``). Paged attention (one launch: each
   request's pages split over a thread block cluster, staged by cp.async,
   merged in rank order through distributed shared memory) at the check's
   shape (B = 8, Hkv = 8, n_rep = 2, hd = 128, int8 pages of 16 tokens,
   lengths <= 511) and at a long context (lengths <= 4095, max_pages 256),
   each beside its byte bound, the plain version and SDPA over gathered
   KV; at B 1, 3, 8 and 72, Hkv 2 and 8, n_rep 1, 2 and 8, hd 64 and 128,
   pages of 4 and 16 tokens, lengths on page edges up to 543 and padding
   rows, f32, bf16 and int8 pages, plain, window 64 with soft-cap 30, and
   window 20 (``paged_attention_ragged`` lines, unaligned pools too); and
   two calls and three CUDA-graph replays bit-equal
   (``paged_attention_deterministic``).
4. Serving: internlm2-1.8b at full width (24 layers, d=2048), random
   weights from a seeded generator, INT8 backbone and INT8 KV pages,
   4 users with r=8 adapters, 8 requests with ragged prompts, 32 new
   tokens each, through ``ServeEngine``. Launch counts are read from
   this run alone and must all be positive. Two more decode steps run
   under ``torch.profiler`` for the device's busy share and kernel time
   by name. Then the first prefill and two decode steps run again under
   the ``ref`` OpSet, and the logits are compared.
5. Training kernels: flash attention timed at the epoch-1 step's
   B·H = 4·16; ``mix_fwd``/``mix_dw`` and ``ce_fwd``/``ce_bwd`` the
   same way at the training path's shapes (ragged and soft-capped cases
   too), and the gradients of their two autograd Functions against
   autograd of the plain versions. ``mix_fwd`` and ``mix_dw`` (both on
   the bf16 tensor cores) also at T=1001, d=1000, d_a=100 with int8
   scales per 32 columns (every masked edge, scales changing inside a
   tile; ``mix_fwd`` with f32 and bf16 ``a`` too) and at T=37, d=130,
   d_a=17 with qblock 24 (unaligned rows; ``mix_fwd``'s dequantizing
   path), twice at the training shape (bit-equal), and beside both their
   bounds: the bf16 tensor cores' (a 3-term split triples the operations)
   and f32's. ``ce_fwd`` and ``ce_bwd`` (on the bf16 tensor cores, every
   f32 operand split in three terms: the forward's logits, then the
   backward's logits again and ``dh = P @ Wᵀ``) also at T=1001, d=1000,
   V=3001 and T=37, d=130, V=517 with and without the soft-cap (every
   masked edge; ``ce_bwd`` on the lse of the plain forward), twice at the
   training shape with and without it (bit-equal), and beside both their
   bounds (6 products, 12 for the backward). ``ce_bwd`` is also timed
   beside the backward alone of autograd on a graph built once (no
   logits recompute), which the library time, with its forward, is not.
6. Training: PAC+ on internlm2-1.8b at full width through
   ``EdgeSession``/``EpochRunner`` — INT8 backbone, int8 activation
   cache, pruning init, 3 epochs x 2 steps of 4 x 512 tokens: epoch 0
   full (frozen forward through ``quant_matmul`` and flash attention,
   taps emitted int8, copied to pinned host buffers on a side stream),
   epochs 1-2 from the cache through the mix and CE kernels, their
   batches read, stacked and copied by the ``CachePrefetcher`` that
   ``EdgeSession.epoch_scope`` arms. Launch counts from this run alone
   must all be positive.
   One cached batch then goes through the cached step under ``cuda`` and
   ``ref`` (loss and gradients compared), one full and one cached step
   run under ``torch.profiler``, and the same trainer runs under ``ref``
   (per-epoch losses compared). The run writes its adapter checkpoint
   and a persistent activation cache into a temporary directory
   (``persistence`` line): the checkpoint loads back bit-equal; a second
   run (1 epoch x 2 steps) over the cache directory is warm — every step
   cached, no ``quant_matmul``/``flash_attention`` launch, the first
   run's epoch-0 losses (its entries read off disk by the prefetcher's
   worker); another seed invalidates and re-captures it.
7. Personal kernels: ``adapter_fuse`` against its plain version (f32 and
   bf16, λ in {0, 0.5, 1}) at T = 1, 8, 2048 and ragged shapes on both
   of its paths (T <= 8: one launch of ``skinny::gemv``, with T = 3,
   d = 2047, d_a = 130 on its element-by-element loads), timed beside the
   plain version and ``torch.addmm`` (the tiled path, on the tensor
   cores, beside both its bounds); ``quant_matmul`` at M = 1; two calls
   bit-equal (``adapter_fuse_deterministic``) and both GEMV calls captured
   in a CUDA graph, replayed three times, equal to the eager call bit for
   bit (``skinny_graph_replay``); flash attention and ``quant_matmul`` at
   the prompt's shapes.
8. Personal: the checkpoint served with ``pac_decode_step`` at B = 1
   over an INT8 linear KV cache, 32 teacher-forced prompt tokens then
   32 greedy tokens, under ``cuda`` (launch counts from this run alone:
   ``adapter_fuse`` 24 and ``quant_matmul`` 168 per step) and ``ref``
   (equal tokens, logits compared), two steps under ``torch.profiler``;
   ``prefill_step`` against the teacher-forced f32-KV decode, and INT8
   against f32 KV. The same loop over an f32 KV cache under both OpSets
   (``personal_gap`` line: each step's gap, and the INT8 KV codes that
   the two INT8 runs wrote differently) holds ``cuda`` to ``ref``
   without the INT8 codes' one-step flips.
9. Prefetch: the cached epoch's input path at full width, 8 steps of
   4 x 512 tokens, int8 cache (``prefetch`` line). Epoch 0 fills the
   cache; from one snapshot the cached epoch then runs in turns through
   ``EpochRunner`` (the prefetcher: pinned ring, side-stream copies)
   and through ``step`` with no epoch scope (read and copied on the
   caller's thread), twice each, the second time with one step under
   ``torch.profiler``: per-step losses bit-equal, the prefetched batch's
   host→device copies ``Pinned -> Device`` on a stream no kernel runs
   on, epoch 1's tap copies ``Device -> Pinned``, no worker thread left;
   per-step wall times, medians, busy shares and memory high-water marks.
10. Distributed: first the six kernels of this path against their
   plain versions at the shapes one rank gives them (``quant_matmul`` at
   M = 512 over the layer's projections, flash at B·H = 1·16 x 512,
   mix and CE at T = 1024 and 512, int8 entries; ``*_distributed``
   lines); then the training phase's spec at dp=2 x stages=2 (12
   periods a stage, 2 micro-batches) through ``EdgeSession`` and
   ``EpochRunner`` in four ranks that ``repro_torch.launch.mesh.spawn``
   starts on the one card, over gloo, twice (``distributed`` line).
   Epoch 0 pipelines the frozen forward (``quant_matmul``, flash) over
   each dp row's two stages and runs the adapter step (mix and CE
   kernels) on each row's first stage; epochs 1-2 run the cached step
   over all four ranks, the owner (rank 0) scattering the cached rows.
   Gates: the first step's loss within 1e-4, every step's within 1e-5
   and the epoch means within 5e-2 of the training phase's; epoch 0's cache entries against the
   training phase's: b0 codes bit-equal, tap and b_final codes within one
   step (the share that moved printed); every rank's adapter and
   optimizer bit-equal after every step, and the losses of the two runs;
   each training kernel launched on the ranks that run it. Per rank and
   step: wall time, launches, bytes sent point to point and all-reduced
   with their host seconds; each rank's memory high-water mark.
11. Plan: the planner (Alg. 1) and plan-driven training. First
   ``quant_matmul`` at M = 1024 and flash at B·H = 2·16 x 512, the shapes
   a stage of the plan below gives them (``*_plan`` lines). The port's
   planner makes a ragged 3-stage plan of full internlm2-1.8b over a
   Jetson Nano (low power), a TX2 and a Nano (high), each holding half
   the backbone's weights and adapter state (micro-batch 2, 2
   micro-batches); its boundaries must be the JAX planner's (0, 5, 16,
   24), and it is saved as JSON. The calibrated cost model counts the
   full-width step's FLOPs on the meta device (``plan_calibration``).
   The training phase's spec then replays the saved plan
   (``plan=<file>, pool=3``), resolved once here and run as 3 gloo ranks
   on the card, dp=1 x 3 ragged stages: modes ``plan-driven dp1xpp3``,
   then ``cached pure-dp`` twice, the distributed phase's gates against
   the training phase's run, and each stage launching ``quant_matmul``
   7 x its periods x 2 micro-batches in epoch 1. Last ``plan="auto",
   pool=4, micro=2``: Alg. 1 picks (12, 12) on dp=2 x pp=2, and every
   step's loss and every rank's fingerprint equal the distributed
   phase's first run bit for bit. The ``plan`` line carries per rank its
   periods, step walls, launches, transfer bytes and host seconds and
   memory, and the planner's latency and simulated bubble fraction,
   estimates for the modelled Jetson devices, not times on the card.
12. Fleet: the training phase's spec (no checkpoint, no cache
   directory) as ``SessionJob``s under ``FleetScheduler`` on a
   ``SimClock`` (heartbeat timeout 1.5 s a tick), every member on the
   one card (placement and resharding, not transfers between cards):
   (a) ``alice`` alone on a bound pool of four members; (b) the same
   with ``dev1`` killed at tick 3, inside the first cached epoch; (c)
   ``alice`` and ``bob`` (seed 1) on one member with quantum 2,
   preempted through snapshots on disk; (d) one elastic step of (a)'s
   first cached batch under ``ref`` against ``cuda``. Capture steps run
   ``EdgeSession.step``, each cached step four one-sequence chunks of
   the mix and CE kernels summed in chunk order. Gates: (b) and (c)'s
   ``alice`` equal (a) bit for bit (every loss and the adapter's
   fingerprint), ``dev1`` detected lost and never placed after; (a)'s
   capture steps equal the training phase's bit for bit, its cached
   steps within 1e-5 and epochs within 5e-2; (d) loss within 2e-5,
   gradients within 1e-4·max(1, |g|max); (a)'s launches a step: 168
   ``quant_matmul``, 24 flash, 25 mix and 1 CE each in a capture step,
   100 mix and 4 CE each in a cached step (``fleet`` line: per run the
   ticks' placements, shares, lost and preempted, each step's wall time,
   mode and launches; memory high-water mark, phase time).
13. Summary: one JSON line ``{"kernels": [...]}`` (eight kernels, each
   with its launches on every path and its device kernels by name:
   ``skinny::gemv`` for ``quant_matmul`` at M <= 8 and ``adapter_fuse`` at
   T <= 8), the card's line, and last ``{"ok": true, "device": {...}}``.

Needs one CUDA card and the repository's ``src`` beside this file; it
imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12     # H100 SXM f32 on the CUDA cores (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 on the tensor cores, dense (NVIDIA data sheet)
REPEATS = 15

QMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048)]  # (K, N)
QMM_SKINNY_ROWS = 8  # quant_matmul's tiled path runs above this M (csrc/quant_matmul.cu)
#: the seven projections of one internlm2-1.8b layer, by (K, N)
#: the decode path's kernels, by name in a profile: the GEMV (quant_matmul
#: at M <= 8, adapter_fuse at T <= 8), paged attention
SKINNY_WATCH = ("skinny::gemv", "paged_attn")
LAYER_PROJECTIONS = [(2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
                     (2048, 8192), (2048, 8192), (8192, 2048)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    """The least time for the work: bytes over the HBM rate or operations
    over the card's peak for the operands' type (f32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Device time of one call: ``CALLS`` calls captured in a CUDA graph
    and replayed back to back (so host launch overhead is not counted),
    median over ``REPEATS`` replays, L2 flushed before each replay. Pass
    several closures over distinct input copies to cycle through them, so
    that inputs smaller than the 50 MB L2 are read cold, as in a decode
    step that walks 24 layers."""

    CALLS = 12

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2

    def __call__(self, fns, calls: int = CALLS, repeats: int = REPEATS) -> float:
        """``calls``/``repeats`` shrink for calls of tens of milliseconds."""
        fns = fns if isinstance(fns, list) else [fns]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fns[i % len(fns)]()
        ms = self._median(graph.replay, calls, repeats)
        del graph
        return ms

    def eager(self, fn, calls: int, repeats: int) -> float:
        """The same without a CUDA graph, ``calls`` calls launched from the
        host each time (for work that cannot be captured, in calls of
        milliseconds, where the host's launches hide)."""
        fn()
        torch.cuda.synchronize()
        return self._median(lambda: [fn() for _ in range(calls)], calls, repeats)

    def _median(self, run, calls: int, repeats: int) -> float:
        times = []
        for _ in range(repeats):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)


def copies(nbytes: int) -> int:
    """Input copies to cycle through so that they exceed the L2 twice."""
    return max(1, -(-(128 << 20) // max(nbytes, 1)))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > {tol:.1e}")


# ---------------------------------------------------------------- kernels


def qmm_case(timer: Timer, gen: torch.Generator, M: int, K: int, N: int, bits: int) -> dict:
    """``quant_matmul`` at (M, K, N) against its plain version, timed
    beside the plain version and cuBLAS on the pre-dequantized weight."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul

    x, w, got, want = qmm_check(gen, M, K, N, bits)
    nbytes = M * K * 4 + w.q.numel() + w.scale.numel() * 4 + M * N * 4
    ws = [w] + [quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, bits)
                for _ in range(copies(w.q.numel()) - 1)]
    wfs = [dequantize(c) for c in ws[:copies(4 * K * N)]]
    b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
    bounds = {}
    if M > QMM_SKINNY_ROWS:  # the tiled path: bf16 tensor cores, x·s split in three
        f32_ms, f32_by = b_ms, b_by
        b_ms, b_by = bound(nbytes, 3 * 2.0 * M * N * K, BF16_FLOP_PER_S)
        bounds = {"bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
                  "bound_f32_by": f32_by}
    r = {"check": "quant_matmul", "M": M, "K": K, "N": N, "bits": bits,
         "path": "tiled" if M > QMM_SKINNY_ROWS else "skinny",
         "max_abs_err": max_err(got, want), "tol": "atol 1e-3 + rtol 1e-4",
         "tol_reason": qmm_tol_reason(M),
         "ms": timer([lambda c=c: quant_matmul(x, c.q, c.scale, bits=bits) for c in ws]),
         "plain_ms": timer([lambda c=c: ref.quant_matmul_ref(x, c.q, c.scale, bits)
                            for c in ws]),
         "library_ms": timer([lambda c=c: torch.matmul(x, c) for c in wfs]),
         "library": "torch.matmul on the pre-dequantized f32 weight",
         "bound_ms": b_ms, "bound_by": b_by, **bounds}
    emit(r)
    return r


def qmm_tol_reason(M: int) -> str:
    reason = "f32 atol 1e-3 / rtol 1e-4 of the reference (tests/test_kernels.py:38); "
    if M <= QMM_SKINNY_ROWS:
        return reason + "sums reorder"
    return reason + ("the kernel rounds x·s in f32 where the reference rounds q·s, and "
                     "carries it to the tensor cores as three bf16 terms (~24 bits, "
                     "tests/test_torch_kernels.py::test_quant_matmul_bf16_split_error_model: "
                     "~2e-7 against the exact product, under the plain f32 version's own "
                     "error); sums reorder")


def qmm_check(gen: torch.Generator, M: int, K: int, N: int, bits: int):
    """``quant_matmul`` on seeded inputs at (M, K, N), held to its plain
    version: (x, w, kernel's y, plain y)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul

    x = torch.randn(M, K, generator=gen, device=DEV)
    w = quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, bits)
    got = quant_matmul(x, w.q, w.scale, bits=bits)
    want = ref.quant_matmul_ref(x, w.q, w.scale, bits)
    if got.shape != (M, N) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"quant_matmul M={M} K={K} N={N} int{bits}: shape "
                             f"{tuple(got.shape)} or non-finite output")
    check(f"quant_matmul M={M} K={K} N={N} int{bits}",
          float(((got - want).abs() - 1e-4 * want.abs()).max()), 1e-3)
    return x, w, got, want


def layer_row(qmm: dict, M: int) -> dict:
    """The 7 int8 projections of one layer at ``M`` rows, times summed."""
    def layer_sum(key):
        return sum(qmm[(M, K, N, 8)][key] for K, N in LAYER_PROJECTIONS)

    rows = [qmm[(M, K, N, 8)] for K, N in QMM_SHAPES]
    r = {"at": f"the 7 projections of one layer at M={M}, int8 (times summed)",
         "max_abs_err": max(r_["max_abs_err"] for r_ in rows),
         "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
         "bound_ms": layer_sum("bound_ms"), "bound_by": rows[0]["bound_by"],
         "library_ms": layer_sum("library_ms")}
    if M > QMM_SKINNY_ROWS:
        r.update(bound_tc_ms=layer_sum("bound_tc_ms"), bound_f32_ms=layer_sum("bound_f32_ms"))
    return r


FLASH_TOL = 3e-5  # the reference's flash tolerance (tests/test_kernels.py:105)
FLASH_TOL_REASON = ("the reference's flash tolerance (tests/test_kernels.py:105); Q, K, V and P "
                    "reach the tensor cores as three bf16 terms each (~24 bits: "
                    "tests/test_torch_kernels.py::test_flash_bf16_split_error_model errs 4.5e-7 "
                    "against float64 attention, under the plain f32 version's own error); "
                    "sums reorder")


def flash_case(timer: Timer, gen: torch.Generator, B: int, H: int, Hkv: int, S: int, hd: int,
               at: str):
    """Causal ``flash_attention`` over grouped KV at (B·H, S, hd) against
    its plain version, timed beside the plain version and SDPA (KV heads
    repeated beforehand), with both bounds: the bf16 tensor cores' (each
    product's 3-term split takes six bf16 products: 12 in all) and f32's.
    Returns (the row, (q, k, v), the SDPA call)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn(B * H, S, hd, generator=gen, device=DEV)
    k = torch.randn(B * Hkv, S, hd, generator=gen, device=DEV)
    v = torch.randn(B * Hkv, S, hd, generator=gen, device=DEV)
    got, want = flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)
    if got.shape != q.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {at}: shape {tuple(got.shape)} or non-finite")
    err = max_err(got, want)
    check(f"flash_attention {at}", err, FLASH_TOL)
    q4, k4, v4 = (t.reshape(B, -1, S, hd) for t in (q, k, v))
    k4r, v4r = k4.repeat_interleave(H // Hkv, dim=1), v4.repeat_interleave(H // Hkv, dim=1)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4r, v4r, is_causal=True)

    pairs = S * (S + 1) // 2  # causal (query, key) pairs per head
    nbytes = 4.0 * (q.numel() * 2 + k.numel() + v.numel())
    flops = 4.0 * hd * pairs * B * H
    f32_ms, f32_by = bound(nbytes, flops)
    b_ms, b_by = bound(nbytes, 6 * flops, BF16_FLOP_PER_S)
    r = {"check": "flash_attention", "at": at, "BH": B * H, "BHkv": B * Hkv, "S": S, "hd": hd,
         "causal": True, "max_abs_err": err, "tol": f"atol {FLASH_TOL}",
         "tol_reason": FLASH_TOL_REASON,
         "ms": timer(lambda: flash_attention(q, k, v)),
         "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v)),
         "library_ms": timer(sdpa),
         "library": "scaled_dot_product_attention, causal, KV heads repeated beforehand",
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    return r, (q, k, v), sdpa


def device_kernels(fn) -> list:
    """The names of the kernels one call of ``fn`` runs on the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:120] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def flash_ragged(gen: torch.Generator) -> None:
    """``flash_attention`` at Sq = Sk = 37 and 1001 (partial query and key
    tiles), hd 64 and 128, n_rep 1 and 2, each with causal on and off,
    window 32 or none and soft-cap 30 or none, against its plain version:
    one line per (S, hd, n_rep)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    for S in (37, 1001):
        for hd in (64, 128):
            for n_rep in (1, 2):
                q = torch.randn(4 * n_rep, S, hd, generator=gen, device=DEV)
                k, v = (torch.randn(4, S, hd, generator=gen, device=DEV) for _ in range(2))
                cases = []
                for causal in (True, False):
                    for window in (None, 32):
                        for cap in (None, 30.0):
                            kw = dict(causal=causal, window=window, attn_softcap=cap)
                            got = flash_attention(q, k, v, **kw)
                            if not bool(torch.isfinite(got).all()):
                                raise AssertionError(f"flash_attention S={S} {kw}: non-finite")
                            err = max_err(got, ref.flash_attention_ref(q, k, v, **kw))
                            check(f"flash_attention S={S} hd={hd} n_rep={n_rep} {kw}", err,
                                  FLASH_TOL)
                            cases.append({**kw, "max_abs_err": err})
                worst = max(c["max_abs_err"] for c in cases)
                emit({"check": "flash_attention_ragged", "S": S, "hd": hd, "n_rep": n_rep,
                      "BH": 4 * n_rep, "cases": cases, "max_abs_err": worst, "check_value": worst,
                      "tol": f"atol {FLASH_TOL}", "tol_reason": FLASH_TOL_REASON})


def flash_keyless(gen: torch.Generator) -> None:
    """``flash_attention`` with Sq = 300 queries over Sk = 100 keys and
    window 32 (B·H = 8 over 4 KV heads, hd 64 and 128, causal or not):
    rows q >= Sk + window - 1 = 131 have no key and get V's mean, as in
    the plain version and the reference."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _keyless_from, flash_attention

    Sq, Sk, window = 300, 100, 32
    for hd in (64, 128):
        q = torch.randn(8, Sq, hd, generator=gen, device=DEV)
        k, v = (torch.randn(4, Sk, hd, generator=gen, device=DEV) for _ in range(2))
        cases = []
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            if got.shape != q.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention keyless hd={hd}: shape or non-finite")
            first = _keyless_from(Sq, Sk, window)
            err = max_err(got, want)
            check(f"flash_attention keyless hd={hd} causal={causal}", err, FLASH_TOL)
            cases.append({"causal": causal, "max_abs_err": err,
                          "max_abs_err_keyless_rows": max_err(got[:, first:], want[:, first:])})
        worst = max(c["max_abs_err"] for c in cases)
        emit({"check": "flash_attention_keyless", "BH": 8, "BHkv": 4, "Sq": Sq, "Sk": Sk,
              "window": window, "hd": hd, "keyless_rows": Sq - first, "cases": cases,
              "max_abs_err": worst, "check_value": worst, "tol": f"atol {FLASH_TOL}",
              "tol_reason": FLASH_TOL_REASON})


PAGED_TOL = {"f32": 2e-4, "int8": 2e-4, "bf16": 3e-2}  # tests/test_decode_parity.py:36
PAGED_TOL_REASON = "the reference's paged tolerances (tests/test_decode_parity.py:36)"


def paged_case(gen: torch.Generator, rng: np.random.Generator, B: int, Hkv: int, n_rep: int,
               hd: int, page: int, max_pages: int, lengths_np: np.ndarray, padding=()):
    """Seeded decode inputs: q (B, Hkv, n_rep, hd), f32 K/V pools of
    B * max_pages + 1 pages (page 0 the null page), and block tables that
    give each row the pages its length needs, in a random order; the rows
    in ``padding`` keep the null page (length 0: a padding row)."""
    n_pages = B * max_pages + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    bt_np = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        if b not in padding:
            n = min(max_pages, -(-(int(lengths_np[b]) + 1) // page))
            bt_np[b, :n] = perm[b * max_pages:b * max_pages + n]
    q = torch.randn(B, Hkv, n_rep, hd, generator=gen, device=DEV)
    kf = torch.randn(n_pages, page, Hkv, hd, generator=gen, device=DEV)
    vf = torch.randn(n_pages, page, Hkv, hd, generator=gen, device=DEV)
    return (q, kf, vf, torch.from_numpy(bt_np).to(DEV),
            torch.from_numpy(lengths_np.astype(np.int32)).to(DEV))


def paged_bound(lengths_np: np.ndarray, Hkv: int, n_rep: int, hd: int, page: int):
    """The least time of one int8 call: each attended K/V row and its scale
    read once, q read and the output written once, the block-table entries
    and lengths read once; 4 * n_rep * hd f32 FLOPs a token and kv head."""
    tokens = int((lengths_np.astype(np.int64) + 1).sum())
    B = len(lengths_np)
    nbytes = (tokens * Hkv * 2 * (hd + 4) + 2 * B * Hkv * n_rep * hd * 4
              + 4 * int(sum(-(-(int(n) + 1) // page) for n in lengths_np)) + 4 * B)
    return bound(nbytes, 4.0 * n_rep * hd * Hkv * tokens)


def paged_timed(timer: Timer, gen: torch.Generator, lengths_np: np.ndarray, max_pages: int,
                at: str) -> dict:
    """``paged_attention`` at B = len(lengths), Hkv = 8, n_rep = 2,
    hd = 128, int8 pages of 16 tokens, against its plain version; timed
    beside the plain version and SDPA over the KV gathered to dense f32
    beforehand (length mask), with the byte bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, plan_for
    from repro_torch.serve.paging import quantize_kv_pages

    B, Hkv, n_rep, hd, page = len(lengths_np), 8, 2, 128, 16
    rng = np.random.default_rng(SEED)
    qd, kf, vf, bt, lengths = paged_case(gen, rng, B, Hkv, n_rep, hd, page, max_pages, lengths_np)
    (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)
    del kf, vf
    got = paged_attention(qd, kq, vq, bt, lengths, k_scale=ks, v_scale=vs)
    want = ref.paged_attention_ref(qd, kq, vq, bt, lengths, k_scale=ks, v_scale=vs)
    if not torch.isfinite(got).all():
        raise AssertionError(f"paged_attention {at}: non-finite output")
    check(f"paged_attention {at}", max_err(got, want), PAGED_TOL["int8"])
    b_ms, b_by = paged_bound(lengths_np, Hkv, n_rep, hd, page)
    S = max_pages * page
    idx = bt.long()
    kd = (kq[idx].float() * ks[idx][..., None]).reshape(B, S, Hkv, hd)
    vd = (vq[idx].float() * vs[idx][..., None]).reshape(B, S, Hkv, hd)
    kd = kd.transpose(1, 2).repeat_interleave(n_rep, dim=1)
    vd = vd.transpose(1, 2).repeat_interleave(n_rep, dim=1)
    qsd = qd.reshape(B, Hkv * n_rep, 1, hd)
    mask = (torch.arange(S, device=DEV)[None, :] <= lengths[:, None])[:, None, None, :]
    pools = [(kq, vq, ks, vs)] + [(kq.clone(), vq.clone(), ks.clone(), vs.clone())
                                  for _ in range(copies(2 * (kq.numel() + 4 * ks.numel())) - 1)]
    r = {"check": "paged_attention", "at": at, "B": B, "Hkv": Hkv, "n_rep": n_rep, "hd": hd,
         "page": page, "max_pages": max_pages, "lengths": lengths_np.tolist(), "pages": "int8",
         "plan": plan_for(qd, B, Hkv, n_rep, hd, page, max_pages, 0)._asdict(),
         "max_abs_err": max_err(got, want), "tol": f"atol {PAGED_TOL['int8']}",
         "tol_reason": PAGED_TOL_REASON,
         "ms": timer([lambda p=p: paged_attention(qd, p[0], p[1], bt, lengths, k_scale=p[2],
                                                  v_scale=p[3]) for p in pools]),
         "plain_ms": timer([lambda p=p: ref.paged_attention_ref(
             qd, p[0], p[1], bt, lengths, k_scale=p[2], v_scale=p[3]) for p in pools]),
         "library_ms": timer(lambda: torch.nn.functional.scaled_dot_product_attention(
             qsd, kd, vd, attn_mask=mask)),
         "library": "scaled_dot_product_attention over dense f32 KV gathered beforehand",
         "bound_ms": b_ms, "bound_by": b_by}
    emit(r)
    return r


def paged_ragged(gen: torch.Generator) -> None:
    """``paged_attention`` against its plain version at B 1, 3, 8 and 72
    (the last groups two kv heads a block, one rank: no cluster), Hkv 2
    and 8, n_rep 1, 2 and 8, hd 64 and 128, pages of 4 and 16 tokens,
    lengths on page edges up to 543 (the serving ``max_len`` 544) and
    padding rows (length 0 on the null page), f32, bf16 and int8 pages,
    each plain, with window 64 and soft-cap 30, and with window 20 (which
    leaves most ranks of a long row empty); and int8 and bf16 pools whose
    base is not 16-byte aligned. One line per shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, plan_for
    from repro_torch.serve.paging import quantize_kv_pages

    rng = np.random.default_rng(SEED + 1)
    shapes = [  # B, Hkv, n_rep, hd, page, max_pages, lengths, padding rows
        (1, 2, 1, 64, 4, 136, [543], ()),
        (3, 8, 8, 128, 16, 34, [0, 16, 543], (0,)),
        (8, 2, 2, 64, 16, 34, [0, 15, 16, 17, 255, 256, 542, 543], ()),
        (8, 8, 2, 128, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
        (3, 2, 8, 128, 4, 136, [0, 3, 543], (0,)),
        (72, 8, 2, 128, 16, 34, list(rng.integers(0, 544, size=72)), (5,)),
    ]
    options = {"plain": {}, "window64_cap30": dict(window=64, attn_softcap=30.0),
               "window20": dict(window=20)}
    for B, Hkv, n_rep, hd, page, max_pages, lens, padding in shapes:
        lengths_np = np.array(lens, np.int32)
        lengths_np[list(padding)] = 0
        q, kf, vf, bt, lengths = paged_case(gen, rng, B, Hkv, n_rep, hd, page, max_pages,
                                            lengths_np, padding)
        (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)
        pools = {"f32": ((kf, vf), {}), "bf16": ((kf.bfloat16(), vf.bfloat16()), {}),
                 "int8": ((kq, vq), dict(k_scale=ks, v_scale=vs))}
        if B == 8 and hd == 64:  # pools whose base is off 16-byte alignment: plain loads
            def shifted(t):
                flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)
                out = flat[1:].view(t.shape)
                out.copy_(t)
                return out
            pools["int8_unaligned"] = ((shifted(kq), shifted(vq)), dict(k_scale=ks, v_scale=vs))
            pools["bf16_unaligned"] = ((shifted(kf.bfloat16()), shifted(vf.bfloat16())), {})
        errs = {}
        for kind, ((kp, vp), scales) in pools.items():
            for opt, kw in options.items():
                got = paged_attention(q, kp, vp, bt, lengths, **scales, **kw)
                want = ref.paged_attention_ref(q, kp, vp, bt, lengths, **scales, **kw)
                label = f"{kind} {opt}"
                if not torch.isfinite(got).all():
                    raise AssertionError(f"paged_attention_ragged B={B} {label}: non-finite")
                errs[label] = max_err(got, want)
                check(f"paged_attention_ragged B={B} Hkv={Hkv} n_rep={n_rep} hd={hd} "
                      f"page={page} {label}", errs[label], PAGED_TOL[kind.split("_")[0]])
        emit({"check": "paged_attention_ragged", "B": B, "Hkv": Hkv, "n_rep": n_rep, "hd": hd,
              "page": page, "max_pages": max_pages, "lengths": lengths_np.tolist(),
              "padding_rows": list(padding),
              "plan_int8": plan_for(q, B, Hkv, n_rep, hd, page, max_pages, 0)._asdict(),
              "max_abs_err": errs, "tol": {k: f"atol {v}" for k, v in PAGED_TOL.items()},
              "tol_reason": PAGED_TOL_REASON})


def paged_deterministic(gen: torch.Generator, lengths_np: np.ndarray, max_pages: int) -> None:
    """Two eager calls at the check's shape bit-equal, and the call
    captured in a CUDA graph and replayed three times, each bit-equal to
    the eager call."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serve.paging import quantize_kv_pages

    q, kf, vf, bt, lengths = paged_case(gen, np.random.default_rng(SEED), len(lengths_np), 8, 2,
                                        128, 16, max_pages, lengths_np)
    (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)

    def fn():
        return paged_attention(q, kq, vq, bt, lengths, k_scale=ks, v_scale=vs)

    eager, again = fn(), fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn()
    replays = []
    for _ in range(3):
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(static, eager)))
    del graph
    ok = bool(torch.equal(eager, again)) and all(replays)
    emit({"check": "paged_attention_deterministic", "at": "B=8 Hkv=8 n_rep=2 hd=128 page=16 int8",
          "calls_bit_equal": bool(torch.equal(eager, again)), "replays_equal_eager": replays,
          "bit_equal": ok})
    if not ok:
        raise AssertionError(f"paged_attention: reruns or graph replays differ ({replays})")


def paged_phase(timer: Timer, gen: torch.Generator) -> dict:
    """Paged attention at the check's shape (B = 8, Hkv = 8, n_rep = 2,
    hd = 128, int8 pages of 16 tokens, seeded lengths <= 511, max_pages
    32) and at a long context (seeded lengths <= 4095, max_pages 256),
    both timed; the ragged cases; bit-equal reruns and graph replays."""
    rng = np.random.default_rng(SEED)
    lengths_np = rng.integers(1, 512, size=8).astype(np.int32)
    r = paged_timed(timer, gen, lengths_np, 32, "decode B=8 Hkv=8 n_rep=2 hd=128 page=16 int8, "
                    "lengths<=511")
    long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
    long = paged_timed(timer, gen, long_lengths, 256, "long context B=8 Hkv=8 n_rep=2 hd=128 "
                       "page=16 int8, lengths<=4095")
    paged_ragged(gen)
    paged_deterministic(gen, lengths_np, 32)
    row = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "at", "plan")}
    row["long"] = {k: long[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "at", "plan")}
    return row


def kernel_phase(timer: Timer, gen: torch.Generator):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul

    rows = {}

    # quant_matmul: decode M=8, epoch-1 M=2048 and prefill M=4096 over the
    # path's (K, N), plus int4
    qmm = {}
    cases = [(M, K, N, 8) for M in (8, 2048, 4096) for K, N in QMM_SHAPES] + [
        (8, 2048, 2048, 4), (4096, 2048, 2048, 4)]
    for M, K, N, bits in cases:
        qmm[(M, K, N, bits)] = qmm_case(timer, gen, M, K, N, bits)
    for M in (8, 2048, 4096):
        emit({"check": "quant_matmul_layer", "M": M, **layer_row(qmm, M)})
    rows["quant_matmul"] = layer_row(qmm, 8)
    # the skinny path with a partial last slice; the tiled path's ragged
    # edges: its smallest M, masked M and K, rows unaligned for 16-byte
    # loads (K = 998)
    for M, K, N in ((3, 1000, 384), (9, 1000, 384), (1001, 1000, 384), (1001, 998, 384)):
        for bits in (8, 4):
            _, _, got, want = qmm_check(gen, M, K, N, bits)
            emit({"check": "quant_matmul_ragged", "M": M, "K": K, "N": N, "bits": bits,
                  "max_abs_err": max_err(got, want),
                  "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
                  "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    x, w, got, _ = qmm_check(gen, 4096, 2048, 8192, 8)
    again = quant_matmul(x, w.q, w.scale)
    emit({"check": "quant_matmul_deterministic", "M": 4096, "K": 2048, "N": 8192,
          "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("quant_matmul: two calls at M=4096 differ")
    x, w, got, _ = qmm_check(gen, 1, 8192, 2048, 8)
    again = quant_matmul(x, w.q, w.scale)
    emit({"check": "quant_matmul_deterministic", "M": 1, "K": 8192, "N": 2048,
          "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("quant_matmul: two calls at M=1 differ")
    del x, w, got, again

    # flash attention: prefill, B·H = 8·16, S = 512, hd = 128, causal, grouped KV
    B, H, Hkv, S, hd = 8, 16, 8, 512, 128
    r, (q, k, v), sdpa = flash_case(timer, gen, B, H, Hkv, S, hd, "prefill")
    r["library_kernels"] = device_kernels(sdpa)  # which of PyTorch's attention kernels runs
    kw = dict(window=128, attn_softcap=30.0)
    r["max_abs_err_window128_cap30"] = max_err(flash_attention(q, k, v, **kw),
                                               ref.flash_attention_ref(q, k, v, **kw))
    check("flash_attention window=128 cap=30", r["max_abs_err_window128_cap30"], FLASH_TOL)
    emit(r)
    rows["flash_attention"] = {k_: r[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "bound_tc_ms", "bound_f32_ms",
                                                    "library_ms", "library_kernels")}
    rows["flash_attention"]["at"] = "prefill BH=8*16 S=512 hd=128 causal"
    got, again = flash_attention(q, k, v), flash_attention(q, k, v)
    emit({"check": "flash_attention_deterministic", "BH": B * H, "BHkv": B * Hkv, "S": S,
          "hd": hd, "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("flash_attention: two calls at the prefill shape differ")
    del q, k, v, got, again, sdpa
    flash_ragged(gen)
    flash_keyless(gen)

    rows["paged_attention"] = paged_phase(timer, gen)
    return rows


# ---------------------------------------------------------------- serving


def device_profile(fn, watch=(), trace: Path = None) -> dict:
    """``fn`` under ``torch.profiler``: the host wall time, the device's
    busy time and its share of the wall time, the torch ops called from
    Python (top-level host events), device time by kernel name (the top
    ten) and summed over the kernels whose names hold each of ``watch``.
    With ``trace`` (a file to write the profiler's trace to) also every
    memory copy (its kind, stream and bytes) and the kernels' streams."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    streams = {}
    if trace is not None:
        prof.export_chrome_trace(str(trace))
        events = json.loads(Path(trace).read_text())["traceEvents"]
        streams = {"copies": [{"kind": e["name"], "stream": e["args"]["stream"],
                               "bytes": e["args"]["bytes"], "ms": e["dur"] / 1e3}
                              for e in events if e.get("cat") == "gpu_memcpy"],
                   "kernel_streams": sorted({e["args"]["stream"] for e in events
                                             if e.get("cat") == "kernel"})}
    by_name = {}
    host_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.cpu_parent is None:
            host_ops += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
            "device_busy_share": busy_us / wall_us if by_name else "not measured",
            "host_ops": host_ops,
            "kernels_by_device_ms": [[n[:80], t / 1e3] for n, t in top],
            **({"watched_device_ms": {w: sum(t for n, t in by_name.items() if w in n) / 1e3
                                      for w in watch}} if watch else {}),
            **streams}


def profile_decode(eng, prompts, names) -> None:
    """Two steady decode steps at batch 8 under ``torch.profiler``."""
    for i, p in enumerate(prompts):
        eng.submit(p, names[i % len(names)], max_new_tokens=8)
    eng.step()  # prefill + first decode step
    eng.step()
    emit({"phase": "decode_profile", "steps": 2, "batch": 8,
          **device_profile(lambda: (eng.step(), eng.step()), watch=SKINNY_WATCH)})
    eng.drain()


def serving_phase(gen: torch.Generator):
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import gather_adapters, stack_adapters
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.kernels import flash_attention, paged_attention, quant_matmul
    from repro_torch.models.backbone import init_backbone
    from repro_torch.serve import ServeEngine, paging
    from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

    kernels = {"quant_matmul": quant_matmul, "flash_attention": flash_attention,
               "paged_attention": paged_attention}
    cfg = get_arch("internlm2-1.8b")
    page, max_len, max_batch, n_new, r = 16, 544, 8, 32, 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backbone = init_backbone(gen, cfg, device="cuda", quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device="cuda") for u in range(4)}
    torch.cuda.synchronize()
    emit({"phase": "serving_init", "arch": cfg.name, "params": cfg.param_count(),
          "backbone_bytes": tree_storage_bytes(backbone), "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompt_lens = rng.integers(64, 481, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in prompt_lens]
    names = list(users)

    def serve(n_tokens):
        eng = ServeEngine(backbone, cfg, users, r=r, kernel_impl="cuda", kv_policy="int8",
                          page_size=page, max_len=max_len, max_batch=max_batch)
        handles = [eng.submit(p, names[i % 4], max_new_tokens=n_tokens)
                   for i, p in enumerate(prompts)]
        t = time.perf_counter()
        eng.drain()
        return eng, [h.result() for h in handles], time.perf_counter() - t

    serve(2)  # warm-up: first launches, allocator growth
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    eng, streams, wall = serve(n_new)
    launches = {n: mod.launches for n, mod in kernels.items()}
    for s in streams:
        if len(s) != n_new or not all(0 <= t < cfg.vocab for t in s):
            raise AssertionError(f"bad stream: {s}")
    emit({"phase": "serving", "requests": len(prompts), "users": len(users),
          "prompt_lens": prompt_lens.tolist(), "new_tokens": n_new, "kv": "int8", "page": page,
          "prefill_ms": eng.prefill_seconds * 1e3, "decode_steps": eng.decode_steps,
          "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
          "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds,
          "wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "init_max_memory_allocated": init_peak,
          "launches": launches, "first_tokens": [s[:4] for s in streams]})
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    del eng
    profile_decode(ServeEngine(backbone, cfg, users, r=r, kernel_impl="cuda", kv_policy="int8",
                               page_size=page, max_len=max_len, max_batch=max_batch),
                   prompts, names)

    # the first prefill and 2 decode steps again, cuda OpSet vs ref OpSet
    bank = stack_adapters([users[n] for n in names])
    ab = gather_adapters(bank, torch.arange(8, device="cuda") % 4)
    max_pages = -(-max_len // page)
    state = {}
    for impl in ("cuda", "ref"):
        table = paging.PageTable(paging.PageAllocator(max_batch * max_pages + 1), page, max_pages)
        for i, p in enumerate(prompts):
            table.open(i, len(p))
        pools = paging.init_pools(cfg, table.allocator.n_pages, page, "int8", "cuda")
        state[impl] = [table, pools, None]
    s_pad = 1 << (int(max(prompt_lens)) - 1).bit_length()
    toks = np.zeros((8, s_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    logits = {}
    for impl, st in state.items():
        bt, lengths = st[0].dense(range(8))
        lg, st[1], st[2] = paged_prefill(
            backbone, ab, torch.from_numpy(toks).cuda(), torch.from_numpy(lengths).cuda(),
            st[1], torch.from_numpy(bt).cuda(), cfg=cfg, max_len=max_len, r=r,
            kernel_impl=impl)
        logits[impl] = [lg[:, 0]]
    for _ in range(2):
        tok = logits["cuda"][-1].argmax(-1).int()[:, None]
        for impl, st in state.items():
            table = st[0]
            for i in range(8):
                table.extend_to(i, table.length(i) + 1)
            bt, lengths = table.dense(range(8))
            lg, st[1], st[2] = paged_pac_decode_step(
                backbone, ab, tok, st[1], torch.from_numpy(bt).cuda(),
                torch.from_numpy(lengths).cuda(), st[2], cfg=cfg, r=r, kernel_impl=impl)
            logits[impl].append(lg[:, 0])
            for i in range(8):
                table.append_token(i)
    tol = 2e-2
    diffs = [max_err(a, b) for a, b in zip(logits["cuda"], logits["ref"])]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(logits["cuda"], logits["ref"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["cuda"] + logits["ref"])
    emit({"phase": "cuda_vs_ref", "steps": ["prefill", "decode1", "decode2"],
          "max_abs_dlogits": diffs, "greedy_agreement": agree, "tol": tol,
          "tol_reason": "f32 sums reorder through 24 layers, and an int8 KV code may move by "
                        "one step where the two paths' K/V differ in the last ulp",
          "logits_shape": list(logits["cuda"][0].shape), "finite": finite})
    if not finite or max(diffs) > tol or logits["cuda"][0].shape != (8, cfg.vocab):
        raise AssertionError(f"cuda vs ref logits: {diffs} (tol {tol}), finite={finite}")
    return launches

# ---------------------------------------------------------------- training kernels

TRAIN_T, TRAIN_D, TRAIN_DA, TRAIN_V = 4 * 512, 2048, 256, 92544  # internlm2-1.8b, r=8, B=4, S=512


def mix_fwd_check(out, bw, want_out, want_bw) -> float:
    """max(|Δ| − rtol·|want|) over ``out`` and ``bw``, rtol 1e-4; a bf16
    ``out`` adds one bf16 step (2^-7 relative): two f32 results inside the
    tolerance may round to neighbouring bf16 values."""
    rtol = 1e-4 + (2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0)
    got, want = out.float(), want_out.float()
    return max(float(((got - want).abs() - rtol * want.abs()).max()),
               float(((bw - want_bw).abs() - 1e-4 * want_bw.abs()).max()))


def _row(r, at):
    out = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    out["at"] = at
    return out


def training_kernel_phase(timer: Timer, gen: torch.Generator):
    """Flash attention at the epoch-1 step's shape, timed; the four
    training kernels against their plain versions at the training path's
    shapes, their timings, and the gradients of the two autograd Functions
    against autograd of the plain versions."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref
    from repro_torch.kernels.cached_step import dq_adapter_mix
    from repro_torch.kernels.cached_step import lmhead_ce as lmhead_ce_op

    dev = "cuda"
    rows = {}

    # ---- flash attention at the epoch-1 step's shape: B·H = 4·16, S = 512
    emit(flash_case(timer, gen, 4, 16, 8, 512, 128, "training")[0])

    # ---- mix_fwd / mix_dw: f32, bf16, int8 entries at (T, d, d_a), and a ragged case
    mix_reason = ("the reference's dq_adapter_mix tolerances (tests/test_cached_step.py:55, "
                  ":84); f32 sums over d or T reorder")
    worst = {"mix_fwd": 0.0, "mix_dw": 0.0}
    for T, d, da in ((TRAIN_T, TRAIN_D, TRAIN_DA), (1000, 1000, 200)):
        b = torch.randn(T, d, generator=gen, device=dev)
        w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=dev)
        g = torch.randn(T, da, generator=gen, device=dev)
        lam = torch.tensor(0.7, device=dev)
        for storage, ent in (("f32", b), ("bf16", b.bfloat16()), ("int8", quantize(b, 8, 128))):
            out, bw = cached_mix.mix_fwd(ent, w, a, lam)
            want_out, want_bw = ref.mix_fwd_ref(ent, w, a, lam)
            dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
            e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
            e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
            check(f"mix_fwd {storage} T={T} d={d} da={da}", e_fwd, 1e-4)
            check(f"mix_dw {storage} T={T} d={d} da={da}", e_dw, 2e-4)
            err_f, err_d = max(max_err(out, want_out), max_err(bw, want_bw)), max_err(dw, want_dw)
            worst["mix_fwd"] = max(worst["mix_fwd"], err_f)
            worst["mix_dw"] = max(worst["mix_dw"], err_d)
            emit({"check": "cached_mix", "storage": storage, "T": T, "d": d, "da": da,
                  "mix_fwd_max_abs_err": err_f, "mix_dw_max_abs_err": err_d,
                  "mix_fwd_check": e_fwd, "mix_dw_check": e_dw,
                  "tol": "mix_fwd atol 1e-4 + rtol 1e-4; mix_dw atol 2e-4 + rtol 1e-3",
                  "tol_reason": mix_reason})
            if (T, d, da) == (TRAIN_T, TRAIN_D, TRAIN_DA):  # a second call, bit for bit
                out2, bw2 = cached_mix.mix_fwd(ent, w, a, lam)
                equal = bool(torch.equal(out, out2) and torch.equal(bw, bw2))
                emit({"check": "mix_fwd_deterministic", "storage": storage, "T": T, "d": d,
                      "da": da, "bit_equal": equal})
                if not equal:
                    raise AssertionError(f"mix_fwd {storage}: two calls differ")
                equal = bool(torch.equal(dw, cached_mix.mix_dw(ent, g, lam, d)))
                emit({"check": "mix_dw_deterministic", "storage": storage, "T": T, "d": d,
                      "da": da, "bit_equal": equal})
                if not equal:
                    raise AssertionError(f"mix_dw {storage}: two calls differ")
    # both kernels on every masked edge (T, d, d_a off the tiles, ld > d)
    # and, with qblock 32, on int8 entries whose scale changes inside a
    # tile; mix_fwd with f32 and bf16 a. T=37, d=130, d_a=17 adds rows whose
    # width is not a multiple of 8 (element-wise loads) and qblock 24, which
    # mix_fwd dequantizes as it stages (a k16 step would straddle blocks)
    for T, d, da, qblock in ((1001, 1000, 100, 32), (37, 130, 17, 24)):
        b = torch.randn(T, d, generator=gen, device=dev)
        w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=dev)
        g = torch.randn(T, da, generator=gen, device=dev)
        lam = torch.tensor(0.7, device=dev)
        for storage, ent in (("f32", b), ("bf16", b.bfloat16()), ("int8", quantize(b, 8, qblock))):
            for a_ in (a, a.bfloat16()):
                out, bw = cached_mix.mix_fwd(ent, w, a_, lam)
                want_out, want_bw = ref.mix_fwd_ref(ent, w, a_, lam)
                if out.dtype != a_.dtype or bw.dtype != torch.float32:
                    raise AssertionError(f"mix_fwd gave out {out.dtype}, bw {bw.dtype}")
                e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
                check(f"mix_fwd {storage} T={T} d={d} da={da} qblock={qblock} a={a_.dtype}", e_fwd,
                      1e-4)
                err_f = max(max_err(out, want_out), max_err(bw, want_bw))
                # a bf16 out's one-step rounding flips are not the kernel's error
                worst["mix_fwd"] = max(worst["mix_fwd"], err_f if out.dtype == torch.float32
                                       else max_err(bw, want_bw))
                emit({"check": "mix_fwd_ragged", "storage": storage, "T": T, "d": d, "da": da,
                      "qblock": qblock if storage == "int8" else None,
                      "ld": ent.q.shape[1] if storage == "int8" else d, "a": str(a_.dtype),
                      "mix_fwd_max_abs_err": err_f, "mix_fwd_check": e_fwd,
                      "tol": "out and bw atol 1e-4 + rtol 1e-4 (bf16 out: + 2^-7 relative, one "
                             "bf16 step)", "tol_reason": mix_reason})
            dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
            e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
            check(f"mix_dw {storage} T={T} d={d} da={da} qblock={qblock}", e_dw, 2e-4)
            worst["mix_dw"] = max(worst["mix_dw"], max_err(dw, want_dw))
            emit({"check": "mix_dw_ragged", "storage": storage, "T": T, "d": d, "da": da,
                  "qblock": qblock if storage == "int8" else None,
                  "mix_dw_max_abs_err": max_err(dw, want_dw), "mix_dw_check": e_dw,
                  "tol": "atol 2e-4 + rtol 1e-3", "tol_reason": mix_reason})
    # timings at the training path's storage (int8 taps), T = 2048, d = 2048, d_a = 256
    T, d, da = TRAIN_T, TRAIN_D, TRAIN_DA
    ents = [quantize(torch.randn(T, d, generator=gen, device=dev), 8, 128)
            for _ in range(copies(T * d))]
    w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
    a = torch.randn(T, da, generator=gen, device=dev)
    g = torch.randn(T, da, generator=gen, device=dev)
    lam = torch.tensor(0.7, device=dev)
    ent_bytes = T * d + T * (d // 128) * 4
    deq = [dequantize(e) for e in ents[:2]]
    # mix_fwd runs on the bf16 tensor cores, W_down split in three terms:
    # it is held to that work's bound, the f32 CUDA-core bound beside it
    fwd_bytes = ent_bytes + 4 * (d * da + 3 * T * da)
    b_ms, b_by = bound(fwd_bytes, 3 * 2.0 * T * d * da, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(fwd_bytes, 2.0 * T * d * da)
    r = {"check": "mix_fwd", "storage": "int8", "T": T, "d": d, "da": da,
         "max_abs_err": worst["mix_fwd"],
         "ms": timer([lambda e=e: cached_mix.mix_fwd(e, w, a, lam) for e in ents]),
         "plain_ms": timer([lambda e=e: ref.mix_fwd_ref(e, w, a, lam) for e in ents]),
         "library_ms": timer([lambda e=e: torch.matmul(dequantize(e), w) for e in ents]),
         "library": "dequantize, then torch.matmul", "bound_ms": b_ms, "bound_by": b_by,
         "bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
         "bound_f32_by": f32_by}
    emit(r)
    rows["mix_fwd"] = _row(r, "one period's mix, T=4*512, d=2048, d_a=256, int8 entry")
    # mix_dw runs on the bf16 tensor cores, g (scaled) split in three terms:
    # it is held to that work's bound, the f32 CUDA-core bound beside it
    dw_bytes = ent_bytes + 4 * (T * da + d * da)
    b_ms, b_by = bound(dw_bytes, 3 * 2.0 * T * d * da, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(dw_bytes, 2.0 * T * d * da)
    r = {"check": "mix_dw", "storage": "int8", "T": T, "d": d, "da": da,
         "max_abs_err": worst["mix_dw"],
         "ms": timer([lambda e=e: cached_mix.mix_dw(e, g, lam, d) for e in ents]),
         "plain_ms": timer([lambda e=e: ref.mix_dw_ref(e, g, lam, d) for e in ents]),
         "library_ms": timer([lambda x=x: torch.matmul(x.T, g) for x in deq]),
         "library": "torch.matmul of the dequantized entry's transpose and g",
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    emit(r)
    rows["mix_dw"] = _row(r, "one period's dW_down, T=4*512, d=2048, d_a=256, int8 entry")
    # gradients through MixFn against autograd of the plain version
    ent = ents[0]
    grads = {}
    for impl in ("cuda", "plain"):
        wr, ar, lr_ = (t.clone().requires_grad_() for t in (w, a, torch.tensor(0.3, device=dev)))
        if impl == "cuda":
            out = dq_adapter_mix(ent, wr, ar, lr_)
        else:
            out = ref.dq_adapter_mix_ref(ent, wr, ar, lr_, d)
        grads[impl] = torch.autograd.grad(torch.sin(out).sum(), (wr, ar, lr_))
    errs = [float(((x - y).abs() - 1e-3 * y.abs()).max()) for x, y in zip(*grads.values())]
    emit({"check": "MixFn_grad", "T": T, "d": d, "da": da, "storage": "int8",
          "max_abs_err": [max_err(x, y) for x, y in zip(*grads.values())],
          "grads": ["W_down", "a", "lambda"], "tol": "atol 2e-4 + rtol 1e-3",
          "tol_reason": "the reference's custom-VJP gradient tolerance (tests/test_cached_step.py:84)"})
    check("MixFn gradients", max(errs), 2e-4)
    del ents, deq, grads

    # ---- ce_fwd / ce_bwd at (T, d, V), with and without the soft-cap
    T, d, V = TRAIN_T, TRAIN_D, TRAIN_V
    h = torch.randn(T, d, generator=gen, device=dev)
    w = torch.randn(d, V, generator=gen, device=dev) * d ** -0.5
    lab = torch.randint(0, V, (T,), generator=gen, device=dev)
    g = torch.randn(T, generator=gen, device=dev)
    ce_errs = {"ce_fwd": 0.0, "ce_bwd": 0.0}
    ce_reason = ("the reference's blockwise-CE tolerances (tests/test_cached_step.py:105, "
                 ":113); f32 sums reorder")

    def ce_fwd_check(nll, lse, want_nll, want_lse) -> float:
        return max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                   float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))

    for cap in (None, 30.0):
        nll, lse = lmhead_ce.ce_fwd(h, w, lab, cap)
        want_nll, want_lse = ref.ce_fwd_ref(h, w, lab, cap)
        dh = lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)
        want_dh = ref.ce_bwd_ref(h, w, lab, want_lse, g, cap)
        e_f = ce_fwd_check(nll, lse, want_nll, want_lse)
        e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
        check(f"ce_fwd cap={cap}", e_f, 2e-5)
        check(f"ce_bwd cap={cap}", e_b, 1e-5)
        errs = {"ce_fwd": max(max_err(nll, want_nll), max_err(lse, want_lse)),
                "ce_bwd": max_err(dh, want_dh)}
        for k in ce_errs:
            ce_errs[k] = max(ce_errs[k], errs[k])
        emit({"check": "lmhead_ce", "T": T, "d": d, "V": V, "softcap": cap,
              "ce_fwd_max_abs_err": errs["ce_fwd"], "ce_bwd_max_abs_err": errs["ce_bwd"],
              "ce_fwd_check": e_f, "ce_bwd_check": e_b,
              "tol": "ce_fwd atol 2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4",
              "tol_reason": ce_reason})
        equal = bool(torch.equal(dh, lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)))
        emit({"check": "ce_bwd_deterministic", "T": T, "d": d, "V": V, "softcap": cap,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"ce_bwd cap={cap}: two calls differ")
        del dh, want_dh
        nll2, lse2 = lmhead_ce.ce_fwd(h, w, lab, cap)  # a second call, bit for bit
        equal = bool(torch.equal(nll, nll2) and torch.equal(lse, lse2))
        emit({"check": "ce_fwd_deterministic", "T": T, "d": d, "V": V, "softcap": cap,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"ce_fwd cap={cap}: two calls differ")
    # every masked edge: T, d and V off the tiles (V ends inside a vocab
    # tile and a W chunk), d not a multiple of 4 (element-wise split loads)
    for Tr, dr, Vr in ((1001, 1000, 3001), (37, 130, 517)):
        h2 = torch.randn(Tr, dr, generator=gen, device=dev)
        w2 = torch.randn(dr, Vr, generator=gen, device=dev) * dr ** -0.5
        lab2 = torch.randint(0, Vr, (Tr,), generator=gen, device=dev)
        g2 = torch.randn(Tr, generator=gen, device=dev)
        for cap in (None, 30.0):
            nll, lse = lmhead_ce.ce_fwd(h2, w2, lab2, cap)
            want_nll, want_lse = ref.ce_fwd_ref(h2, w2, lab2, cap)
            e_f = ce_fwd_check(nll, lse, want_nll, want_lse)
            check(f"ce_fwd T={Tr} d={dr} V={Vr} cap={cap}", e_f, 2e-5)
            err = max(max_err(nll, want_nll), max_err(lse, want_lse))
            ce_errs["ce_fwd"] = max(ce_errs["ce_fwd"], err)
            emit({"check": "ce_fwd_ragged", "T": Tr, "d": dr, "V": Vr, "softcap": cap,
                  "ce_fwd_max_abs_err": err, "ce_fwd_check": e_f,
                  "tol": "atol 2e-5 + rtol 1e-5", "tol_reason": ce_reason})
            dh = lmhead_ce.ce_bwd(h2, w2, lab2, want_lse, g2, cap)
            want_dh = ref.ce_bwd_ref(h2, w2, lab2, want_lse, g2, cap)
            e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
            check(f"ce_bwd T={Tr} d={dr} V={Vr} cap={cap}", e_b, 1e-5)
            err = max_err(dh, want_dh)
            ce_errs["ce_bwd"] = max(ce_errs["ce_bwd"], err)
            emit({"check": "ce_bwd_ragged", "T": Tr, "d": dr, "V": Vr, "softcap": cap,
                  "ce_bwd_max_abs_err": err, "ce_bwd_check": e_b,
                  "tol": "atol 1e-5 + rtol 1e-4", "tol_reason": ce_reason})
    nll, lse = ref.ce_fwd_ref(h, w, lab)
    # ce_fwd runs on the bf16 tensor cores, h and W split in three terms (6
    # products): it is held to that work's bound, the f32 CUDA-core bound beside it
    fwd_bytes = 4.0 * (T * d + d * V + 3 * T)
    b_ms, b_by = bound(fwd_bytes, 6 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(fwd_bytes, 2.0 * T * d * V)
    r = {"check": "ce_fwd", "T": T, "d": d, "V": V, "max_abs_err": ce_errs["ce_fwd"],
         "ms": timer(lambda: lmhead_ce.ce_fwd(h, w, lab), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_fwd_ref(h, w, lab), calls=2, repeats=3),
         "library_ms": timer(lambda: torch.logsumexp(torch.matmul(h, w), dim=-1), calls=2,
                             repeats=3),
         "library": "torch.matmul, then torch.logsumexp", "bound_ms": b_ms, "bound_by": b_by,
         "bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
         "bound_f32_by": f32_by}
    emit(r)
    rows["ce_fwd"] = _row(r, "LM-head CE forward, T=4*512, d=2048, V=92544")
    hr = h.clone().requires_grad_()

    def library_bwd():
        loss = torch.nn.functional.cross_entropy(torch.matmul(hr, w), lab.long(),
                                                 reduction="sum")
        return torch.autograd.grad(loss, hr)

    # ce_bwd runs two GEMMs of the forward's size on the bf16 tensor cores
    # (the logits again, then dh), each 6 products of the 3-term split
    bwd_bytes = 4.0 * (2 * T * d + d * V + 4 * T)
    b_ms, b_by = bound(bwd_bytes, 12 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(bwd_bytes, 4.0 * T * d * V)
    r = {"check": "ce_bwd", "T": T, "d": d, "V": V, "max_abs_err": ce_errs["ce_bwd"],
         "ms": timer(lambda: lmhead_ce.ce_bwd(h, w, lab, lse, g), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_bwd_ref(h, w, lab, lse, g), calls=2, repeats=3),
         "library_ms": timer(library_bwd, calls=2, repeats=3),
         "library": "autograd of F.cross_entropy(h @ W) (its forward included)",
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    # the backward alone, on an autograd graph built once (no logits
    # recompute): a yardstick beside the library column, not in it.
    # Autograd runs it on the stream its forward ran on, not a CUDA
    # graph's capture stream, so it is timed without a graph
    loss = torch.nn.functional.cross_entropy(torch.matmul(hr, w), lab.long(), reduction="sum")
    r["library_bwd_only_ms"] = timer.eager(
        lambda: torch.autograd.grad(loss, hr, retain_graph=True), calls=2, repeats=3)
    r["library_bwd_only"] = ("torch.autograd.grad of F.cross_entropy(h @ W) on a graph built "
                             "once (retain_graph): the backward without a logits recompute")
    del loss
    emit(r)
    rows["ce_bwd"] = _row(r, "LM-head CE backward (logits recomputed), T=4*512, d=2048, V=92544")
    # gradients through CEFn against autograd of the plain version
    grads = []
    for fn in (lambda x: lmhead_ce_op(x, w, lab), lambda x: ref.lmhead_ce_ref(x, w, lab)):
        x = h.clone().requires_grad_()
        grads.append(torch.autograd.grad(torch.cos(fn(x)).sum(), x)[0])
    emit({"check": "CEFn_grad", "T": T, "d": d, "V": V, "max_abs_err": max_err(*grads),
          "tol": "atol 1e-5 + rtol 1e-4",
          "tol_reason": "the reference's dh tolerance (tests/test_cached_step.py:113)"})
    check("CEFn gradient", float(((grads[0] - grads[1]).abs() - 1e-4 * grads[1].abs()).max()),
          1e-5)
    return rows


# ---------------------------------------------------------------- training


def kernel_counters():
    """(module, key) of every kernel's launch count; key None where the
    module counts one kernel in a plain integer."""
    from repro_torch.kernels import (adapter_fuse, cached_mix, flash_attention, lmhead_ce,
                                     paged_attention, quant_matmul)

    return [(quant_matmul, None), (flash_attention, None), (paged_attention, None),
            (cached_mix, "mix_fwd"), (cached_mix, "mix_dw"), (lmhead_ce, "ce_fwd"),
            (lmhead_ce, "ce_bwd"), (adapter_fuse, None)]


def reset_launches() -> None:
    for mod, key in kernel_counters():
        if key is None:
            mod.launches = 0
        else:
            mod.launches[key] = 0


def read_launches() -> dict:
    return {key or mod.__name__.rsplit(".", 1)[1]: (mod.launches if key is None
                                                    else mod.launches[key])
            for mod, key in kernel_counters()}


def training_phase(workdir: Path):
    """PAC+ at full width through the port's EdgeSession/EpochRunner,
    with its checkpoint and persistent cache in ``workdir``. Returns
    (launches, the session's backbone, the checkpoint's path, the run's
    per-step and per-epoch losses and epoch 0's cache entries)."""
    from repro_torch.core.quantization import tree_leaves, tree_map
    from repro_torch.kernels.cached_step import cached_loss_parts
    from repro_torch.runtime import (ConsoleHook, EdgeSession, EpochReport, EpochRunner,
                                     RunHooks, RunSpec)

    ckpt = workdir / "adapter.msgpack"
    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED,
                   ckpt=str(ckpt), cache_dir=str(workdir / "act_cache"))
    training_kernels = ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                        "ce_bwd")

    def read():
        return {k: v for k, v in read_launches().items() if k in training_kernels}

    per_step = []

    class StepLaunches(RunHooks):
        """Each step's launches (counts read after the step's loss is on the host)."""

        def on_step(self, session, event):
            now = read()
            before = per_step[-1][1] if per_step else dict.fromkeys(now, 0)
            per_step.append(({k: now[k] - before[k] for k in now}, now))

    def run(s, hooks=()):
        events = list(EpochRunner(s, hooks=[ConsoleHook(), *hooks]).events())
        return ([e for e in events if not isinstance(e, EpochReport)],
                [e for e in events if isinstance(e, EpochReport)])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = EdgeSession(spec, log=print).open()
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    reset_launches()
    steps_, reports = run(s, [StepLaunches()])
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    # what the distributed phase holds its run against: the per-step
    # losses and epoch 0's cache entries (int8 codes and scales, host)
    single = {"step_losses": [e.loss for e in steps_],
              "epoch_losses": [r.mean_loss for r in reports],
              "codes": {int(k): s.cache.get(int(k), with_final=True, dtype=None, compressed=True)
                        for ids in s.pipe.epoch_order(0) for k in ids}}
    s.finish()
    full = [e.wall_s for e in steps_ if not e.cache_hit]
    cached = [e.wall_s for e in steps_ if e.cache_hit]
    emit({"phase": "training", "arch": s.cfg.name, "layers": s.cfg.n_layers,
          "d_model": s.cfg.d_model, "vocab": s.cfg.vocab, "batch": spec.batch, "seq": spec.seq,
          "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
          "modes": [r.mode for r in reports], "epoch_losses": [r.mean_loss for r in reports],
          "step_losses": [e.loss for e in steps_], "open_s": open_s,
          "full_step_s": full, "cached_step_s": cached,
          "max_memory_allocated": peak, "cache_bytes": s.cache.nbytes,
          "cache_seqs": len(s.cache), "launches": launches,
          "launches_per_step": [d for d, _ in per_step]})
    if [r.mode for r in reports] != ["full", "cached", "cached"]:
        raise AssertionError(f"modes {[r.mode for r in reports]}")
    if not all(np.isfinite(r.mean_loss) for r in reports) or not (
            reports[-1].mean_loss < reports[0].mean_loss):
        raise AssertionError(f"epoch losses do not fall: {[r.mean_loss for r in reports]}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    persistence_phase(s, spec, steps_, run)

    # one cached batch through the cached step's loss, cuda against ref
    ids = s.pipe.epoch_order(0)[0]
    labels = torch.from_numpy(s.corpus.batch(ids)["labels"]).cuda()
    hit = s.cache.get_batch(ids, with_final=True, dtype=None, compressed=True)
    cached_b = {k: v.to("cuda") for k, v in zip(("b0", "taps", "b_final"), hit)}
    cached_b["labels"] = labels
    pos = torch.arange(spec.seq, device="cuda").expand(spec.batch, spec.seq)
    res = {}
    for impl in ("cuda", "ref"):
        ap = tree_map(lambda t: t.clone().requires_grad_(), s.adapter)
        num, den = cached_loss_parts(s.backbone, ap, s.cfg, cached_b, pos, spec.r, impl=impl)
        loss = num / den.clamp_min(1)
        res[impl] = (float(loss.detach()), torch.autograd.grad(loss, tree_leaves(ap)))
    gmax = max(float(g.abs().max()) for g in res["ref"][1])
    gerr = max(max_err(a, b) for a, b in zip(res["cuda"][1], res["ref"][1]))
    dloss = abs(res["cuda"][0] - res["ref"][0])
    loss_tol, grad_tol = 2e-5, 1e-4 * max(1.0, gmax)
    emit({"phase": "cached_step_cuda_vs_ref", "loss": [res["cuda"][0], res["ref"][0]],
          "abs_dloss": dloss, "max_abs_dgrad": gerr, "grad_max": gmax,
          "tol": {"loss": loss_tol, "grads": grad_tol},
          "tol_reason": "the reference's pallas-vs-ref cached-step tolerances "
                        "(tests/test_cached_step.py:163-190): f32 sums reorder"})
    if not (dloss <= loss_tol and gerr <= grad_tol):
        raise AssertionError(f"cached step cuda vs ref: dloss {dloss}, dgrad {gerr}")
    cuda_losses = [r.mean_loss for r in reports]

    # where the time goes: one full step (the cache emptied first) and one
    # cached step of the same batch under the profiler
    batch = s.corpus.batch(ids)
    s.cache.clear()
    for mode in ("full", "cached"):
        events = []
        prof = device_profile(lambda: events.append(s.step(dict(batch))),
                              watch=("mix_dw_mma", "dw_reduce", "mix_fwd_mma",
                                     "mix_fwd_reduce", "ce_split", "ce_fwd_mma", "ce_merge",
                                     "ce_grad_mma", "ce_dh_mma", "flash_split",
                                     "flash_fwd_mma"))
        if events[0].mode != mode:
            raise AssertionError(f"profiled a {events[0].mode} step, wanted {mode}")
        emit({"phase": "train_profile", "step": mode, **prof})
    backbone = s.backbone
    s.close()
    del s, res, cached_b, hit

    # the same trainer under the ref kernels, in memory: per-epoch losses
    s = EdgeSession(spec.replace(kernels="ref", ckpt=None, cache_dir=None), log=print).open()
    ref_steps, ref_reports = run(s)
    s.close()
    del s
    ref_losses = [r.mean_loss for r in ref_reports]
    tol = 5e-2
    diffs = [abs(a - b) for a, b in zip(cuda_losses, ref_losses)]
    emit({"phase": "trainer_cuda_vs_ref", "cuda_epoch_losses": cuda_losses,
          "ref_epoch_losses": ref_losses, "ref_modes": [r.mode for r in ref_reports],
          "ref_full_step_s": [e.wall_s for e in ref_steps if not e.cache_hit],
          "ref_cached_step_s": [e.wall_s for e in ref_steps if e.cache_hit],
          "abs_diff": diffs, "tol": tol,
          "tol_reason": "the reference's int8 pallas-vs-ref trainer tolerance "
                        "(tests/test_cached_step.py:257): under cuda epoch 0 trains on taps "
                        "quantized at the tap site, under ref on f32 taps"})
    if max(diffs) > tol:
        raise AssertionError(f"trainer cuda vs ref epoch losses differ by {diffs}")
    return launches, backbone, ckpt, single


def persistence_phase(s, spec, steps_, run) -> None:
    """The training run's durable outputs: its checkpoint loads back bit
    for bit; a second run over its cache directory (1 epoch x 2 steps)
    is warm — every step cached, no frozen-forward kernel launched — and
    gives the first run's epoch-0 losses; another seed invalidates the
    directory and re-captures it."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.activation_cache import MANIFEST_NAME
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.runtime import EdgeSession

    t0 = time.perf_counter()
    loaded = load_checkpoint(spec.ckpt, device=DEV)
    load_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(loaded["adapter"]), tree_leaves(s.adapter)))
    bit_equal = (loaded["config"] == s.cfg.name and len(pairs) == len(tree_leaves(s.adapter))
                 and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs))
    del loaded, pairs
    manifest = Path(spec.cache_dir) / MANIFEST_NAME

    def rerun(run_spec):
        reset_launches()
        t = time.perf_counter()
        session = EdgeSession(run_spec, log=print).open()
        open_s = time.perf_counter() - t
        events, reports = run(session)
        session.finish()
        session.close()
        return session, events, reports, open_s, read_launches()

    warm_s, warm_steps, warm_reports, warm_open_s, warm_launches = rerun(
        spec.replace(epochs=1, ckpt=None))
    cold = [e.loss for e in steps_ if e.epoch == 0]
    warm = [e.loss for e in warm_steps]
    reseed = spec.replace(epochs=1, seed=SEED + 1, ckpt=None)
    seeded_s, seeded_steps, _, _, seeded_launches = rerun(reseed)
    recaptured = json.loads(manifest.read_text())["meta"] == seeded_s.meta
    loss_tol = 2e-5
    emit({"phase": "persistence", "ckpt": Path(spec.ckpt).name,
          "ckpt_bytes": Path(spec.ckpt).stat().st_size, "ckpt_load_s": load_s,
          "ckpt_bit_equal": bit_equal, "warm": warm_s.warm, "warm_open_s": warm_open_s,
          "warm_modes": [r.mode for r in warm_reports],
          "warm_steps_cached": [e.cache_hit for e in warm_steps],
          "warm_step_s": [e.wall_s for e in warm_steps], "warm_launches": warm_launches,
          "warm_losses": warm, "cold_epoch0_losses": cold, "loss_tol": loss_tol,
          "loss_tol_reason": "the reference's cached-step loss tolerance "
                             "(tests/test_cached_step.py:163): the same int8 taps, from the "
                             "tap site in the first run and from the cache in the second",
          "reseeded_warm": seeded_s.warm, "reseeded_modes": [e.mode for e in seeded_steps],
          "reseeded_launches": seeded_launches, "reseeded_manifest_recaptured": recaptured})
    if not bit_equal:
        raise AssertionError("the checkpoint does not load back bit-equal to the adapter")
    if not (warm_s.warm and all(e.cache_hit for e in warm_steps)
            and [r.mode for r in warm_reports] == ["cached"]):
        raise AssertionError("the rerun over the cache directory was not warm")
    if warm_launches["quant_matmul"] or warm_launches["flash_attention"]:
        raise AssertionError(f"the warm rerun ran the frozen forward: {warm_launches}")
    if max(abs(a - b) for a, b in zip(warm, cold)) > loss_tol:
        raise AssertionError(f"warm losses {warm} differ from the first run's {cold}")
    if seeded_s.warm or any(e.cache_hit for e in seeded_steps) or not recaptured \
            or seeded_launches["quant_matmul"] <= 0:
        raise AssertionError("a new seed did not invalidate and re-capture the cache")


# ---------------------------------------------------------------- prefetch

PREFETCH_WORKER = "activation-cache-prefetch"  # CachePrefetcher's thread


def prefetch_phase(workdir: Path) -> dict:
    """The cached epoch's input path at full width: 8 steps of 4 x 512
    tokens, int8 cache, ``cuda`` kernels. Epoch 0 fills the cache (its
    second step profiled: the taps' device→host copy must land in pinned
    memory); then, from one snapshot, the cached epoch runs four times in
    turns: through ``EpochRunner`` (the prefetcher), through ``step``
    with no epoch scope (read and copied on the caller's thread), and
    both again with their third step profiled. Gates: bit-equal per-step
    losses; the prefetched batch's host→device copies from pinned memory
    on a stream no kernel runs on; no worker thread left. Returns the
    path's launches (epoch 0 and the first prefetched epoch)."""
    import threading

    from repro_torch.core.quantization import tree_map
    from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=2, steps_per_epoch=8, batch=4, seq=512, seed=SEED)
    s = EdgeSession(spec, log=print).open()
    runner = EpochRunner(s)
    # a batch's int8 payloads and f32 scales (one per 128 columns): b0 and
    # b_final (B, S, d), taps (n_p, B, S, d); their copies, by size
    rows = spec.batch * spec.seq * s.cfg.d_model
    batch_bytes = {n * rows * size // block for n in (1, s.cfg.n_periods)
                   for size, block in ((1, 1), (4, 128))}

    def workers():
        return [t.name for t in threading.enumerate() if t.name == PREFETCH_WORKER and t.is_alive()]

    def steps_of(epoch, profile_at=None, prefetched=True):
        """One epoch's StepEvents, through EpochRunner or step(); the
        ``profile_at``-th step under the profiler (its trace kept)."""
        events, prof, on_pf = [], None, []
        if prefetched:
            it = runner.run_epoch(epoch)
        else:
            it = (s.step(b, epoch=epoch, index=i) for i, b in enumerate(s.pipe.epoch(epoch)))
        torch.cuda.reset_peak_memory_stats()
        for i in range(spec.steps_per_epoch):
            if i == profile_at:
                prof = device_profile(lambda: events.append(next(it)),
                                      trace=workdir / f"prefetch_{epoch}_{prefetched}.json")
            else:
                events.append(next(it))
            on_pf.append(s._prefetch is not None)
        rest = list(it)  # the report: the epoch scope closes here
        if prefetched and not (len(rest) == 1 and isinstance(rest[0], EpochReport)):
            raise AssertionError(f"the epoch did not end with its report: {rest}")
        return events, prof, on_pf, torch.cuda.max_memory_allocated()

    reset_launches()
    t0 = time.perf_counter()
    fill, fill_prof, _, fill_peak = steps_of(0, profile_at=1)
    fill_s = time.perf_counter() - t0
    snap = {k: tree_map(lambda t: t.clone(), v) if k in ("adapter", "opt") else v
            for k, v in s.snapshot().items()}
    cached, _, on_pf, pf_peak = steps_of(1)
    launches = read_launches()
    after_epoch = workers()
    runs = {"prefetched": (cached, None, on_pf, pf_peak)}
    for name, prefetched in (("sync", False), ("prefetched_profiled", True),
                             ("sync_profiled", False)):
        s.restore(snap)
        runs[name] = steps_of(1, profile_at=2 if "profiled" in name else None,
                              prefetched=prefetched)
    s.restore(snap)
    left = workers()
    cache_bytes, cache_seqs = s.cache.nbytes, len(s.cache)
    s.close()
    del s, snap, runner

    losses = {k: [e.loss for e in v[0]] for k, v in runs.items()}
    walls = {k: [e.wall_s for e in v[0]] for k, v in runs.items()}
    pf_prof, sync_prof = runs["prefetched_profiled"][1], runs["sync_profiled"][1]

    def batch_copies(prof, kind):
        return [c for c in prof["copies"] if kind in c["kind"] and c["bytes"] in batch_bytes]

    h2d = batch_copies(pf_prof, "HtoD")
    taps_d2h = batch_copies(fill_prof, "DtoH")
    line = {"phase": "prefetch", "arch": "internlm2-1.8b", "steps_per_epoch": spec.steps_per_epoch,
            "batch": spec.batch, "seq": spec.seq, "cache": spec.cache_compress,
            "cache_bytes": cache_bytes, "cache_seqs": cache_seqs, "fill_epoch_s": fill_s,
            "modes": [[e.mode for e in fill], [e.mode for e in cached]],
            "steps_on_prefetcher": {k: v[2] for k, v in runs.items()},
            "losses": losses, "step_s": walls,
            "median_step_s": {k: statistics.median(v) for k, v in walls.items()},
            "max_memory_allocated": {"fill": fill_peak, **{k: v[3] for k, v in runs.items()}},
            "busy_share": {"prefetched": pf_prof["device_busy_share"],
                           "sync": sync_prof["device_busy_share"]},
            "profiled_wall_ms": {"prefetched": pf_prof["wall_ms"], "sync": sync_prof["wall_ms"]},
            "device_busy_ms": {"prefetched": pf_prof["device_busy_ms"],
                               "sync": sync_prof["device_busy_ms"]},
            "prefetched_h2d": h2d, "sync_h2d": batch_copies(sync_prof, "HtoD"),
            "kernel_streams": {"prefetched": pf_prof["kernel_streams"],
                               "sync": sync_prof["kernel_streams"]},
            "fill_d2h": taps_d2h, "fill_profile_wall_ms": fill_prof["wall_ms"],
            "fill_busy_share": fill_prof["device_busy_share"],
            "kernels_by_device_ms": {"fill": fill_prof["kernels_by_device_ms"],
                                     "prefetched": pf_prof["kernels_by_device_ms"],
                                     "sync": sync_prof["kernels_by_device_ms"]},
            "workers_alive_after_epoch": after_epoch, "workers_alive_at_end": left,
            "launches": launches}
    emit(line)
    if [e.mode for e in fill] != ["full"] * 8 or any(e.mode != "cached" for v in runs.values()
                                                      for e in v[0]):
        raise AssertionError(f"modes {line['modes']}")
    if line["steps_on_prefetcher"] != {"prefetched": [True] * 8, "sync": [False] * 8,
                                       "prefetched_profiled": [True] * 8,
                                       "sync_profiled": [False] * 8}:
        raise AssertionError(f"steps on the prefetcher: {line['steps_on_prefetcher']}")
    if len({tuple(v) for v in losses.values()}) != 1 or not all(
            np.isfinite(x) for x in losses["sync"]):
        raise AssertionError(f"prefetched and synchronous losses differ: {losses}")
    if not h2d or any(c["kind"] != "Memcpy HtoD (Pinned -> Device)"
                      or c["stream"] in pf_prof["kernel_streams"] for c in h2d):
        raise AssertionError(f"the prefetched batch's copies: {h2d}, kernels on "
                             f"{pf_prof['kernel_streams']}")
    if not taps_d2h or any(c["kind"] != "Memcpy DtoH (Device -> Pinned)" for c in taps_d2h):
        raise AssertionError(f"epoch 1's tap copies: {taps_d2h}")
    if after_epoch or left:
        raise AssertionError(f"prefetch workers still alive: {after_epoch}, {left}")
    missing = [n for n in ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                           "ce_bwd") if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the prefetch path: {missing}")
    return launches


# ---------------------------------------------------------------- distributed training

DIST_DP, DIST_STAGES = 2, 2
DIST_ROWS = 1  # a rank's rows: batch 4 over 2 micro-batches x dp 2, and over the pool of 4
DIST_STEP_TOL = 1e-5  # per-step |Δloss| against the single process
TRAINING_KERNELS = ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd", "ce_bwd")


def fingerprint(tree) -> list:
    """Two int64 sums a leaf over its 16-bit words (plain, and weighted
    by position mod 1021): equal bits give equal sums; the card computes
    them, so comparing ranks costs no copy of the state."""
    from repro_torch.core.quantization import tree_leaves

    out = []
    for t in tree_leaves(tree):
        w = t.detach().reshape(-1).contiguous().view(torch.int16).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 1021 + 1
        out += [int(w.sum()), int((w * pos).sum())]
    return out


def distributed_rank(spec, runs: int, layout: str = None) -> dict:
    """One rank of the distributed and plan phases: ``runs`` runs of
    ``spec`` through ``EdgeSession``/``EpochRunner`` (``layout``: the
    layout the parent resolved, as JSON), each step's loss, wall time,
    launches, mesh transfer counters and adapter/optimizer fingerprint;
    on the owner also epoch 0's cache entries (first run)."""
    import torch.distributed as dist

    from repro_torch.runtime import EdgeSession, EpochRunner, RunHooks

    rank = dist.get_rank()
    out = {"rank": rank, "runs": []}
    for run in range(runs):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = EdgeSession(spec, log=print if rank == 0 and run == 0 else None,
                        layout=layout).open()
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        steps = []

        class Record(RunHooks):
            def on_step(self, session, event):
                now = {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS}
                stats = dict(session.mesh.stats)
                prev = steps[-1] if steps else {"_launches": dict.fromkeys(now, 0),
                                                "_stats": dict.fromkeys(stats, 0)}
                steps.append({"loss": event.loss, "wall_s": event.wall_s, "mode": event.mode,
                              "launches": {k: now[k] - prev["_launches"][k] for k in now},
                              **{k: stats[k] - prev["_stats"][k] for k in stats},
                              "fingerprint": fingerprint((session.adapter, session.opt)),
                              "_launches": now, "_stats": stats})

        reset_launches()
        reports = EpochRunner(s, hooks=[Record()]).run()
        rec = {"open_s": open_s, "modes": [r.mode for r in reports],
               "periods": s.backbone["periods"],
               "epoch_losses": [r.mean_loss for r in reports],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS},
               "steps": [{k: v for k, v in st.items() if not k.startswith("_")}
                         for st in steps]}
        if rank == 0 and run == 0:
            rec["codes"] = {int(k): s.cache.get(int(k), with_final=True, dtype=None,
                                                compressed=True)
                            for ids in s.pipe.epoch_order(0) for k in ids}
        s.close()
        del s
        out["runs"].append(rec)
    return out


def code_moves(got, want) -> dict:
    """Two int8 cache entries' codes: max |Δq|, the share that moved, and
    the largest relative scale difference."""
    dq = (got.q.int() - want.q.int()).abs()
    ds = (got.scale - want.scale).abs().max() / want.scale.abs().max().clamp_min(1e-30)
    return {"max_dq": int(dq.max()), "moved": int((dq > 0).sum()), "codes": dq.numel(),
            "max_rel_dscale": float(ds)}


def distributed_kernel_phase(timer: Timer, gen: torch.Generator) -> None:
    """The six kernels of the distributed path against their plain
    versions at the shapes one rank gives them (dp=2, stages=2, batch 4
    x 512, 2 micro-batches): ``quant_matmul`` at M = 512 (a stage's
    micro-batch, one row a dp rank) over the layer's (K, N), int8;
    ``flash_attention`` at B·H = 1·16, S = 512; ``mix_fwd``/``mix_dw`` on
    int8 entries and ``ce_fwd``/``ce_bwd`` at T = 1024 (the epoch-1 loss,
    a dp row's two rows) and T = 512 (the cached step, one row a rank),
    d = 2048, d_a = 256, V = 92544; each at the tolerance of its check
    at the training shapes."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref

    M = DIST_ROWS * 512
    for K, N in QMM_SHAPES:
        _, _, got, want = qmm_check(gen, M, K, N, 8)
        emit({"check": "quant_matmul_distributed", "M": M, "K": K, "N": N, "bits": 8,
              "max_abs_err": max_err(got, want),
              "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
              "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    r = flash_case(timer, gen, DIST_ROWS, 16, 8, 512, 128, "distributed stage")[0]
    emit(r)
    d, da, V = TRAIN_D, TRAIN_DA, TRAIN_V
    for T in (2 * DIST_ROWS * 512, DIST_ROWS * 512):
        ent = quantize(torch.randn(T, d, generator=gen, device=DEV), 8, 128)
        w = torch.randn(d, da, generator=gen, device=DEV) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=DEV)
        g = torch.randn(T, da, generator=gen, device=DEV)
        lam = torch.tensor(0.7, device=DEV)
        out, bw = cached_mix.mix_fwd(ent, w, a, lam)
        want_out, want_bw = ref.mix_fwd_ref(ent, w, a, lam)
        dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
        e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
        e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
        check(f"mix_fwd int8 T={T} (distributed)", e_fwd, 1e-4)
        check(f"mix_dw int8 T={T} (distributed)", e_dw, 2e-4)
        del ent, w, a, g, out, bw, want_out, want_bw, dw, want_dw
        h = torch.randn(T, d, generator=gen, device=DEV)
        wh = torch.randn(d, V, generator=gen, device=DEV) * d ** -0.5
        lab = torch.randint(0, V, (T,), generator=gen, device=DEV)
        gl = torch.randn(T, generator=gen, device=DEV)
        nll, lse = lmhead_ce.ce_fwd(h, wh, lab)
        want_nll, want_lse = ref.ce_fwd_ref(h, wh, lab)
        dh, want_dh = (lmhead_ce.ce_bwd(h, wh, lab, want_lse, gl),
                       ref.ce_bwd_ref(h, wh, lab, want_lse, gl))
        e_f = max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                  float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))
        e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
        check(f"ce_fwd T={T} (distributed)", e_f, 2e-5)
        check(f"ce_bwd T={T} (distributed)", e_b, 1e-5)
        emit({"check": "training_kernels_distributed", "T": T, "d": d, "da": da, "V": V,
              "storage": "int8", "mix_fwd_check": e_fwd, "mix_dw_check": e_dw,
              "ce_fwd_max_abs_err": max(max_err(nll, want_nll), max_err(lse, want_lse)),
              "ce_bwd_max_abs_err": max_err(dh, want_dh), "ce_fwd_check": e_f,
              "ce_bwd_check": e_b,
              "tol": "mix_fwd atol 1e-4 + rtol 1e-4; mix_dw atol 2e-4 + rtol 1e-3; ce_fwd "
                     "atol 2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4",
              "tol_reason": "the tolerances of the checks at the training shapes"})
        del h, wh, lab, gl, nll, lse, want_nll, want_lse, dh, want_dh


def parity(ranks: list, single: dict) -> dict:
    """The first run of a distributed run (``distributed_rank``'s records,
    rank 0 holding epoch 0's cache entries) against the single-process
    training run: per-step losses, their distance to the single
    process's, ranks' losses and fingerprints equal after every step, and
    epoch 0's cache codes (b0 bit-equal, taps and b_final moved codes)."""
    first = [r["runs"][0] for r in ranks]
    losses = [st["loss"] for st in first[0]["steps"]]
    codes = first[0].pop("codes")
    moves = {"b0": [], "taps": [], "b_final": []}
    for k, want in single["codes"].items():
        for name, g, w in zip(("b0", "taps", "b_final"), codes[k], want):
            moves[name].append(code_moves(g, w))
    b0_equal = all(torch.equal(g[0].q, w[0].q) and torch.equal(g[0].scale, w[0].scale)
                   for g, w in ((codes[k], single["codes"][k]) for k in single["codes"]))
    summary = {name: {"max_dq": max(m["max_dq"] for m in ms),
                      "moved_share": sum(m["moved"] for m in ms) / sum(m["codes"] for m in ms),
                      "max_rel_dscale": max(m["max_rel_dscale"] for m in ms)}
               for name, ms in moves.items()}
    return {"modes": first[0]["modes"], "step_losses": losses,
            "single_step_losses": single["step_losses"],
            "epoch_losses": first[0]["epoch_losses"],
            "single_epoch_losses": single["epoch_losses"],
            "abs_dloss_first_step": abs(losses[0] - single["step_losses"][0]),
            "abs_dloss_steps": [abs(a - b) for a, b in zip(losses, single["step_losses"])],
            "abs_depoch": [abs(a - b) for a, b in zip(first[0]["epoch_losses"],
                                                       single["epoch_losses"])],
            "ranks_equal_losses": all([st["loss"] for st in r["steps"]] == losses
                                      for r in first),
            "adapters_bit_equal": [len({str(r["steps"][j]["fingerprint"]) for r in first}) == 1
                                   for j in range(len(first[0]["steps"]))],
            "b0_codes_equal": b0_equal, "codes": summary}


def check_parity(line: dict, modes: list) -> None:
    """The distributed gates on a :func:`parity` line: the modes, ranks
    agreeing, the first step's loss within 1e-4, every step's within
    ``DIST_STEP_TOL`` and the epoch means within 5e-2 of the single
    process's, b0 codes bit-equal, taps and b_final within one step."""
    if line["modes"] != modes:
        raise AssertionError(f"modes {line['modes']}, wanted {modes}")
    if not (line["ranks_equal_losses"] and all(line["adapters_bit_equal"])):
        raise AssertionError(f"ranks disagree: losses {line['ranks_equal_losses']}, "
                             f"adapters {line['adapters_bit_equal']}")
    if not (line["abs_dloss_first_step"] <= 1e-4
            and len(line["step_losses"]) == len(line["single_step_losses"])
            and max(line["abs_dloss_steps"]) <= DIST_STEP_TOL
            and max(line["abs_depoch"]) <= 5e-2):
        raise AssertionError("distributed vs single-process losses: first step "
                             f"{line['abs_dloss_first_step']}, steps {line['abs_dloss_steps']}, "
                             f"epochs {line['abs_depoch']}")
    if not all(np.isfinite(x) for x in line["step_losses"]):
        raise AssertionError(f"losses {line['step_losses']}")
    summary = line["codes"]
    if (not line["b0_codes_equal"] or summary["taps"]["max_dq"] > 1
            or summary["b_final"]["max_dq"] > 1):
        raise AssertionError(f"cache codes: b0 equal {line['b0_codes_equal']}, {summary}")


DIST_TOL_REASON = ("the first step sums the same tokens' CE in another order (f32); every "
                   "step: the same sums in another order, so the losses stay within a few f32 "
                   "steps (9.5e-7 at 12) while a fault in the gradient sum moves a later step's "
                   "loss by far more; epochs: the trainer_cuda_vs_ref gate; tap codes: a frozen "
                   "forward on smaller micro-batches may round a code the other way")


def rank_stats(ranks: list) -> dict:
    """Per rank of a distributed run's first run: step walls, transfer
    bytes and host seconds, launches, memory high-water mark."""
    first = {r["rank"]: r["runs"][0] for r in ranks}
    return {"open_s": [run["open_s"] for run in first.values()],
            "step_s": {k: [st["wall_s"] for st in run["steps"]] for k, run in first.items()},
            "step_modes": [st["mode"] for st in first[0]["steps"]],
            "bytes_per_step": {k: [{x: st[x] for x in ("p2p_bytes", "p2p_s", "allreduce_bytes",
                                                       "allreduce_s")}
                                   for st in run["steps"]] for k, run in first.items()},
            "max_memory_allocated": [run["max_memory_allocated"] for run in first.values()],
            "launches_per_step": {k: [st["launches"] for st in run["steps"]]
                                  for k, run in first.items()}}


def distributed_phase(single: dict):
    """The hybrid DP x PP trainer at full width: the training phase's spec
    (internlm2-1.8b, 24 periods, INT8 backbone, int8 cache, r=8, pruning,
    lr 3e-3, 3 epochs x 2 steps of 4 x 512 tokens) with dp=2, stages=2
    (12 periods a stage, 2 micro-batches), as four ranks sharing the card
    over gloo, run twice. Gates: :func:`check_parity` against the
    single-process run; the two runs' per-step losses bit-equal; the
    training kernels launched on the ranks that run them. Returns the
    first run's launches summed over the ranks, and the ranks' records."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED,
                   dp=DIST_DP, stages=DIST_STAGES)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, DIST_DP, DIST_STAGES, "cuda", args=(spec, 2),
                  timeout=300.0, deadline=600.0)
    phase_s = time.perf_counter() - t0
    line = {"phase": "distributed", "arch": "internlm2-1.8b", "dp": DIST_DP,
            "stages": DIST_STAGES, "ranks": len(ranks), "backend": "gloo",
            "n_micro": spec.default_micro(), "batch": spec.batch, "seq": spec.seq,
            "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
            **parity(ranks, single)}
    rerun = [st["loss"] for st in ranks[0]["runs"][1]["steps"]]
    line["step_losses"] = [line["step_losses"], rerun]
    line["reruns_bit_equal"] = line["step_losses"][0] == rerun
    line["rerun_ranks_equal_losses"] = all([st["loss"] for st in r["runs"][1]["steps"]] == rerun
                                           for r in ranks)
    line["rerun_adapters_bit_equal"] = [
        len({str(r["runs"][1]["steps"][j]["fingerprint"]) for r in ranks}) == 1
        for j in range(len(ranks[0]["runs"][1]["steps"]))]
    line.update(rank_stats(ranks), phase_s=phase_s,
                tol={"first_step": 1e-4, "steps": DIST_STEP_TOL, "epoch": 5e-2, "tap_codes": 1},
                tol_reason=DIST_TOL_REASON)
    emit(line)
    line["step_losses"] = line["step_losses"][0]
    first = [r["runs"][0] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}
    check_parity(line, ["hybrid dp2xpp2", "cached pure-dp", "cached pure-dp"])
    if not (line["reruns_bit_equal"] and line["rerun_ranks_equal_losses"]
            and all(line["rerun_adapters_bit_equal"])):
        raise AssertionError(f"reruns differ: {line['step_losses']} against {rerun}, ranks "
                             f"{line['rerun_ranks_equal_losses']}, adapters "
                             f"{line['rerun_adapters_bit_equal']}")
    for r in ranks:
        for st in r["runs"][0]["steps"]:
            head = r["rank"] % DIST_STAGES == 0
            want = (("quant_matmul", "flash_attention") + (TRAINING_KERNELS[2:] if head else ())
                    if st["mode"].startswith("hybrid") else TRAINING_KERNELS[2:])
            if any(st["launches"][k] <= 0 for k in want):
                raise AssertionError(f"rank {r['rank']} {st['mode']}: launches {st['launches']}")
    return launches, ranks


# ---------------------------------------------------------------- plan-driven training

PLAN_REF_BOUNDARIES = (0, 5, 16, 24)  # the JAX planner's for the ragged plan's inputs
PLAN_MEMORY_SHARE = 0.5  # each device holds half the backbone's weights and adapter state
PLAN_MICRO_BATCH, PLAN_N_MICRO = 2, 2
PROJECTIONS_PER_PERIOD = 7  # quant_matmul launches a period of internlm2-1.8b (168 / 24)


def plan_kernel_phase(timer: Timer, gen: torch.Generator) -> None:
    """The plan path's kernels at the shapes it gives them that no other
    check covers: a stage runs one dp rank's micro-batch of 2 x 512, so
    ``quant_matmul`` at M = 1024 over the layer's (K, N), int8, and
    ``flash_attention`` at B·H = 2·16, S = 512. (The loss on stage 0 and
    the cached step run at T = 2048, the training phase's checked
    shape.) Each at the tolerance of its check at the training shapes."""
    M = PLAN_MICRO_BATCH * 512
    for K, N in QMM_SHAPES:
        _, _, got, want = qmm_check(gen, M, K, N, 8)
        emit({"check": "quant_matmul_plan", "M": M, "K": K, "N": N, "bits": 8,
              "max_abs_err": max_err(got, want),
              "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
              "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    r = flash_case(timer, gen, PLAN_MICRO_BATCH, 16, 8, 512, 128, "plan stage")[0]
    emit(dict(r, check="flash_attention_plan"))


def ragged_plan(cfg, workdir: Path):
    """The ragged plan, made by the port's planner: Alg. 1 over
    ``period_costs(cfg, "pac", 512, int8)`` and a pool of a Jetson Nano
    (low power), a TX2 (high) and a Nano (high), each holding
    ``PLAN_MEMORY_SHARE`` of the backbone's weights and adapter state,
    micro-batch 2, 2 micro-batches, at most 3 stages; saved as JSON.
    Returns (plan, its path, planner seconds)."""
    import dataclasses

    from repro_torch.core.planner import (JETSON_NANO_H, JETSON_NANO_L, JETSON_TX2_H,
                                          HybridParallelismPlanner, period_costs)

    t0 = time.perf_counter()
    pc = period_costs(cfg, "pac", seq_len=512, quant_bits=8)
    need = sum(c.param_bytes + 2 * c.trainable_bytes for c in pc)
    pool = [dataclasses.replace(d, memory_bytes=need * PLAN_MEMORY_SHARE)
            for d in (JETSON_NANO_L, JETSON_TX2_H, JETSON_NANO_H)]
    plan = HybridParallelismPlanner(pc, pool, PLAN_MICRO_BATCH, PLAN_N_MICRO).plan(max_stages=3)
    seconds = time.perf_counter() - t0
    path = workdir / "ragged_plan.json"
    plan.save(str(path))
    return plan, path, seconds


def plan_phase(single: dict, dist_ranks: list, workdir: Path):
    """Plan-driven training at full width. The port's planner makes the
    ragged plan (:func:`ragged_plan`; its boundaries must be the JAX
    planner's, ``PLAN_REF_BOUNDARIES``), saved to JSON; the calibrated
    cost model counts the full-width step on the meta device. Then the
    training phase's spec replays the plan (``plan=<file>, pool=3``):
    resolved once here (``resolve_layout``: dp=1 x 3 ragged stages) and
    run as 3 gloo ranks through ``EdgeSession``/``EpochRunner``, gated
    by :func:`check_parity` against the single-process run, each stage
    launching ``quant_matmul`` 7 x its periods x 2 micro-batches (and
    flash once a period and micro-batch) in epoch 1 and nothing in the
    cached epochs but on the owner. Last ``plan="auto", pool=4,
    micro=2``: Alg. 1 must pick (12, 12) on dp=2 x pp=2, and every
    step's loss and every rank's fingerprint must equal the distributed
    phase's first run bit for bit. Returns the launches of both runs,
    summed over the ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.core.pipeline import simulate_plan
    from repro_torch.launch.costs import AnalyticCostModel, CalibratedCostModel
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec
    from repro_torch.runtime.session import resolve_layout

    t_phase = time.perf_counter()
    cfg = get_arch("internlm2-1.8b")
    plan, path, plan_s = ragged_plan(cfg, workdir)
    part = plan.stage_partition()
    sim = simulate_plan(plan)
    emit({"phase": "plan_made", "boundaries": list(part.boundaries),
          "reference_boundaries": list(PLAN_REF_BOUNDARIES),
          "samples_per_device": [list(x) for x in part.samples_per_device],
          "devices": [[d.name for d in st.devices] for st in plan.stages],
          "planner_s": plan_s, "describe": plan.describe().splitlines()})
    print("plan boundaries:", part.boundaries, flush=True)
    if part.boundaries != PLAN_REF_BOUNDARIES:
        raise AssertionError(f"ragged plan boundaries {part.boundaries}, the reference "
                             f"planner's {PLAN_REF_BOUNDARIES}")

    t0 = time.perf_counter()
    calibrated = CalibratedCostModel(micro_batch=PLAN_MICRO_BATCH, quant_bits=8).period_costs(
        cfg, "pac", seq_len=512)
    calibrate_s = time.perf_counter() - t0
    analytic = AnalyticCostModel(quant_bits=8).period_costs(cfg, "pac", seq_len=512)
    emit({"phase": "plan_calibration", "arch": cfg.name, "micro_batch": PLAN_MICRO_BATCH,
          "seq": 512, "counted_on": "meta device, ref OpSet (FlopCounterMode)",
          "period_fwd_flops": {"calibrated": calibrated[0].fwd_flops,
                               "analytic": analytic[0].fwd_flops},
          "period_bwd_flops": {"calibrated": calibrated[0].bwd_flops,
                               "analytic": analytic[0].bwd_flops},
          "fwd_ratio": calibrated[0].fwd_flops / analytic[0].fwd_flops,
          "seconds": calibrate_s})

    base = dict(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED)
    spec = RunSpec(**base, plan=str(path), pool=3)
    layout = resolve_layout(spec)
    if (layout.dp, layout.stages, layout.n_micro) != (1, 3, PLAN_N_MICRO):
        raise AssertionError(f"ragged replay resolved to dp={layout.dp} x {layout.stages} "
                             f"stages, {layout.n_micro} micro-batches")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, layout.dp, layout.stages, "cuda",
                  args=(spec, 1, layout.to_json()), timeout=300.0, deadline=600.0)
    ragged_s = time.perf_counter() - t0
    line = {"phase": "plan", "arch": cfg.name, "plan": "saved ragged plan, replayed",
            "boundaries": list(part.boundaries),
            "rank_periods": {r["rank"]: list(r["runs"][0]["periods"]) for r in ranks},
            "dp": layout.dp, "stages": layout.stages, "n_micro": layout.n_micro,
            "pool": layout.pool, "ranks": len(ranks), "backend": "gloo",
            "batch": spec.batch, "seq": spec.seq, "quant": spec.quant,
            "cache": spec.cache_compress, "r": spec.r, **parity(ranks, single),
            **rank_stats(ranks), "run_s": ragged_s,
            "planner_estimate_jetson": {
                "note": "the planner's model of the Jetson pool, not a time on this card",
                "minibatch_latency_s": plan.minibatch_latency,
                "simulated_minibatch_s": sim["minibatch_time"],
                "simulated_bubble_fraction": sim["bubble_fraction"],
                "stage_time_s": [st.stage_time for st in plan.stages]},
            "tol": {"first_step": 1e-4, "steps": DIST_STEP_TOL, "epoch": 5e-2, "tap_codes": 1},
            "tol_reason": DIST_TOL_REASON}
    first = [r["runs"][0] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}

    # --plan auto: Alg. 1 on 4 Nano profiles must give the distributed phase's mesh
    auto = RunSpec(**base, plan="auto", pool=4, micro=2)
    auto_layout = resolve_layout(auto)
    t0 = time.perf_counter()
    auto_ranks = spawn(distributed_rank, auto_layout.dp, auto_layout.stages, "cuda",
                       args=(auto, 1, auto_layout.to_json()), timeout=300.0, deadline=600.0)
    auto_s = time.perf_counter() - t0
    auto_first = [r["runs"][0] for r in auto_ranks]
    dist_first = [r["runs"][0] for r in dist_ranks]
    auto_losses = [st["loss"] for st in auto_first[0]["steps"]]
    line["auto"] = {"boundaries": list(auto_layout.partition.boundaries),
                    "dp": auto_layout.dp, "stages": auto_layout.stages,
                    "modes": auto_first[0]["modes"], "step_losses": auto_losses,
                    "distributed_step_losses": [st["loss"] for st in dist_first[0]["steps"]],
                    "losses_bit_equal_distributed": auto_losses == [
                        st["loss"] for st in dist_first[0]["steps"]],
                    "fingerprints_bit_equal_distributed": all(
                        [st["fingerprint"] for st in a["steps"]]
                        == [st["fingerprint"] for st in d["steps"]]
                        for a, d in zip(auto_first, dist_first)),
                    "run_s": auto_s,
                    "planner_estimate_jetson": {
                        "note": "the planner's model of 4 Jetson Nano (high power), not a "
                                "time on this card",
                        "minibatch_latency_s": auto_layout.plan.minibatch_latency,
                        "simulated_bubble_fraction":
                            simulate_plan(auto_layout.plan)["bubble_fraction"]}}
    auto_launches = {k: sum(r["launches"][k] for r in auto_first) for k in TRAINING_KERNELS}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)

    check_parity(line, ["plan-driven dp1xpp3", "cached pure-dp", "cached pure-dp"])
    for r in ranks:
        a, b = r["runs"][0]["periods"]
        for st in r["runs"][0]["steps"]:
            got = st["launches"]
            if st["mode"].startswith("plan-driven"):
                want = {"quant_matmul": PROJECTIONS_PER_PERIOD * (b - a) * PLAN_N_MICRO,
                        "flash_attention": (b - a) * PLAN_N_MICRO}
                head = r["rank"] == 0
            else:
                want = {"quant_matmul": 0, "flash_attention": 0}
                head = r["rank"] == 0  # the cached rows shard over dp alone: the owner's
            loss_ok = (all(got[k] > 0 for k in TRAINING_KERNELS[2:]) if head
                       else all(got[k] == 0 for k in TRAINING_KERNELS[2:]))
            if any(got[k] != v for k, v in want.items()) or not loss_ok:
                raise AssertionError(f"rank {r['rank']} (periods [{a}, {b})) {st['mode']}: "
                                     f"launches {got}, wanted {want}")
    ragged_bounds = [r["runs"][0]["periods"] for r in ranks]
    if [list(p) for p in ragged_bounds] != [[part.boundaries[i], part.boundaries[i + 1]]
                                            for i in range(3)]:
        raise AssertionError(f"ranks ran periods {ragged_bounds}, the plan {part.boundaries}")
    want_auto = {"boundaries": [0, 12, 24], "dp": 2, "stages": 2,
                 "modes": ["plan-driven dp2xpp2", "cached pure-dp", "cached pure-dp"]}
    if any(line["auto"][k] != v for k, v in want_auto.items()):
        raise AssertionError(f"--plan auto: {line['auto']}, wanted {want_auto}")
    if not (line["auto"]["losses_bit_equal_distributed"]
            and line["auto"]["fingerprints_bit_equal_distributed"]):
        raise AssertionError("--plan auto differs from the distributed phase's run: "
                             f"{auto_losses} against {line['auto']['distributed_step_losses']}")
    return launches, auto_launches


# ---------------------------------------------------------------- fleet

FLEET_MEMBERS = 4
FLEET_KILL = (3, "dev1")  # tick, member: a tick inside the first cached epoch
#: launches a step of one job: (capture step, cached step of 4 chunks of one sequence)
FLEET_STEP_LAUNCHES = ({"quant_matmul": 168, "flash_attention": 24, "mix_fwd": 25, "mix_dw": 25,
                        "ce_fwd": 1, "ce_bwd": 1},
                       {"quant_matmul": 0, "flash_attention": 0, "mix_fwd": 100, "mix_dw": 100,
                        "ce_fwd": 4, "ce_bwd": 4})


def fleet_run(spec, names, members: int, events=None, quantum=None, snapshot_dir=None):
    """One ``FleetScheduler`` run of jobs ``names`` (job i on seed
    ``spec.seed + i``) over a bound pool of ``members`` members on the
    card (each slot past the card count maps to it: every member shares
    the one H100). Returns the run's record and its jobs, left open."""
    from repro_torch.checkpoint import tree_fingerprint
    from repro_torch.fleet import DeviceMember, DevicePool, FleetScheduler, SessionJob, SimClock
    from repro_torch.runtime import RunHooks

    steps, last = [], {}

    class Record(RunHooks):
        """Each step's loss, mode, wall time and launches (since the
        previous step of any job: jobs step one after another)."""

        def __init__(self, name):
            self.name = name

        def on_step(self, session, event):
            now = {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS}
            prev = last.get("launches", dict.fromkeys(now, 0))
            last["launches"] = now
            steps.append({"job": self.name, "epoch": event.epoch, "index": event.index,
                          "loss": event.loss, "mode": event.mode, "wall_s": event.wall_s,
                          "launches": {k: now[k] - prev[k] for k in now}})

    pool = DevicePool([DeviceMember(f"dev{i}") for i in range(members)], clock=SimClock(),
                      heartbeat_timeout=1.5, bind_devices=True)
    sched = FleetScheduler(pool, events=events, quantum=quantum, snapshot_dir=snapshot_dir,
                           log=print)
    jobs = [SessionJob(name, spec.replace(seed=spec.seed + i), hooks=[Record(name)])
            for i, name in enumerate(names)]
    for job in jobs:
        sched.submit(job)
    reset_launches()
    t0 = time.perf_counter()
    report = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"members": members, "devices": sorted({str(pool.torch_device(m)) for m in pool.alive()}),
           "run_s": wall,
           "launches": {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS},
           "ticks": [{"tick": r.tick, "placements": {k: list(v) for k, v in r.placements.items()},
                      "shares": {k: list(v) for k, v in r.shares.items()}, "lost": r.lost,
                      "preempted": r.preempted, "queued": r.queued} for r in report.ticks],
           "steps": steps,
           "jobs": {j.name: {"state": j.state, "losses": report.losses(j.name),
                             "fingerprint": tree_fingerprint(j.session.adapter),
                             "forward_steps": j.forward_steps, "cached_steps": j.cached_steps,
                             "reshards": j.reshards} for j in jobs}}
    return rec, jobs


def release(jobs: list) -> None:
    """Close finished jobs and drop them (the caller holds no other
    reference), so that the next run does not share the card with them."""
    for job in jobs:
        job.close()
    jobs.clear()


def fleet_phase(single: dict, workdir: Path) -> dict:
    """The fleet at full width: the training phase's spec (no checkpoint,
    no cache directory) as ``SessionJob``s under ``FleetScheduler`` on a
    ``SimClock``, every member on the one card. (a) ``alice`` alone on a
    bound pool of four; (b) the same with ``dev1`` killed at tick 3,
    inside the first cached epoch; (c) ``alice`` and ``bob`` (seed 1) on
    one member with quantum 2, preempted through snapshots on disk; (d)
    one elastic step of (a)'s first cached batch under the ``ref``
    kernels against ``cuda``. Gates: (b) and (c)'s ``alice`` equal (a)
    bit for bit (losses and adapter fingerprint); (a)'s capture steps
    equal the training phase's bit for bit, its cached steps within
    ``DIST_STEP_TOL`` and its epochs within 5e-2; (d) within the cached
    step's tolerances; (a)'s launches per step as
    ``FLEET_STEP_LAUNCHES``. Returns (a)'s launches."""
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.fleet import ElasticDpRunner, FaultPlan, FleetEvent, ScriptedEvents
    from repro_torch.runtime import RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    free, (a_job,) = fleet_run(spec, ["alice"], FLEET_MEMBERS)
    kill_tick, kill_dev = FLEET_KILL
    killed, jobs = fleet_run(spec, ["alice"], FLEET_MEMBERS, events=ScriptedEvents(
        FaultPlan([FleetEvent(kill_tick, "kill", device=kill_dev)])))
    release(jobs)
    snaps = workdir / "fleet_snapshots"
    preempt, jobs = fleet_run(spec, ["alice", "bob"], 1, quantum=2, snapshot_dir=str(snaps))
    release(jobs)

    # (d) (a)'s first cached batch, the final adapter, one elastic step's
    # loss and gradients under both kernel sets
    s = a_job.session
    ids = s.pipe.epoch_order(1)[0]
    b0, taps, bf = s.cache.get_batch(ids, with_final=True, dtype=None, compressed=True)
    cached = {"b0": b0, "taps": taps, "b_final": bf,
              "labels": torch.from_numpy(s.corpus.batch(ids)["labels"]).to(s.device)}
    first = next(t for t in free["ticks"] if t["tick"] == spec.steps_per_epoch)
    placement = [(m, s.device, sh) for m, sh in zip(first["placements"]["alice"],
                                                    first["shares"]["alice"])]
    res = {}
    for impl, runner in (("cuda", a_job._elastic),
                         ("ref", ElasticDpRunner(s.backbone, s.cfg, r=spec.r, lr=spec.lr,
                                                 kernel_impl="ref", device=s.device))):
        runner.reshard([(m, d) for m, d, _ in placement])
        loss, grads = runner.loss_and_grads(s.adapter, cached, placement)
        res[impl] = (float(loss), tree_leaves(grads))
    gmax = max(float(g.abs().max()) for g in res["ref"][1])
    gerr = max(max_err(a, b) for a, b in zip(res["cuda"][1], res["ref"][1]))
    dloss = abs(res["cuda"][0] - res["ref"][0])
    ref_vs_cuda = {"placement": [[m, sh] for m, _, sh in placement],
                   "loss": [res["cuda"][0], res["ref"][0]], "abs_dloss": dloss,
                   "max_abs_dgrad": gerr, "grad_max": gmax}
    release([a_job])
    del a_job, s, res, cached, b0, taps, bf, runner, loss, grads
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase

    want = free["jobs"]["alice"]
    losses = want["losses"]
    n_cap = spec.steps_per_epoch
    epochs = [float(np.mean(losses[e * n_cap:(e + 1) * n_cap])) for e in range(spec.epochs)]
    lost_at = next((t["tick"] for t in killed["ticks"] if kill_dev in t["lost"]), None)
    alice_steps = [st for st in free["steps"] if st["job"] == "alice"]
    line = {"phase": "fleet", "arch": "internlm2-1.8b", "batch": spec.batch, "seq": spec.seq,
            "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r, "chunk": 1,
            "clock": "SimClock", "heartbeat_timeout": 1.5,
            "note": "every member runs on the one card: placement and resharding are "
                    "exercised, transfers between cards are not",
            "runs": {"fault_free": free, "kill": killed, "preempt": preempt},
            "kill": {"tick": kill_tick, "device": kill_dev, "detected_at": lost_at},
            "step_losses": losses, "single_step_losses": single["step_losses"],
            "capture_bit_equal_single": losses[:n_cap] == single["step_losses"][:n_cap],
            "abs_dloss_steps": [abs(a - b) for a, b in zip(losses, single["step_losses"])],
            "epoch_losses": epochs, "single_epoch_losses": single["epoch_losses"],
            "abs_depoch": [abs(a - b) for a, b in zip(epochs, single["epoch_losses"])],
            "kill_bit_equal": (killed["jobs"]["alice"]["losses"] == losses
                               and killed["jobs"]["alice"]["fingerprint"] == want["fingerprint"]),
            "preempted_bit_equal": (preempt["jobs"]["alice"]["losses"] == losses
                                    and preempt["jobs"]["alice"]["fingerprint"]
                                    == want["fingerprint"]),
            "snapshot_on_disk": (snaps / "alice.ckpt").exists(),
            "launches_per_capture_step": [st["launches"] for st in alice_steps
                                          if "full" in st["mode"]],
            "launches_per_cached_step": [st["launches"] for st in alice_steps
                                         if st["mode"].startswith("elastic")],
            "ref_vs_cuda": ref_vs_cuda,
            "max_memory_allocated": peak, "phase_s": phase_s,
            "tol": {"cached_steps": DIST_STEP_TOL, "epoch": 5e-2, "loss": 2e-5,
                    "grads": 1e-4 * max(1.0, gmax)},
            "tol_reason": "capture steps run the training phase's EdgeSession.step (bit for "
                          "bit); a cached step sums the same tokens' CE and gradients a chunk "
                          "at a time (f32 reordered), as the distributed phase; ref vs cuda: "
                          "the cached_step_cuda_vs_ref tolerances"}
    emit(line)

    if not (free["jobs"]["alice"]["state"] == "done" and want["forward_steps"] == n_cap
            and want["cached_steps"] == n_cap * (spec.epochs - 1)):
        raise AssertionError(f"fault-free run: {want}")
    if not (line["capture_bit_equal_single"] and max(line["abs_dloss_steps"]) <= DIST_STEP_TOL
            and max(line["abs_depoch"]) <= 5e-2 and all(np.isfinite(losses))):
        raise AssertionError(f"fleet vs single process: steps {line['abs_dloss_steps']}, "
                             f"epochs {line['abs_depoch']}")
    k = killed["jobs"]["alice"]
    if not (line["kill_bit_equal"] and k["forward_steps"] == n_cap and k["reshards"] >= 1
            and lost_at is not None):
        raise AssertionError(f"kill run: {k}, detected at {lost_at}")
    late = [t for t in killed["ticks"] if t["tick"] >= lost_at
            and any(kill_dev in d for d in t["placements"].values())]
    if late:
        raise AssertionError(f"{kill_dev} placed after its loss was detected: {late}")
    p = preempt["jobs"]
    if not ("alice" in [n for t in preempt["ticks"] for n in t["preempted"]]
            and line["snapshot_on_disk"] and line["preempted_bit_equal"]
            and p["bob"]["state"] == "done" and p["bob"]["losses"] != losses):
        raise AssertionError(f"preemption run: {p}, snapshot {line['snapshot_on_disk']}")
    if not (dloss <= 2e-5 and gerr <= 1e-4 * max(1.0, gmax)):
        raise AssertionError(f"elastic step cuda vs ref: dloss {dloss}, dgrad {gerr}")
    want_steps = [FLEET_STEP_LAUNCHES[0]] * n_cap + [FLEET_STEP_LAUNCHES[1]] * (
        n_cap * (spec.epochs - 1))
    if [st["launches"] for st in alice_steps] != want_steps:
        raise AssertionError(f"launches per step {[st['launches'] for st in alice_steps]}")
    return free["launches"]


# ---------------------------------------------------------------- personal serving

PERSONAL_D, PERSONAL_DA = 2048, 256  # internlm2-1.8b, r=8
PROMPT_LEN, N_GREEDY, PERSONAL_MAX_LEN = 32, 32, 64


def personal_kernel_phase(timer: Timer, gen: torch.Generator):
    """``adapter_fuse`` against its plain version (f32 and bf16, λ in
    {0, 0.5, 1}) at the decode shapes T = 1 and 8, the training width
    T = 2048, and ragged shapes on both paths (the split-K path at T = 1
    and 8 with a partial 32-row slice of d, a partial 128-column block
    and 32 or 47 slices; the tiled path at T = 100), each timed beside
    the plain version and ``torch.addmm``; ``quant_matmul`` at the decode step's M = 1; flash
    attention and ``quant_matmul`` at the 32-token prompt's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.adapter_fuse import adapter_fuse
    from repro_torch.kernels.flash_attention import flash_attention

    dev, rows = DEV, {}
    reason = {torch.float32: "the reference's adapter_fuse tolerance (tests/test_kernels.py:68); "
                             "f32 sums reorder",
              torch.bfloat16: "bf16 output: the two f32 results may round to neighbouring bf16 "
                              "values, one step of 2^-7 relative at most; 1e-5 for the f32 "
                              "sums' reordering"}
    tol = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
    for T, d, da in ((1, PERSONAL_D, PERSONAL_DA), (8, PERSONAL_D, PERSONAL_DA),
                     (2048, PERSONAL_D, PERSONAL_DA), (1, 1000, 200), (8, 1500, 200),
                     (3, 2047, 130), (100, 1000, 200)):
        b32 = torch.randn(T, d, generator=gen, device=dev)
        w32 = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a32 = torch.randn(T, da, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            b, w, a = (t.to(dtype) for t in (b32, w32, a32))
            atol, rtol = tol[dtype]
            err = 0.0
            for lam_v in (0.0, 0.5, 1.0):
                lam = torch.tensor(lam_v, device=dev)
                got, want = adapter_fuse(b, w, a, lam), ref.adapter_fuse_ref(b, w, a, lam)
                if got.dtype != dtype or got.shape != (T, da):
                    raise AssertionError(f"adapter_fuse gave {got.dtype} {tuple(got.shape)}")
                check(f"adapter_fuse T={T} d={d} da={da} {dtype} lam={lam_v}",
                      float(((got - want).float().abs() - rtol * want.float().abs()).max()),
                      atol)
                err = max(err, max_err(got, want))
            lam = torch.tensor(0.5, device=dev)
            lam_host = float(lam)  # read once, outside the timing
            ws = [w] + [torch.randn(d, da, generator=gen, device=dev).to(dtype) * d ** -0.5
                        for _ in range(copies(w.numel() * w.element_size()) - 1)]
            esize = b.element_size()
            nbytes = T * d * esize + d * da * esize + 2 * T * da * esize + 4
            b_ms, b_by = bound(nbytes, 2.0 * T * d * da + 3.0 * T * da,
                               BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S)
            bounds = {}
            if T > 8:  # the tiled path: bf16 tensor cores, f32 operands split in three
                products = 6 if dtype == torch.float32 else 1
                b_ms, b_by = bound(nbytes, products * 2.0 * T * d * da + 3.0 * T * da,
                                   BF16_FLOP_PER_S)
                f32_ms, f32_by = bound(nbytes, 2.0 * T * d * da + 3.0 * T * da)
                bounds = {"bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
                          "bound_f32_by": f32_by}
            r = {"check": "adapter_fuse", "T": T, "d": d, "da": da, "dtype": str(dtype),
                 "lambdas": [0.0, 0.5, 1.0], "max_abs_err": err,
                 "tol": f"atol {atol} + rtol {rtol}", "tol_reason": reason[dtype],
                 "ms": timer([lambda w_=w_: adapter_fuse(b, w_, a, lam) for w_ in ws]),
                 "plain_ms": timer([lambda w_=w_: ref.adapter_fuse_ref(b, w_, a, lam)
                                    for w_ in ws]),
                 "library_ms": timer([lambda w_=w_: torch.addmm(a, b, w_, beta=1.0 - lam_host,
                                                                alpha=lam_host) for w_ in ws]),
                 "library": "torch.addmm(a, b, W, beta=1-λ, alpha=λ), λ read on the host once",
                 "bound_ms": b_ms, "bound_by": b_by, **bounds,
                 "path": "split-K" if T <= 8 else "tiled"}
            emit(r)
            if (T, d, da) == (1, PERSONAL_D, PERSONAL_DA) and dtype == torch.float32:
                rows["adapter_fuse"] = _row(r, "one period's mix at decode, T=1, d=2048, "
                                               "d_a=256, f32 (PERF.md also lists T=2048)")
            del ws
    qmm = {(1, K, N, 8): qmm_case(timer, gen, 1, K, N, 8) for K, N in QMM_SHAPES}
    emit({"check": "quant_matmul_layer", "M": 1, **layer_row(qmm, 1)})
    skinny_reruns(gen)
    # the prompt's shapes: 32 tokens, 16 heads over 8 KV heads
    for K, N in QMM_SHAPES:
        qmm_check(gen, PROMPT_LEN, K, N, 8)
    q = torch.randn(16, PROMPT_LEN, 128, generator=gen, device=dev)
    k, v = (torch.randn(8, PROMPT_LEN, 128, generator=gen, device=dev) for _ in range(2))
    err = max_err(flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    check(f"flash_attention S={PROMPT_LEN}", err, 3e-5)
    emit({"check": "prompt_shapes", "quant_matmul_M": PROMPT_LEN, "flash_BH": 16,
          "flash_S": PROMPT_LEN, "flash_max_abs_err": err, "tol": "as above"})
    return rows


def skinny_reruns(gen: torch.Generator) -> None:
    """The decode path's GEMV (``adapter_fuse`` at T = 1, f32, and
    ``quant_matmul`` at M = 1, K = 8192, N = 2048): two eager calls
    bit-equal, and each call captured in a CUDA graph and replayed three
    times equal to the eager call bit for bit."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.adapter_fuse import adapter_fuse
    from repro_torch.kernels.quant_matmul import quant_matmul

    b = torch.randn(1, PERSONAL_D, generator=gen, device=DEV)
    w = torch.randn(PERSONAL_D, PERSONAL_DA, generator=gen, device=DEV) * PERSONAL_D ** -0.5
    a = torch.randn(1, PERSONAL_DA, generator=gen, device=DEV)
    lam = torch.tensor(0.5, device=DEV)
    x = torch.randn(1, 8192, generator=gen, device=DEV)
    wq = quantize(torch.randn(8192, 2048, generator=gen, device=DEV) * 8192 ** -0.5, 8)
    calls = {"adapter_fuse": lambda: adapter_fuse(b, w, a, lam),
             "quant_matmul": lambda: quant_matmul(x, wq.q, wq.scale)}
    got = {}
    for name, fn in calls.items():
        eager = fn()
        again = fn()
        emit({"check": f"{name}_deterministic", "at": "T=1 d=2048 d_a=256 f32"
              if name == "adapter_fuse" else "M=1 K=8192 N=2048 int8",
              "bit_equal": bool(torch.equal(eager, again))})
        if not torch.equal(eager, again):
            raise AssertionError(f"{name}: two calls differ")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn()
        replays = []
        for _ in range(3):
            static.zero_()
            graph.replay()
            torch.cuda.synchronize()
            replays.append(bool(torch.equal(static, eager)))
        got[name] = replays
        del graph
    ok = all(all(v) for v in got.values())
    emit({"check": "skinny_graph_replay", "replays_equal_eager": got, "bit_equal": ok})
    if not ok:
        raise AssertionError(f"skinny GEMV: graph replays differ from eager: {got}")


def personal_phase(backbone, cfg, ckpt: Path, r: int = 8):
    """Serve the trained adapter, loaded from its checkpoint, with the
    reference's one-request loop: ``pac_decode_step`` at B=1 over an
    INT8 linear KV cache, 32 teacher-forced prompt tokens then 32 greedy
    tokens, under ``cuda`` (launches counted) and then ``ref``. Then
    ``prefill_step`` against the teacher-forced f32-cache decode, and
    the INT8-KV decode against the f32-KV one. Last, where the gap
    between the OpSets arises: the same loop over an f32 linear KV cache
    under both, each step's largest gap, and how many INT8 KV codes the
    two INT8 runs wrote differently."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import decode_step, pac_decode_step, prefill_step
    from repro_torch.models.backbone import init_cache

    dev = DEV
    adapter = load_checkpoint(str(ckpt), device=dev)["adapter"]
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32))
    prompt = prompt.to(dev)
    n_steps = PROMPT_LEN + N_GREEDY - 1  # the last step's logits give the 32nd greedy token

    def serve(impl, steps=n_steps, kv_quant=8):
        cache = init_cache(cfg, 1, PERSONAL_MAX_LEN, device=dev, kv_quant=kv_quant)
        acache = init_adapter_cache(cfg, 1, PERSONAL_MAX_LEN, r, device=dev)
        logits, greedy = [], []
        tok = prompt[:, :1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(steps):
            lg, cache, acache = pac_decode_step(
                backbone, adapter, {"tokens": tok}, cache, acache,
                torch.full((1,), p, dtype=torch.long, device=dev), cfg=cfg, r=r,
                kernel_impl=impl)
            logits.append(lg[:, 0])
            if p >= PROMPT_LEN - 1:
                greedy.append(lg[:, 0].argmax(-1))
            tok = prompt[:, p + 1:p + 2] if p + 1 < PROMPT_LEN else greedy[-1][:, None].int()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = [int(t) for t in torch.cat(greedy)] if greedy else []
        return torch.cat(logits), tokens, wall, cache

    serve("cuda", steps=2)  # warm-up: first launches, allocator growth
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits_cuda, tokens_cuda, wall, cache_cuda = serve("cuda")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "personal_profile", "steps": 2, "from": "an empty cache",
          **device_profile(lambda: serve("cuda", steps=2), watch=SKINNY_WATCH)})
    logits_ref, tokens_ref, wall_ref, cache_ref = serve("ref")
    dlogits = max_err(logits_cuda, logits_ref)
    logits_cuda32, tokens_cuda32, _, _ = serve("cuda", kv_quant=None)
    logits_ref32, tokens_ref32, _, _ = serve("ref", kv_quant=None)
    dlogits32 = max_err(logits_cuda32, logits_ref32)
    codes = [(cc[k].int() - cr[k].int()).abs()[:, :, :n_steps]
             for cc, cr in zip(cache_cuda, cache_ref) for k in ("k", "v")]
    emit({"phase": "personal_gap", "steps": n_steps,
          "max_abs_dlogits_int8_kv": dlogits, "max_abs_dlogits_f32_kv": dlogits32,
          "tokens_equal_f32_kv": tokens_cuda32 == tokens_ref32,
          "kv_codes_differing": sum(int((c != 0).sum()) for c in codes),
          "kv_codes_written": sum(c.numel() for c in codes),
          "kv_code_max_step": max(int(c.max()) for c in codes),
          "per_step_int8_kv": (logits_cuda - logits_ref).abs().amax(-1).tolist(),
          "per_step_f32_kv": (logits_cuda32 - logits_ref32).abs().amax(-1).tolist()})

    def teacher_forced(kv_quant):
        cache = init_cache(cfg, 1, PROMPT_LEN, device=dev, kv_quant=kv_quant)
        for p in range(PROMPT_LEN):
            lg, cache = decode_step(backbone, {"tokens": prompt[:, p:p + 1]}, cache,
                                    torch.full((1,), p, dtype=torch.long, device=dev), cfg=cfg,
                                    kernel_impl="cuda")
        return lg

    pre = prefill_step(backbone, {"tokens": prompt}, cfg=cfg, kernel_impl="cuda")
    dec32, dec8 = teacher_forced(None), teacher_forced(8)
    rel_prefill = max_err(dec32, pre) / float(pre.abs().max())
    rel_kv = max_err(dec8, dec32) / float(dec32.abs().max())
    per_step = {k: v / n_steps for k, v in launches.items()}
    finite = bool(torch.isfinite(logits_cuda).all() and torch.isfinite(logits_ref).all())
    tol = {"dlogits": 2e-2, "dlogits_f32_kv": 2e-4, "prefill_rel": 2e-3, "int8_kv_rel": 5e-2}
    emit({"phase": "personal", "arch": cfg.name, "batch": 1, "prompt_tokens": PROMPT_LEN,
          "greedy_tokens": N_GREEDY, "max_len": PERSONAL_MAX_LEN, "kv": "int8 linear",
          "adapter": f"{ckpt.name}, r={r}", "steps": n_steps,
          "decode_ms_per_step": wall * 1e3 / n_steps,
          "ref_decode_ms_per_step": wall_ref * 1e3 / n_steps,
          "max_memory_allocated": peak, "launches": launches, "launches_per_step": per_step,
          "tokens_cuda": tokens_cuda, "tokens_equal": tokens_cuda == tokens_ref,
          "max_abs_dlogits": dlogits, "max_abs_dlogits_f32_kv": dlogits32,
          "prefill_vs_decode_rel": rel_prefill,
          "int8_vs_f32_kv_rel": rel_kv, "finite": finite, "logits_shape": list(pre.shape),
          "tol": tol,
          "tol_reason": "serving gate (PERF.md section 2) over the int8 KV, whose one-step code "
                        "flips carry the f32 sums' reordering forward; over the f32 KV the "
                        "reference's decode-parity ceiling (tests/test_decode_parity.py:36); "
                        "prefill vs decode and int8 vs f32 KV are the reference's bounds "
                        "(tests/test_backbone_smoke.py:123, :152)"})
    if (tokens_cuda != tokens_ref or tokens_cuda32 != tokens_ref32 or not finite
            or dlogits > tol["dlogits"] or dlogits32 > tol["dlogits_f32_kv"]):
        raise AssertionError(f"cuda vs ref: tokens equal {tokens_cuda == tokens_ref} (int8 KV), "
                             f"{tokens_cuda32 == tokens_ref32} (f32 KV), |dlogits| {dlogits} "
                             f"(int8 KV), {dlogits32} (f32 KV), finite {finite}")
    if rel_prefill > tol["prefill_rel"] or rel_kv > tol["int8_kv_rel"]:
        raise AssertionError(f"prefill vs decode {rel_prefill}, int8 vs f32 KV {rel_kv}")
    if per_step["adapter_fuse"] != cfg.n_periods or per_step["quant_matmul"] != 7 * cfg.n_layers:
        raise AssertionError(f"launches per decode step: {per_step}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    seconds = _build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": seconds})
    for name in _build.KERNELS:
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # each path's kernels are checked just before the path runs, so that
    # no path's measurements carry another's leftovers
    rows = kernel_phase(Timer(), gen)
    serving = serving_phase(gen)
    serving_done_s = time.perf_counter() - T_START  # the serving slice's phases
    rows.update(training_kernel_phase(Timer(), gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        training, backbone, ckpt, single = training_phase(Path(workdir))
        training_done_s = time.perf_counter() - T_START
        rows.update(personal_kernel_phase(Timer(), gen))
        personal = personal_phase(backbone, get_arch("internlm2-1.8b"), ckpt)
        del backbone
        personal_done_s = time.perf_counter() - T_START
        prefetch = prefetch_phase(Path(workdir))
        prefetch_done_s = time.perf_counter() - T_START
        distributed_kernel_phase(Timer(), gen)
        distributed, dist_ranks = distributed_phase(single)
        distributed_done_s = time.perf_counter() - T_START
        plan_kernel_phase(Timer(), gen)
        plan, plan_auto = plan_phase(single, dist_ranks, Path(workdir))
        del dist_ranks
        plan_done_s = time.perf_counter() - T_START
        fleet = fleet_phase(single, Path(workdir))
        del single

    sources = {"quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                                "src/repro/kernels/quant_matmul.py:93"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:108"),
               "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:142"),
               "mix_fwd": ("src/repro_torch/kernels/csrc/cached_mix.cu",
                           "src/repro/kernels/cached_step.py:186"),
               "mix_dw": ("src/repro_torch/kernels/csrc/cached_mix.cu",
                          "src/repro/kernels/cached_step.py:271"),
               "ce_fwd": ("src/repro_torch/kernels/csrc/lmhead_ce.cu",
                          "src/repro/kernels/cached_step.py:459"),
               "ce_bwd": ("src/repro_torch/kernels/csrc/lmhead_ce.cu",
                          "src/repro/kernels/cached_step.py:497"),
               "adapter_fuse": ("src/repro_torch/kernels/csrc/adapter_fuse.cu",
                                "src/repro/kernels/adapter_fuse.py:83")}
    paths = {"serving": serving, "training": training, "personal": personal,
             "prefetch": prefetch, "distributed": distributed, "plan": plan,
             "plan_auto": plan_auto, "fleet": fleet}
    home = {"quant_matmul": "serving", "flash_attention": "serving",
            "paged_attention": "serving", "adapter_fuse": "personal"}
    # each kernel's launches on its own main path (serving for the first
    # three, training for the four training kernels, personal for
    # adapter_fuse), every path listed
    device_names = {"quant_matmul": ["skinny::gemv (M <= 8)", "qmm_mma (M > 8)"],
                    "flash_attention": ["flash_split", "flash_fwd_mma"],
                    "paged_attention": ["paged_attn"],
                    "mix_fwd": ["mix_fwd_mma", "mix_fwd_reduce"],
                    "mix_dw": ["mix_dw_mma", "dw_reduce"],
                    "ce_fwd": ["ce_split", "ce_fwd_mma", "ce_merge"],
                    "ce_bwd": ["ce_split", "ce_grad_mma", "ce_dh_mma"],
                    "adapter_fuse": ["skinny::gemv (T <= 8)",
                                     "mix_fwd_mma + mix_fwd_reduce (T > 8)"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "device_kernels": device_names[name],
         "launches": paths[home.get(name, "training")][name],
         "launches_by_path": {p: counts.get(name, 0) for p, counts in paths.items()},
         **rows[name]}
        for name, (src, rep) in sources.items()]})
    emit({"phase": "done", "wall_s": time.perf_counter() - T_START,
          "through_serving_s": serving_done_s, "through_training_s": training_done_s,
          "through_personal_s": personal_done_s, "through_prefetch_s": prefetch_done_s,
          "through_distributed_s": distributed_done_s, "through_plan_s": plan_done_s})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
