"""What bounds the LM-head CE kernels' tensor-core loop (``ce_fwd`` and
``ce_bwd``, which share it, ``src/repro_torch/kernels/csrc/lmhead_ce.cu``):
the kernels as shipped beside variants of their source, built and timed in
one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.ce_fwd_variants [--w-bf16] [--only a,b]

``--w-bf16`` casts the head W to bf16 (a bf16 backbone's head: the
``<3, 1>`` instantiations, h f32 in three terms against W's one plane);
``--only`` builds and runs the named variants alone.

Each variant is the shipped source with a few constants or lines
replaced (in ``lmhead_ce.cu``, or in the wgmma loop's header
``wgmma_loop.cuh`` where an edit names it), compiled by nvcc into
``build/ce_fwd_variants/`` at the repository root (all at once, with the
port's flags) and swapped in under the ``ce_fwd`` and ``ce_bwd`` wrappers:

* ``shipped``: the source as it is: an f32 W on ``tile_mma`` (BK = 64,
  two stages, 64 x 32 warp tiles), a bf16 W on the wgmma loop.
* ``tile_mma_bf16``: a bf16 W back on ``tile_mma`` (``ce_pad``'s W
  chunks, 3 products a k16 step): the loop it took before the wgmma loop.
* ``wg_fwd_nh1``, ``wg_grad_nh2``, ``wg_dh_nh1``: the wgmma loop with
  one kernel's tile the other width (128 or 256 columns: one or two
  128-column halves a consumer warpgroup; the shipped ones are 256, 128,
  256).
* ``bk32_s4``: ``tile_mma`` with 32-deep stages, four of them.
* ``warp64x64``: ``tile_mma`` with 64 x 64 warp tiles (a third fewer
  ldmatrix a product), 32-deep stages, three of them.
* ``one_product``, ``no_mma``: diagnostics of ``tile_mma``, not the
  function: only the hi·hi product, or no MMA at all (the loads, ldmatrix
  and epilogue alone). Their time less the shipped one's splits the loop
  into the tensor cores' share and the operand streaming's.
* ``one_term``, ``no_wgmma``, ``producer_only``: diagnostics of the wgmma
  loop, not the function: only h's hi term against W, no wgmma at all
  (TMA, barriers, the promoting adds and the epilogue), or the producer
  alone (consumers release each stage as it lands: the TMA stream).

The variants that compute the function are held to the plain versions
(nll and lse atol 2e-5 + rtol 1e-5, dh on the plain forward's lse atol
1e-5 + rtol 1e-4; soft-cap on and off, the training shape and two ragged
ones) and to bit-equal reruns. Times are CUDA-event means over 4 calls at
T = 4·512, d = 2048, V = 92544, the variants in turns and then in
reverse, and device time by kernel name from ``torch.profiler``. One JSON
object a line; the card's name and power limit first. Needs one CUDA card
and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, lmhead_ce, ref

K32 = [("BK = 64;                   // contraction per stage", "BK = 32;")]
ONE = [("for (int ord = OMAX; ord >= 0; --ord)", "for (int ord = 0; ord >= 0; --ord)")]
NO_MMA = [("mma_bf16(part[mm][ni], af[mm][i], bf[ord - i][ni]);", "{}")]
LOOP = "wgmma_loop.cuh"
#: name -> edits, each (old, new) in lmhead_ce.cu or (source, old, new)
VARIANTS = {
    "shipped": [],
    "tile_mma_bf16": [("constexpr int BF16_W_ON_WGMMA = 1;",
                       "constexpr int BF16_W_ON_WGMMA = 0;")],
    "wg_fwd_nh1": [("NH_FWD = 2,", "NH_FWD = 1,")],
    "wg_grad_nh2": [("NH_GRAD = 1,", "NH_GRAD = 2,")],
    "wg_dh_nh1": [("NH_DH = 2;", "NH_DH = 1;")],
    "bk32_s4": K32 + [("STAGES = 2;", "STAGES = 4;")],
    "warp64x64": K32 + [("WTM = 64, WTN = 32;", "WTM = 64, WTN = 64;"),
                        ("STAGES = 2;", "STAGES = 3;")],
    "one_product": ONE,
    "no_mma": NO_MMA,
    "one_term": [(LOOP, "for (int j = TA - 1; j >= 0; --j)", "for (int j = 0; j >= 0; --j)")],
    "no_wgmma": [(LOOP, "mma<B_KMAJOR ? 0 : 1>(part, da, db, j < TA - 1 || kk > 0);", "{}")],
    "producer_only": [(LOOP, "    bar_wait(&r.full[s], (kt / STAGES) & 1);\n",
                       "    bar_wait(&r.full[s], (kt / STAGES) & 1);\n"
                       "    if ((threadIdx.x & 31) == 0) bar_arrive(&r.empty[s]);\n"
                       "    continue;\n")],
}
DIAGNOSTIC = ("one_product", "no_mma", "one_term", "no_wgmma", "producer_only")
MMA_KERNELS = ("ce_fwd_mma", "ce_grad_mma", "ce_dh_mma", "ce_fwd_wg", "ce_grad_wg",
               "ce_dh_wg")
SHAPES = [(2048, 2048, 92544), (1001, 1000, 3001), (37, 130, 517)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def edits(name: str):
    """Variant ``name``'s edits as (source, old, new)."""
    return [e if len(e) == 3 else ("lmhead_ce.cu", *e) for e in VARIANTS[name]]


def build(out: Path, names) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        texts = {}
        for source, old, new in edits(name):
            text = texts.get(source, (_build.CSRC / source).read_text())
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in {source}")
            texts[source] = text.replace(old, new)
        vdir = out / name  # an edited header sits beside its source, found before csrc's
        vdir.mkdir(exist_ok=True)
        for source, text in texts.items():
            (vdir / source).write_text(text)
        src = vdir / "lmhead_ce.cu"
        if "lmhead_ce.cu" not in texts:
            src.write_text((_build.CSRC / "lmhead_ce.cu").read_text())
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        entry, report = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = next((k for k in MMA_KERNELS if k in line), "")
            elif entry and ("Used" in line or "spill" in line):
                report.append(f"{entry}: {line.strip()}")
        emit({"variant": name, "ptxas": report})
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def use(lib) -> None:
    """Route the ``ce_fwd`` and ``ce_bwd`` wrappers to ``lib``."""
    _build._libs["lmhead_ce"] = lib


def mean_ms(fn, calls: int = 4) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--w-bf16", action="store_true", help="a bf16 head W")
    ap.add_argument("--only", default="", help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__})
    only = [v for v in args.only.split(",") if v]
    unknown = sorted(set(only) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known {sorted(VARIANTS)}")
    libs = build(_build.BUILD_DIR.parent / "ce_fwd_variants", only or list(VARIANTS))
    w_dtype = torch.bfloat16 if args.w_bf16 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for T, d, V in SHAPES:
        h = torch.randn(T, d, generator=gen, device="cuda")
        w = (torch.randn(d, V, generator=gen, device="cuda") * d ** -0.5).to(w_dtype)
        lab = torch.randint(0, V, (T,), generator=gen, device="cuda")
        g = torch.randn(T, generator=gen, device="cuda")
        wants = {}
        for cap in (None, 30.0):
            nll, lse = ref.ce_fwd_ref(h, w, lab, cap)
            wants[cap] = (nll, lse, ref.ce_bwd_ref(h, w, lab, lse, g, cap))
        data[(T, d, V)] = (h, w, lab, g, wants)
    ok = True
    for name, lib in libs.items():
        if name in DIAGNOSTIC:
            continue
        use(lib)
        for (T, d, V), (h, w, lab, g, wants) in data.items():
            for cap, (want_nll, want_lse, want_dh) in wants.items():
                nll, lse = lmhead_ce.ce_fwd(h, w, lab, cap)
                nll2, lse2 = lmhead_ce.ce_fwd(h, w, lab, cap)
                chk = max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                          float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))
                equal = bool(torch.equal(nll, nll2) and torch.equal(lse, lse2))
                dh = lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)
                chk_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
                equal_b = bool(torch.equal(dh, lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)))
                ok &= chk <= 2e-5 and equal and chk_b <= 1e-5 and equal_b
                emit({"variant": name, "T": T, "d": d, "V": V, "softcap": cap,
                      "max_abs_err": max(float((nll - want_nll).abs().max()),
                                         float((lse - want_lse).abs().max())),
                      "check": chk, "tol": "atol 2e-5 + rtol 1e-5", "bit_equal": equal,
                      "dh_max_abs_err": float((dh - want_dh).abs().max()), "dh_check": chk_b,
                      "dh_tol": "atol 1e-5 + rtol 1e-4", "dh_bit_equal": equal_b})
    h, w, lab, g, wants = data[SHAPES[0]]
    lse = wants[None][1]
    calls = {"ce_fwd": lambda: lmhead_ce.ce_fwd(h, w, lab),
             "ce_bwd": lambda: lmhead_ce.ce_bwd(h, w, lab, lse, g)}
    times = {name: {k: [] for k in calls} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for k, fn in calls.items():
            times[name][k].append(mean_ms(fn))
    wf = w.float()  # the reference's function: h and W in f32 (a bf16 W cast per tile)
    library = mean_ms(lambda: torch.logsumexp(torch.matmul(h, wf), dim=-1))
    hr = h.clone().requires_grad_()
    loss = torch.nn.functional.cross_entropy(torch.matmul(hr, wf), lab.long(), reduction="sum")
    library_bwd = mean_ms(lambda: torch.autograd.grad(loss, hr, retain_graph=True))
    del loss, wf
    from torch.profiler import ProfilerActivity, profile

    for name, lib in libs.items():
        use(lib)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                fn()
            torch.cuda.synchronize()
        by_name = {e.key.replace("(anonymous namespace)::", "").split("(")[0][-60:]:
                   e.device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_time_total > 0}
        emit({"variant": name, "T": SHAPES[0][0], "d": SHAPES[0][1], "V": SHAPES[0][2],
              "w_dtype": str(w_dtype).split(".")[-1], "ms_in_turns": times[name],
              "device_ms_by_kernel": by_name,
              "computes_the_function": name not in DIAGNOSTIC})
    emit({"library_ms": library, "library": "torch.matmul in f32 (TF32 off), then torch.logsumexp",
          "library_bwd_only_ms": library_bwd,
          "library_bwd_only": "torch.autograd.grad of F.cross_entropy(h @ W), graph built once",
          "card": card, "all_checks_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
