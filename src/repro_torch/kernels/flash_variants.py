"""What bounds ``flash_attention``'s tensor-core loops (``flash_fwd_mma``,
and ``flash_fwd_wg``, the bf16 branch's, in
``src/repro_torch/kernels/csrc/flash_attention.cu``): the kernel as shipped
beside variants of its source, built and timed in one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_variants [--bf16]

Each variant is the shipped source with a few constants or lines replaced,
compiled by nvcc into ``build/flash_variants/`` at the repository root (all
at once, with the port's flags) and swapped in under the
``flash_attention`` wrapper. Without ``--bf16``, f32 q, k, v on
``flash_fwd_mma``:

* ``shipped``: the source as it is (32-key tiles, two 4-warp blocks an SM,
  the products of 8 n8 tiles of P·V summed together).
* ``bkv64``: 64-key tiles, one block an SM (its 3-plane tiles take 153 KB).
* ``warps8``: 128-row query tiles of 8 warps, one block an SM.
* ``rolled``: the k16 loop of Q·Kᵀ not unrolled.
* ``ng4``, ``ng2``: P·V's products summed over 4 or 2 n8 tiles at a time.
* ``split_only``, ``no_mma``: diagnostics, not the function: only the K/V
  split pass (the attention kernel not launched), or the attention kernel
  without its MMAs (loads, Q's split, ldmatrix, softmax, P's split, the
  epilogue). Their times split a call into the split pass, the tensor
  cores' share and the rest of the loop.

With ``--bf16``, bf16 q, k, v (the bf16 backbone's) on ``flash_fwd_wg``:

* ``shipped``: the source as it is (TMA, 64-key tiles, two stages of K
  and V, two consumer warpgroups issuing ``wgmma``).
* ``mma_sync_bf16``: the loop the bf16 branch took before
  (``flash_pad`` + ``flash_fwd_mma<128, bf16>``: ``mma.sync``, ``cp.async``,
  ``ldmatrix``), for the parent's time in the same process.
* ``wg_bkv128``: 128-key tiles (S on m64n128k16; P's terms then take 96
  registers and spill).
* ``wg_stages3``: three stages of K and V instead of two.
* ``wg_producer_only``, ``wg_no_wgmma``, ``wg_no_softmax``: diagnostics,
  not the function: the producer's TMA stream alone (the consumers wait
  for each tile and release it unread), the loop without its ``wgmma``
  (TMA, barriers, softmax, P's split, the epilogue), or without the
  softmax (S goes to P·V as it is).

The variants that compute the function are held to the plain version at
the prefill shape, causal, with window 128 and soft-cap 30, and at S = 1001
(f32: hd 64 and 128, window 32; bf16: hd 128, window 128; grouped and not,
causal and not): f32 at atol 3e-5, bf16 at one bf16 rounding of O (|Δ| <=
2^-7·|want| + 1e-6); and to bit-equal reruns. Times are CUDA-event medians
of 5 replays of a CUDA graph of 10 calls (L2 flushed before each replay) at
the prefill shape (B·H = 8·16 over 8·8 KV heads, S = 512, hd = 128,
causal) and the epoch-1 step's (B·H = 4·16), the variants in turns and
then in reverse, beside SDPA with the KV heads repeated beforehand (bf16:
SDPA on bf16, and SDPA in f32 on the upcast q, k, v with O cast to bf16,
the reference's function). Each variant's line gives ptxas's report and
the registers ``flash_fwd_wg``'s machine code uses (``cuobjdump``: ptxas
reports the launch bounds' cap, not what ``setmaxnreg`` gives the
consumers). One JSON object a line; the card's name and power limit first.
Needs one CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

KK_LOOP = "#pragma unroll\n    for (int kk = 0; kk < KSTEPS; ++kk) {"
ONE_BLOCK = ("static constexpr int MIN_BLOCKS = CW == 1 ? 2 : 1;",
             "static constexpr int MIN_BLOCKS = 1;")  # one block an SM at every HD
VARIANTS = {
    "shipped": [],
    "bkv64": [("constexpr int BKV = 32;", "constexpr int BKV = 64;"), ONE_BLOCK],
    "warps8": [("constexpr int GROUPS = 4;", "constexpr int GROUPS = 8;"), ONE_BLOCK],
    "rolled": [(KK_LOOP, KK_LOOP.replace("unroll", "unroll 1"))],
    "ng4": [("constexpr int NG = 8;", "constexpr int NG = 4;")],
    "ng2": [("constexpr int NG = 8;", "constexpr int NG = 2;")],
    "split_only": [("  if (Sq == 0) return 0;", "  return 0;")],
    "no_mma": [("mma_bf16(part[nt], qa[i], kb[ord - i][nt]);", "{}"),
               ("mma_bf16(part[nt], pa[i], vb[ord - i][nt]);", "{}")],
    "mma_sync_bf16": [("constexpr int BF16_ON_WGMMA = 1;", "constexpr int BF16_ON_WGMMA = 0;")],
    "wg_bkv128": [("constexpr int BKV = 64;  ", "constexpr int BKV = 128; ")],
    "wg_stages3": [("constexpr int STAGES = 2;  ", "constexpr int STAGES = 3;  ")],
    "wg_producer_only": [("const bool live = g0 < Sq &&", "const bool live = false && g0 < Sq &&")],
    "wg_no_wgmma": [("qk_mma(d, da, db, kk > 0);", "{}"),
                    ("wgl::mma_rs<1>(", "if (0) wgl::mma_rs<1>(")],
    "wg_no_softmax": [("softmax(sc, k0, alpha);", "alpha[0] = alpha[1] = 1.f;")],
}
F32_RUN = ("shipped", "bkv64", "warps8", "rolled", "ng4", "ng2", "split_only", "no_mma")
BF16_RUN = ("shipped", "mma_sync_bf16", "wg_bkv128", "wg_stages3", "wg_producer_only",
            "wg_no_wgmma", "wg_no_softmax")
DIAGNOSTIC = ("split_only", "no_mma", "wg_producer_only", "wg_no_wgmma", "wg_no_softmax")
TIMED = {"prefill": (8, 16, 8), "training": (4, 16, 8)}  # (B, H, Hkv) at S = 512, hd = 128
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6  # one bf16 rounding of O (chip_smoke.py's BF16_OUT_TOL)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def entry_name(line: str) -> str:
    """The kernel a ptxas "Compiling entry function" line names, or ""."""
    if "flash_fwd_wg" in line:
        return "flash_fwd_wg"
    for hd in fa.HEAD_DIMS:
        for bf, tag in (("1", ", bf16"), ("0", "")):
            if f"flash_fwd_mmaILi{hd}ELb{bf}E" in line:
                return f"flash_fwd_mma<{hd}{tag}>"
    return ""


def sass_registers(so: Path) -> int:
    """The highest register ``flash_fwd_wg``'s machine code names in the
    library ``so`` (``cuobjdump -sass``), plus one: what its consumer
    warpgroups use after ``setmaxnreg``, which ptxas's report (the launch
    bounds' cap) does not show. -1 where the kernel is not found."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    top, inside = -1, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "flash_fwd_wg" in line
        elif inside:
            top = max([top] + [int(r) for r in re.findall(r"\bR(\d+)\b", line)])
    return top + 1 if top >= 0 else -1


def build(out: Path, names) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in flash_attention.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
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
                entry = entry_name(line)
            elif entry and ("Used" in line or "spill" in line):
                report.append(f"{entry}: {line.strip()}")
        emit({"variant": name, "ptxas": report,
              "flash_fwd_wg_sass_registers": sass_registers(out / f"{name}.so")})
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def graph_ms(fn, flush: torch.Tensor, calls: int = 10, runs: int = 5) -> float:
    """Device ms of one call: ``calls`` calls captured in a CUDA graph (no
    host launch time between them), the median of ``runs`` replays, the L2
    flushed before each."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def use(lib) -> None:
    """Route the ``flash_attention`` wrapper to ``lib``."""
    _build._libs["flash_attention"] = lib


def inputs(gen: torch.Generator, BH: int, BHkv: int, S: int, hd: int, dtype=torch.float32):
    return tuple(torch.randn(n, S, hd, generator=gen, device="cuda").to(dtype)
                 for n in (BH, BHkv, BHkv))


def excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """f32: max |Δ|; bf16: max(|Δ| − 2^-7·|want|), one bf16 rounding."""
    d = (got.float() - want.float()).abs()
    return float((d - BF16_RTOL * want.float().abs()).max() if got.dtype == torch.bfloat16
                 else d.max())


def checks(name: str, data: dict) -> bool:
    """``name``'s largest |Δ| against the plain version over the checked
    cases (bf16: the excess over one bf16 rounding of O), and whether two
    calls at the prefill shape are bit-equal."""
    errs, worst = {}, 0.0
    for key, (q, k, v) in data.items():
        w = 128 if q.dtype == torch.bfloat16 else 32
        options = ([{}, {"window": 128, "attn_softcap": 30.0}] if key == "prefill" else
                   [{"causal": c, "window": win, "attn_softcap": cap} for c in (True, False)
                    for win in (None, w) for cap in (None, 30.0)])
        outs = [(fa.flash_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw))
                for kw in options]
        errs[key] = max(float((g.float() - r.float()).abs().max()) for g, r in outs)
        worst = max(worst, max(excess(g, r) for g, r in outs))
    q, k, v = data["prefill"]
    equal = bool(torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)))
    bf16 = q.dtype == torch.bfloat16
    ok = equal and worst <= (BF16_ATOL if bf16 else 3e-5)
    emit({"variant": name, "max_abs_err": errs, "check": worst,
          "tol": f"|dO| <= 2^-7 |O| + {BF16_ATOL}" if bf16 else "atol 3e-5",
          "bit_equal": equal, "route": fa.route_of(q)})
    return ok


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="bf16 q, k, v (flash_fwd_wg)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__})
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    libs = build(_build.BUILD_DIR.parent / "flash_variants", BF16_RUN if args.bf16 else F32_RUN)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {at: inputs(gen, B * H, B * Hkv, 512, 128, dtype) for at, (B, H, Hkv) in TIMED.items()}
    checked = {"prefill": timed["prefill"]}
    for hd in ((128,) if args.bf16 else (64, 128)):
        for n_rep in (1, 2):
            checked[f"S=1001 hd={hd} n_rep={n_rep}"] = inputs(gen, 4 * n_rep, 4, 1001, hd, dtype)
    ok = True
    for name, lib in libs.items():
        if name not in DIAGNOSTIC:
            use(lib)
            ok &= checks(name, checked)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    times = {name: {at: [] for at in TIMED} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for at, (q, k, v) in timed.items():
            times[name][at].append(graph_ms(lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
                                            flush))
    for name in libs:
        emit({"variant": name, "dtype": str(dtype).split(".")[-1],
              "computes_the_function": name not in DIAGNOSTIC, "ms_in_turns": times[name]})
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {}
    for at, (B, H, Hkv) in TIMED.items():
        q, k, v = (t.reshape(B, -1, 512, 128) for t in timed[at])
        k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        library[at] = graph_ms(lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True), flush)
        if args.bf16:  # the reference's function: f32 throughout, O cast to bf16 once
            q, k, v = (t.float() for t in (q, k, v))
            library[f"{at}_f32_upcast"] = graph_ms(
                lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True).to(torch.bfloat16), flush)
    emit({"library_ms": library, "library": "scaled_dot_product_attention, causal, KV heads "
          "repeated beforehand" + ("; on bf16, and (_f32_upcast) in f32 on q, k, v cast to "
                                   "f32 beforehand, O cast to bf16" if args.bf16 else ""),
          "card": card, "all_checks_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
