"""What bounds ``flash_attention``'s tensor-core loop (``flash_fwd_mma`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``): the kernel as shipped
beside variants of its source, built and timed in one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_variants

Each variant is the shipped source with a few constants or lines replaced,
compiled by nvcc into ``build/flash_variants/`` at the repository root (all
at once, with the port's flags) and swapped in under the
``flash_attention`` wrapper:

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

The variants that compute the function are held to the plain version
(atol 3e-5) at the prefill shape, causal, with window 128 and soft-cap 30,
and at S = 1001 (hd 64 and 128, grouped and not, causal and not), and to
bit-equal reruns. Times are CUDA-event medians of 5 replays of a CUDA
graph of 10 calls (L2 flushed before each replay) at the prefill shape
(B·H = 8·16 over 8·8 KV heads, S = 512, hd = 128, causal) and the epoch-1
step's (B·H = 4·16), the variants in turns and then in reverse, beside
SDPA with the KV heads repeated beforehand. One JSON object a line; the
card's name and power limit first. Needs one CUDA card and nvcc; imports
no JAX.
"""

from __future__ import annotations

import ctypes
import json
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
}
DIAGNOSTIC = ("split_only", "no_mma")
TIMED = {"prefill": (8, 16, 8), "training": (4, 16, 8)}  # (B, H, Hkv) at S = 512, hd = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(out: Path) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
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
                entry = next((f"flash_fwd_mma<{hd}>" for hd in fa.HEAD_DIMS
                              if f"flash_fwd_mmaILi{hd}E" in line), "")
            elif entry and ("Used" in line or "spill" in line):
                report.append(f"{entry}: {line.strip()}")
        emit({"variant": name, "ptxas": report})
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


def inputs(gen: torch.Generator, BH: int, BHkv: int, S: int, hd: int):
    return tuple(torch.randn(n, S, hd, generator=gen, device="cuda") for n in (BH, BHkv, BHkv))


def checks(name: str, data: dict) -> bool:
    """``name``'s largest |Δ| against the plain version over the checked
    cases, and whether two calls at the prefill shape are bit-equal."""
    errs = {}
    for key, (q, k, v) in data.items():
        options = ([{}, {"window": 128, "attn_softcap": 30.0}] if key == "prefill" else
                   [{"causal": c, "window": w, "attn_softcap": cap} for c in (True, False)
                    for w in (None, 32) for cap in (None, 30.0)])
        errs[key] = max(float((fa.flash_attention(q, k, v, **kw)
                               - ref.flash_attention_ref(q, k, v, **kw)).abs().max())
                        for kw in options)
    q, k, v = data["prefill"]
    equal = bool(torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)))
    ok = equal and all(e <= 3e-5 for e in errs.values())
    emit({"variant": name, "max_abs_err": errs, "tol": "atol 3e-5", "bit_equal": equal})
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__})
    libs = build(_build.BUILD_DIR.parent / "flash_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {at: inputs(gen, B * H, B * Hkv, 512, 128) for at, (B, H, Hkv) in TIMED.items()}
    checked = {"prefill": timed["prefill"]}
    for hd in (64, 128):
        for n_rep in (1, 2):
            checked[f"S=1001 hd={hd} n_rep={n_rep}"] = inputs(gen, 4 * n_rep, 4, 1001, hd)
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
        emit({"variant": name, "computes_the_function": name not in DIAGNOSTIC,
              "ms_in_turns": times[name]})
    library = {}
    for at, (B, H, Hkv) in TIMED.items():
        q, k, v = (t.reshape(B, -1, 512, 128) for t in timed[at])
        k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        library[at] = graph_ms(lambda q=q, k=k, v=v: torch.nn.functional.
                               scaled_dot_product_attention(q, k, v, is_causal=True), flush)
    emit({"library_ms": library, "library": "scaled_dot_product_attention, causal, KV heads "
          "repeated beforehand", "card": card, "all_checks_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
