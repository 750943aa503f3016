"""What bounds ``quant_matmul``'s tiled path (``qmm_mma`` in
``src/repro_torch/kernels/csrc/quant_matmul.cu``): the kernel as shipped
beside variants of its source, built and timed in one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.qmm_variants

Each variant is the shipped source with a few constants or lines replaced,
compiled by nvcc into ``build/qmm_variants/`` at the repository root (all
at once, with the port's flags) and swapped in under the ``quant_matmul``
wrapper:

* ``shipped``: the source as it is (64 x 128 tiles of 4 warps, two blocks
  an SM).
* ``bm128``: 128 x 128 tiles of 8 warps, one block an SM.
* ``one_product``, ``no_mma``: diagnostics, not the function: only the
  hi·codes product, or no MMA at all (the loads, the x·s split, the code
  conversion, ldmatrix and the epilogue alone). Their times less the
  shipped one's split the loop into the tensor cores' share and the
  operand staging's.

The variants that compute the function are held to the plain version (atol
1e-3 + rtol 1e-4, int8 and int4, the prefill shapes and two ragged ones)
and to bit-equal reruns. Times are CUDA-event medians of 5 runs of 10
calls (L2 flushed before each run) at the seven projections' (K, N) of
internlm2-1.8b, M = 4096 and 2048, the variants in turns and then in
reverse, beside ``torch.matmul`` on the pre-dequantized f32 weight. One
JSON object a line; the card's name and power limit first. Needs one CUDA
card and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.quantization import dequantize, quantize
from repro_torch.kernels import _build, ref
from repro_torch.kernels import quant_matmul as qmm

VARIANTS = {
    "shipped": [],
    "bm128": [("WARPS_M = 2, WARPS_N = 2;", "WARPS_M = 4, WARPS_N = 2;")],
    "one_product": [("for (int i = TERMS - 1; i >= 0; --i)", "for (int i = 0; i >= 0; --i)")],
    "no_mma": [("for (int ni = 0; ni < NI; ++ni) mma_bf16(part[ni], af[i], bf[ni]);", "{}")],
}
DIAGNOSTIC = ("one_product", "no_mma")
TIMED = [(M, K, N) for M in (4096, 2048)
         for K, N in ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))]
CHECKED = [(M, K, N, bits) for M, K, N in TIMED[:4] + [(1001, 1000, 384), (37, 998, 384)]
           for bits in (8, 4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(out: Path) -> dict:
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in quant_matmul.cu")
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
                entry = "qmm_mma<4>" if "qmm_mmaILi4E" in line else (
                    "qmm_mma<8>" if "qmm_mmaILi8E" in line else "")
            elif entry and ("Used" in line or "spill" in line):
                report.append(f"{entry}: {line.strip()}")
        emit({"variant": name, "ptxas": report})
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def use(lib) -> None:
    """Route the ``quant_matmul`` wrapper to ``lib``."""
    _build._libs["quant_matmul"] = lib


def median_ms(fn, flush: torch.Tensor, calls: int = 10, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("qmm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": card, "torch": torch.__version__})
    libs = build(_build.BUILD_DIR.parent / "qmm_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for M, K, N, bits in sorted(set(CHECKED) | {(M, K, N, 8) for M, K, N in TIMED}):
        x = torch.randn(M, K, generator=gen, device="cuda")
        w = quantize(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5, bits)
        data[(M, K, N, bits)] = (x, w, ref.quant_matmul_ref(x, w.q, w.scale, bits))
    ok = True
    for name, lib in libs.items():
        if name in DIAGNOSTIC:
            continue
        use(lib)
        for M, K, N, bits in CHECKED:
            x, w, want = data[(M, K, N, bits)]
            got = qmm.quant_matmul(x, w.q, w.scale, bits=bits)
            chk = float(((got - want).abs() - 1e-4 * want.abs()).max())
            equal = bool(torch.equal(got, qmm.quant_matmul(x, w.q, w.scale, bits=bits)))
            ok &= chk <= 1e-3 and equal
            emit({"variant": name, "M": M, "K": K, "N": N, "bits": bits,
                  "max_abs_err": float((got - want).abs().max()), "check": chk,
                  "tol": "atol 1e-3 + rtol 1e-4", "bit_equal": equal})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    times = {name: {s: [] for s in TIMED} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for s in TIMED:
            x, w, _ = data[s + (8,)]
            times[name][s].append(median_ms(lambda: qmm.quant_matmul(x, w.q, w.scale), flush))
    for name in libs:
        emit({"variant": name, "computes_the_function": name not in DIAGNOSTIC,
              "ms_in_turns": {f"M={M} K={K} N={N}": v for (M, K, N), v in times[name].items()}})
    library = {}
    for M, K, N in TIMED:
        x, w, _ = data[(M, K, N, 8)]
        wf = dequantize(w)
        library[f"M={M} K={K} N={N}"] = median_ms(lambda: torch.matmul(x, wf), flush)
    emit({"library_ms": library, "library": "torch.matmul on the pre-dequantized f32 weight",
          "card": card, "all_checks_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
