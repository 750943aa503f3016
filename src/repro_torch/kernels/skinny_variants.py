"""What bounds the decode path's GEMV (``csrc/skinny.cuh``, the T <= 8
path of ``adapter_fuse`` and the M <= 8 path of ``quant_matmul``): the
kernel as shipped beside other plans and variants of its source, built
and timed in one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.skinny_variants

* Plans: other (ranks, tile columns) than :func:`repro_torch.kernels.skinny.plan`
  picks, passed to the shipped kernel (no rebuild): ranks 1, 2, 4, 8 x
  tiles of 4 to 128 columns (at least a lane's vector), narrower than
  the plan's 64-byte rows too.
* Source variants, each the shipped header with a few constants or lines
  replaced, compiled by nvcc into ``build/skinny_variants/`` at the
  repository root with the two sources that include it (all at once, with
  the port's flags) and swapped in under the wrappers:
  ``batch4`` / ``batch16`` (rows a lane loads before their FMAs),
  ``one_block`` (one block an SM: up to 255 registers), and two
  diagnostics, not the function: ``no_loads`` (no weight row is read: the
  launch, the x staging and the reduce alone) and ``no_cluster`` (each
  block keeps its own slice's sums: no distributed shared memory store,
  no wait for the other ranks).

* Floors, from three small kernels of this script's own (``FLOORS``): an
  empty kernel of 128 blocks launched as clusters of 1 and 8, the same
  with one and two cluster barriers, and a plain read of 2, 4 and 16 MB
  (16-byte loads, 8 a thread in flight, 264 blocks): what a launch, a
  barrier and the bytes alone cost.

The variants that compute the function are held to the plain version
(adapter_fuse atol 1e-4; quant_matmul atol 1e-3 + rtol 1e-4). Times are
medians of 15 replays of a CUDA graph of 12 calls cycling over input
copies that exceed the L2 twice (flushed before each replay), as
``chip_smoke.py`` times a kernel: adapter_fuse at T = 1, d = 2048,
d_a = 256 (f32), and one internlm2-1.8b layer's seven int8 projections
at M = 1 and M = 8 (times summed), beside ``torch.addmm`` /
``torch.matmul`` on the pre-dequantized f32 weight. One JSON object a
line; the card's name and power limit first. Needs one CUDA card and
nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.quantization import dequantize, quantize
from repro_torch.kernels import _build, ref, skinny
from repro_torch.kernels.adapter_fuse import adapter_fuse
from repro_torch.kernels.quant_matmul import quant_matmul

VARIANTS = {
    "shipped": [],
    "batch4": [("constexpr int BATCH = 8;", "constexpr int BATCH = 4;")],
    "batch16": [("constexpr int BATCH = 8;", "constexpr int BATCH = 16;")],
    "one_block": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")],
    "no_loads": [("if (kk < nr && n < N) {", "if (false) {")],
    "no_cluster": [("push(&recv[rank * share + (o - owner * share)], &landed, owner, v);",
                    "recv[o] = v;"),
                   ("  bar_wait(&landed);", "  __syncthreads();"),
                   ("for (int q = 0; q < ranks; ++q) v += recv[q * share + j];",
                    "v = recv[o];")],
}
DIAGNOSTIC = ("no_loads", "no_cluster")
SOURCES = ("adapter_fuse", "quant_matmul")
LAYER = [(2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048), (2048, 8192), (2048, 8192),
         (8192, 2048)]  # one internlm2-1.8b layer's projections, (K, N)
CALLS, REPEATS = 12, 15
FLOORS = r"""
#include <cuda_runtime.h>
template <int BARRIERS>
__global__ void __launch_bounds__(256) barriers(float* out) {
  for (int i = 0; i < BARRIERS; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && out) out[0] = 1.f;
}
__global__ void __launch_bounds__(256) stream_read(const uint4* __restrict__ p, long long n16,
                                                   float* out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  unsigned acc = 0;
  for (long long i = tid; i < n16; i += 8 * step) {
    uint4 v[8];
    for (int u = 0; u < 8; ++u) v[u] = i + u * step < n16 ? __ldg(p + i + u * step) : uint4{};
    for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x12345678u) out[0] = 1.f;  // keeps the loads
}
extern "C" int floor_barriers(int n, int cluster, void* out, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 128 / cluster, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (n == 0) return (int)cudaLaunchKernelEx(&cfg, barriers<0>, (float*)out);
  if (n == 1) return (int)cudaLaunchKernelEx(&cfg, barriers<1>, (float*)out);
  return (int)cudaLaunchKernelEx(&cfg, barriers<2>, (float*)out);
}
extern "C" int floor_read(const void* p, long long nbytes, void* out, void* stream) {
  stream_read<<<264, 256, 0, (cudaStream_t)stream>>>((const uint4*)p, nbytes / 16, (float*)out);
  return (int)cudaGetLastError();
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(out: Path) -> dict:
    """One directory per variant with the edited header, both sources and
    the other headers; both libraries of every variant built at once."""
    header = (_build.CSRC / "skinny.cuh").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = header
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in skinny.cuh")
            text = text.replace(old, new)
        vdir = out / name
        vdir.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, vdir / f.name)
        (vdir / "skinny.cuh").write_text(text)
        for src in SOURCES:
            shutil.copy(_build.CSRC / f"{src}.cu", vdir / f"{src}.cu")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(vdir / f"{src}.so"),
                   str(vdir / f"{src}.cu")]
            procs[(name, src)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    (out / "floors.cu").write_text(FLOORS)
    procs[("floors", "floors")] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / "floors.so"),
         str(out / "floors.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{src}:\n{log}")
        if name == "floors":
            libs[name] = ctypes.CDLL(str(out / "floors.so"))
            continue
        entry, spills = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "spill stores" in line and "gemv" in entry and not line.strip().startswith("0 "):
                spills.append(f"{entry[entry.find('gemv'):][:40]}: {line.strip()}")
        emit({"variant": name, "source": src, "ptxas_spills": spills})
        lib = ctypes.CDLL(str(out / name / f"{src}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs.setdefault(name, {})[src] = lib
    return libs


def use(libs: dict) -> None:
    """Route both wrappers to a variant's libraries (their argtypes are
    set on first call)."""
    for src, lib in libs.items():
        _build._libs[src] = lib


def timed(fns: list, flush: torch.Tensor) -> float:
    """Device ms a call: CALLS calls cycling over ``fns`` in one CUDA
    graph, median of REPEATS replays, L2 flushed before each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(CALLS):
            fns[i % len(fns)]()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    del graph
    return statistics.median(times)


def copies(nbytes: int) -> int:
    return max(1, -(-(128 << 20) // nbytes))


class Cases:
    """Seeded inputs: adapter_fuse at T = 1, and a layer's projections at
    M = 1 and 8, each with enough weight copies to read them cold."""

    def __init__(self, gen: torch.Generator):
        d, da = 2048, 256
        self.b = torch.randn(1, d, generator=gen, device="cuda")
        self.a = torch.randn(1, da, generator=gen, device="cuda")
        self.lam = torch.tensor(0.5, device="cuda")
        self.ws = [torch.randn(d, da, generator=gen, device="cuda") * d ** -0.5
                   for _ in range(copies(4 * d * da))]
        self.qmm = {}
        for K, N in sorted(set(LAYER)):
            w = [quantize(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5, 8)
                 for _ in range(copies(K * N))]
            xs = {M: torch.randn(M, K, generator=gen, device="cuda") for M in (1, 8)}
            self.qmm[(K, N)] = (w, xs, [dequantize(c) for c in w[:copies(4 * K * N)]])

    def check(self) -> float:
        """max |kernel − plain| over the cases, each within its tolerance."""
        got = adapter_fuse(self.b, self.ws[0], self.a, self.lam)
        want = ref.adapter_fuse_ref(self.b, self.ws[0], self.a, self.lam)
        err = float((got - want).abs().max())
        if err > 1e-4:
            raise AssertionError(f"adapter_fuse: {err}")
        for (K, N), (w, xs, _) in self.qmm.items():
            for x in xs.values():
                got = quant_matmul(x, w[0].q, w[0].scale)
                want = ref.quant_matmul_ref(x, w[0].q, w[0].scale)
                if float(((got - want).abs() - 1e-4 * want.abs()).max()) > 1e-3:
                    raise AssertionError(f"quant_matmul M={x.shape[0]} K={K} N={N}")
                err = max(err, float((got - want).abs().max()))
        return err

    def times(self, flush: torch.Tensor) -> dict:
        t = {"adapter_fuse_T1": timed([lambda w=w: adapter_fuse(self.b, w, self.a, self.lam)
                                       for w in self.ws], flush)}
        for M in (1, 8):
            per = {KN: timed([lambda c=c, x=xs[M]: quant_matmul(x, c.q, c.scale) for c in w],
                             flush) for KN, (w, xs, _) in self.qmm.items()}
            t[f"quant_matmul_layer_M{M}"] = sum(per[KN] for KN in LAYER)
        return t

    def library(self, flush: torch.Tensor) -> dict:
        t = {"adapter_fuse_T1": timed([lambda w=w: torch.addmm(self.a, self.b, w, beta=0.5,
                                                                alpha=0.5) for w in self.ws],
                                      flush)}
        for M in (1, 8):
            per = {KN: timed([lambda c=c, x=xs[M]: torch.matmul(x, c) for c in wf], flush)
                   for KN, (_, xs, wf) in self.qmm.items()}
            t[f"quant_matmul_layer_M{M}"] = sum(per[KN] for KN in LAYER)
        return t


def floors(lib, flush: torch.Tensor) -> dict:
    """Device ms a call of the FLOORS kernels, timed as the GEMV is."""
    lib.floor_barriers.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.floor_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")

    def call(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"floor kernel: CUDA error {rc}")

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    t = {}
    for cluster in (1, 8):
        for n in (0, 1, 2):
            t[f"cluster{cluster}_barriers{n}"] = timed(
                [lambda n=n, c=cluster: call(lib.floor_barriers(n, c, out.data_ptr(), stream()))],
                flush)
    for mb in (2, 4, 16):
        bufs = [torch.empty(mb << 20, dtype=torch.uint8, device="cuda")
                for _ in range(copies(mb << 20))]
        t[f"read_{mb}MB"] = timed([lambda b=b: call(lib.floor_read(b.data_ptr(), b.numel(),
                                                                    out.data_ptr(), stream()))
                                   for b in bufs], flush)
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("skinny_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(Path(__file__).resolve().parents[3] / "build" / "skinny_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = Cases(gen)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    emit({"floors_ms": floors(libs.pop("floors"), flush)})
    ok = True
    # the shipped kernel under other plans
    use(libs["shipped"])
    shipped_plan = skinny.plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for ranks in (1, 2, 4, 8):
            for cols in (4, 8, 16, 32, 64, 128):
                def forced(M, K, N, bits, sms_, ranks=ranks, cols=cols):
                    p = shipped_plan(M, K, N, bits, sms_)
                    return p._replace(ranks=min(ranks, K), cols=max(cols, p.lane))
                skinny.plan = forced
                err = cases.check()
                emit({"plan": {"ranks": ranks, "min_cols": cols}, "max_abs_err": err,
                      "ms": cases.times(flush)})
    finally:
        skinny.plan = shipped_plan
    emit({"plan": "shipped", "adapter_fuse_T1": shipped_plan(1, 2048, 256, 32, sms),
          "quant_matmul_M1_2048x2048": shipped_plan(1, 2048, 2048, 8, sms),
          "quant_matmul_M8_2048x2048": shipped_plan(8, 2048, 2048, 8, sms)})
    # the source variants, in turns, then in reverse
    order = list(VARIANTS)
    rows = {name: [] for name in order}
    for name in order + order[::-1]:
        use(libs[name])
        try:
            err = cases.check()
        except AssertionError as e:
            if name not in DIAGNOSTIC:
                ok = False
            err = f"mismatch: {e}"
        rows[name].append({"max_abs_err": err, "ms": cases.times(flush)})
    for name in order:
        emit({"variant": name, "diagnostic": name in DIAGNOSTIC, "runs": rows[name]})
    use(libs["shipped"])
    emit({"library": "torch.addmm / torch.matmul, f32 weight", "ms": cases.library(flush)})
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
