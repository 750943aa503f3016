"""What bounds the serving decode step's paged attention
(``csrc/paged_attention.cu``): the kernel as shipped beside other plans
and variants of its source, built and timed in one process on one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.paged_variants

* Plans: other (ranks, heads) than :func:`repro_torch.kernels.paged_attention.plan`
  picks, passed to the shipped kernel (no rebuild): 1, 2, 3, 4, 6 and 8
  ranks (pages a rank = the table's pages / ranks, rounded up) x 1 and 2
  kv heads a block.
* Source variants, each the shipped source with a constant or a few
  lines replaced, compiled by nvcc into ``build/paged_variants/`` at the
  repository root (all at once, with the port's flags) and swapped in
  under the wrapper: ``stages2`` / ``stages4`` (the ring's depth),
  ``bulk`` (each token's rows staged by one ``cp.async.bulk`` a run,
  completed on a stage's mbarrier, in place of 16-byte ``cp.async``),
  ``chunk128`` (128-row stages, 16 KB of K, with the plan's chunk to
  match), ``pv_unrolled`` (P·V's loop over a warp's rows unrolled, the
  rows past the stage's end read again with p = 0), and
  three diagnostics, not the function: ``no_loads`` (no K/V row, scale or
  block-table page is staged: the launch, the length and query loads, the
  loop over stale shared memory and the merge alone), ``no_compute`` (the
  stages are staged and awaited, but not scored or summed) and ``no_cluster``
  (each rank writes its own normalized partial: no distributed shared
  memory store, no wait for the other ranks).
* Floors, from ``skinny_variants.py``'s kernels: an empty kernel of 128
  blocks as clusters of 1 and 8, with 0–2 cluster barriers, and plain
  reads of 2, 4 and 16 MB.

Cases, int8 pages of 16 tokens, B = 8, Hkv = 8, n_rep = 2, hd = 128:
``chip_smoke.py``'s check shape (seeded lengths <= 511, max_pages 32), the
serving cell's table (max_pages 34, lengths <= 543) and a long context
(lengths <= 4095, max_pages 256). Each variant that computes the function
is held to the plain version (atol 2e-4, tests/test_decode_parity.py:36).
Times are medians of 15 replays of a CUDA graph of 12 calls cycling over
page pools that exceed the L2 twice (flushed before each replay), as
``chip_smoke.py`` times a kernel. One JSON object a line; the card's name
and power limit first and last. Needs one CUDA card and nvcc; imports no
JAX. Exit 0 when every real variant matches.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.skinny_variants import FLOORS, copies, floors, timed
from repro_torch.serve.paging import quantize_kv_pages

VARIANTS = {
    "shipped": [],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "bulk": [("constexpr bool BULK = false;", "constexpr bool BULK = true;")],
    "chunk128": [("constexpr int STAGE_BYTES = 8192;", "constexpr int STAGE_BYTES = 16384;"),
                 ("constexpr int MAX_CHUNK = 64;", "constexpr int MAX_CHUNK = 128;")],
    "pv_unrolled": [("    for (int j = warp; j < rows; j += WARPS) {\n",
                     "#pragma unroll\n    for (int i = 0; i < CHUNK / WARPS; ++i) {\n"
                     "      const int j0 = warp + WARPS * i, j = min(j0, rows - 1);\n"),
                    ("        const float p = sc[r * CHUNK + j];",
                     "        const float p = j0 < rows ? sc[r * CHUNK + j] : 0.f;")],
    "no_loads": [("    if (c < nchunks) {", "    if (false) {")],
    "no_compute": [("    const int n = min(tc, t1 - (t0 + c * tc) + 1);",
                    "    continue;\n    const int n = min(tc, t1 - (t0 + c * tc) + 1);")],
    "no_cluster": [("  if (ranks > 1) cluster_arrive_relaxed();\n", ""),
                   ("  if (ranks > 1) cluster_wait();", ""),
                   ("    else push(&recv[rank * qr * HD + i], landed, o);",
                    "    else out[obase + i] = o / fmaxf(st_l[row], 1e-30f);"),
                   ("  if (ranks == 1) return;", "  return;")],
}
DIAGNOSTIC = ("no_loads", "no_compute", "no_cluster")
#: the wrapper's constants a variant changes with its source (the plan's chunk)
CONSTANTS = {"chunk128": {"STAGE_BYTES": 16384, "MAX_CHUNK": 128}}
B, HKV, N_REP, HD, PAGE = 8, 8, 2, 128, 16
TOL = 2e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(out: Path) -> dict:
    """One library per variant, and the floors, all built at once."""
    source = (_build.CSRC / "paged_attention.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once in paged_attention.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
    (out / "floors.cu").write_text(FLOORS)
    for name in list(VARIANTS) + ["floors"]:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        if name != "floors":
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            usage = [ln.strip() for ln in log.splitlines()
                     if "Used" in ln or ("spill" in ln and not ln.strip().startswith("0 "))]
            emit({"variant": name, "ptxas": usage})
        libs[name] = lib
    return libs


class Case:
    """Seeded int8 decode inputs with enough pool copies to read them cold."""

    def __init__(self, gen: torch.Generator, name: str, lengths: np.ndarray, max_pages: int):
        self.name, self.max_pages = name, max_pages
        rng = np.random.default_rng(0)
        n_pages = B * max_pages + 1
        perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
        bt = np.zeros((B, max_pages), np.int32)
        for b in range(B):
            n = -(-(int(lengths[b]) + 1) // PAGE)
            bt[b, :n] = perm[b * max_pages:b * max_pages + n]
        self.bt = torch.from_numpy(bt).cuda()
        self.lengths = torch.from_numpy(lengths.astype(np.int32)).cuda()
        self.q = torch.randn(B, HKV, N_REP, HD, generator=gen, device="cuda")
        (kq, ks), (vq, vs) = (quantize_kv_pages(torch.randn(n_pages, PAGE, HKV, HD, generator=gen,
                                                            device="cuda")) for _ in range(2))
        self.pools = [(kq, vq, ks, vs)] + [
            tuple(t.clone() for t in (kq, vq, ks, vs))
            for _ in range(copies(2 * (kq.numel() + 4 * ks.numel())) - 1)]
        self.want = ref.paged_attention_ref(self.q, kq, vq, self.bt, self.lengths,
                                            k_scale=ks, v_scale=vs)

    def call(self, pool):
        k, v, ks, vs = pool
        return pa.paged_attention(self.q, k, v, self.bt, self.lengths, k_scale=ks, v_scale=vs)

    def err(self) -> float:
        return float((self.call(self.pools[0]) - self.want).abs().max())

    def ms(self, flush: torch.Tensor) -> float:
        return timed([lambda p=p: self.call(p) for p in self.pools], flush)


def run(cases: list, flush: torch.Tensor) -> dict:
    """max |kernel − plain| and ms a call at each case."""
    return {c.name: {"max_abs_err": c.err(), "ms": c.ms(flush)} for c in cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build(Path(__file__).resolve().parents[3] / "build" / "paged_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [Case(gen, "check_max_pages32", np.random.default_rng(0).integers(1, 512, size=B), 32),
             Case(gen, "serving_max_pages34", np.random.default_rng(1).integers(1, 544, size=B),
                  34),
             Case(gen, "long_max_pages256", np.random.default_rng(2).integers(1, 4096, size=B),
                  256)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    emit({"floors_ms": floors(libs.pop("floors"), flush)})
    ok = True
    # the shipped kernel under other plans
    _build._libs["paged_attention"] = libs["shipped"]
    shipped_plan = pa.plan
    try:
        for heads in (1, 2):
            for ranks in (1, 2, 3, 4, 6, 8):
                def forced(B_, Hkv, n_rep, hd, page, max_pages, kind, sms, ranks=ranks,
                           heads=heads):
                    p = shipped_plan(B_, Hkv, n_rep, hd, page, max_pages, kind, sms)
                    pages = -(-max_pages // ranks)
                    return pa.Plan(-(-max_pages // pages), pages, heads,
                                   p.chunk * p.heads // heads)
                pa.plan = forced
                res = run(cases, flush)
                ok &= all(r["max_abs_err"] <= TOL for r in res.values())
                emit({"plan": {"ranks": ranks, "heads": heads}, **res})
    finally:
        pa.plan = shipped_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"plan": "shipped", **{c.name: shipped_plan(B, HKV, N_REP, HD, PAGE, c.max_pages, 0,
                                                     sms)._asdict() for c in cases}})
    # the source variants, in turns, then in reverse
    order = list(VARIANTS)
    rows = {name: [] for name in order}
    shipped_constants = {k: getattr(pa, k) for k in ("STAGE_BYTES", "MAX_CHUNK")}
    for name in order + order[::-1]:
        _build._libs["paged_attention"] = libs[name]
        for k, v in {**shipped_constants, **CONSTANTS.get(name, {})}.items():
            setattr(pa, k, v)
        pa.plan.cache_clear()
        res = run(cases, flush)
        if name not in DIAGNOSTIC:
            ok &= all(r["max_abs_err"] <= TOL for r in res.values())
        rows[name].append(res)
    for k, v in shipped_constants.items():
        setattr(pa, k, v)
    pa.plan.cache_clear()
    for name in order:
        emit({"variant": name, "diagnostic": name in DIAGNOSTIC, "runs": rows[name]})
    _build._libs["paged_attention"] = libs["shipped"]
    lib_ms = {}
    for c in cases:
        S = c.max_pages * PAGE
        kq, vq, ks, vs = c.pools[0]
        idx = c.bt.long()
        kd = (kq[idx].float() * ks[idx][..., None]).reshape(B, S, HKV, HD)
        vd = (vq[idx].float() * vs[idx][..., None]).reshape(B, S, HKV, HD)
        kd = kd.transpose(1, 2).repeat_interleave(N_REP, dim=1)
        vd = vd.transpose(1, 2).repeat_interleave(N_REP, dim=1)
        qsd = c.q.reshape(B, HKV * N_REP, 1, HD)
        mask = (torch.arange(S, device="cuda")[None, :] <= c.lengths[:, None])[:, None, None, :]
        lib_ms[c.name] = timed([lambda: torch.nn.functional.scaled_dot_product_attention(
            qsd, kd, vd, attn_mask=mask)], flush)
        del kd, vd
    emit({"library": "scaled_dot_product_attention over dense f32 KV gathered beforehand",
          "ms": lib_ms})
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
