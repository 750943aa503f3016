"""The port's launch-layer pricing against the JAX reference's.

* ``INPUT_SHAPES`` equal the reference's, field by field;
* the op-level pricer (``repro_torch.launch.op_cost``) on programs of
  known cost, the twins of ``tests/test_hlo_cost.py`` where they apply,
  and the kernel units at the bytes ``chip_smoke.py`` charges them;
* ``build_case`` + ``analyze`` on reduced configs at B 2 x S 64 against
  ``repro.launch.specs.build_case`` + ``repro.launch.roofline.analyze``
  on a 1x1 mesh: ``model_flops_total`` equal, FLOPs within
  ``FLOPS_RTOL`` once three differences of program are taken out (see
  :func:`_adjusted`); bytes are not compared (the port prices its
  kernels' boundaries, the reference XLA's fusions);
* full width and depth on meta: notes and model FLOPs against the
  reference's closed forms;
* the dry run's CLI.

The layout bytes (dp 2 x stages 2 against ``EdgeMesh.stats`` on gloo)
are held in ``tests/test_torch_distributed.py``, inside its spawn.
"""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch
from repro_torch.core.parallel_adapters import adapter_param_count
from repro_torch.core.quantization import QTensor
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.costs import price_case
from repro_torch.launch.dryrun import ASSIGNED, run_case
from repro_torch.launch.op_cost import price
from repro_torch.launch.roofline import RooflineTerms, analyze
from repro_torch.launch.specs import SERVE_WINDOW, build_case

REPO = Path(__file__).resolve().parents[1]
META = torch.device("meta")
#: FLOPs of the port's priced step against the reference's HLO count,
#: once the three differences of :func:`_adjusted` are out: measured
#: 0.93–0.99 on these cases (PERF.md)
FLOPS_RTOL = 0.10


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Shapes and constants
# ---------------------------------------------------------------------------


def test_input_shapes_match_the_reference():
    from repro.configs.base import INPUT_SHAPES as REF

    assert list(INPUT_SHAPES) == list(REF)
    for name, ref in REF.items():
        mine = INPUT_SHAPES[name]
        assert (mine.name, mine.seq_len, mine.global_batch, mine.mode) == (
            ref.name, ref.seq_len, ref.global_batch, ref.mode)


def test_roofline_constants_are_the_h100s():
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.PEAK_FLOPS_F32 == 67e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.LINK_BW == 450e9


def test_serving_window_and_assigned_archs_match_the_reference():
    from repro.launch import specs as ref_specs

    src = (REPO / "src" / "repro" / "launch" / "dryrun.py").read_text()
    ref_assigned = re.findall(r'^\s+"([\w.\-]+)",$', src.split("ASSIGNED = [")[1].split("]")[0],
                              re.M)
    assert SERVE_WINDOW == ref_specs.SERVE_WINDOW
    assert ASSIGNED == ref_assigned


# ---------------------------------------------------------------------------
# Known-cost programs (the twins of tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------


def test_a_python_loop_is_charged_every_iteration():
    d = 64
    h, w = _m(4, d), _m(d, d)

    def loop(h):
        for _ in range(10):
            h = h @ w
        return h

    _, cost, _ = price(loop, h)
    assert cost.flops == 10 * 2 * 4 * d * d
    assert cost.product_flops == cost.flops
    assert cost.bytes == 10 * 4 * (4 * d + d * d + 4 * d)


@pytest.mark.parametrize("B,M,K,N", [(3, 5, 7, 11), (2, 16, 32, 8)])
def test_batched_products_are_charged_2bmkn(B, M, K, N):
    _, cost, _ = price(torch.bmm, _m(B, M, K), _m(B, K, N))
    assert cost.flops == 2 * B * M * K * N
    _, cost, _ = price(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), _m(B, M, K), _m(B, K, N))
    assert cost.product_flops == 2 * B * M * K * N


def test_an_embedding_lookup_is_charged_twice_its_result():
    table, idx = _m(1000, 32), _m(2, 5, dtype=torch.int64)
    for fn in (lambda: table[idx], lambda: torch.nn.functional.embedding(idx, table),
               lambda: table.index_select(0, idx.reshape(-1))):
        _, cost, _ = price(fn)
        assert cost.bytes == 2 * 2 * 5 * 32 * 4  # not the 128 KB table
        assert cost.flops == 0


def test_a_slice_write_is_charged_twice_the_update():
    buf, x, pos = _m(100, 32), _m(2, 32), _m(2, dtype=torch.int64)

    def slice_write():
        buf[2:4] = x

    def index_put():
        buf[pos] = x

    for fn in (slice_write, index_put):
        _, cost, _ = price(fn)
        assert cost.bytes == 2 * 2 * 32 * 4  # not the 12.8 KB buffer


def test_a_view_is_charged_nothing():
    buf = _m(100, 32)
    _, cost, _ = price(lambda: buf.view(50, 64).transpose(0, 1)[3:7].unsqueeze(0).expand(2, -1, -1))
    assert (cost.flops, cost.bytes) == (0, 0)


def test_an_elementwise_op_is_charged_an_op_an_element_and_a_broadcast_once():
    x, row = _m(8, 16), _m(16)
    _, cost, _ = price(torch.add, x, row.expand(8, 16))
    assert cost.flops == 8 * 16
    assert cost.bytes == 4 * (8 * 16 + 16 + 8 * 16)


def test_memoized_ops_are_charged_as_run():
    """The pricer reuses an op's output shape and charge for the same
    shapes: a loop that repeats ops costs its iterations exactly."""
    x = _m(4, 8)

    def many(x):
        for _ in range(7):
            x = torch.tanh(x) * 2.0
        return x

    out, cost, pricer = price(many, x)
    assert out.shape == (4, 8) and out.device == META
    assert cost.flops == 7 * 2 * 32
    assert len(pricer._memo) == 2


def _qtensor(K, N, bits=8):
    return QTensor(_m(K, N if bits == 8 else N // 2, dtype=torch.int8), _m(K, N // 128), bits,
                   128, N)


@pytest.mark.parametrize("M,K,N,bits", [(8, 256, 384, 8), (8, 2048, 2048, 8),
                                        (4096, 2048, 8192, 8), (8, 2048, 2048, 4)])
def test_a_quant_matmul_unit_is_charged_its_boundary(M, K, N, bits):
    """Codes, scales, x and y (``chip_smoke.qmm_case``'s nbytes) and
    2·M·K·N FLOPs, not the dequantized weight."""
    from repro_torch.kernels import ops

    w = _qtensor(K, N, bits)
    _, cost, pricer = price(ops.quant_matmul, _m(M, K), w)
    assert cost.flops == cost.product_flops == 2 * M * K * N
    assert cost.bytes == M * K * 4 + w.q.numel() + w.scale.numel() * 4 + M * N * 4
    assert pricer.unit_calls == {"quant_matmul": 1}


def test_a_flash_unit_is_charged_q_k_v_and_its_output():
    from repro_torch.kernels import ops

    B, H, Hkv, S, hd = 2, 4, 2, 64, 32
    q, k, v = _m(B, H, S, hd), _m(B, Hkv, S, hd), _m(B, Hkv, S, hd)
    _, cost, pricer = price(ops.flash_attention, q, k, v)
    assert pricer.units["flash_attention"].bytes == 4 * (2 * q.numel() + k.numel() + v.numel())
    assert pricer.units["flash_attention"].flops == 4 * B * H * S * S * hd  # the plain square


def test_a_paged_unit_is_charged_the_pages_its_tables_name():
    """At full lengths (every table slot attended) the unit's bytes are
    ``chip_smoke.paged_bound``'s."""
    from repro_torch.kernels.paged_attention import paged_attention

    B, Hkv, n_rep, hd, page, max_pages, n_pages = 8, 8, 2, 128, 16, 34, 300
    q = _m(B, Hkv, n_rep, hd)
    kq, vq = (_m(n_pages, page, Hkv, hd, dtype=torch.int8) for _ in range(2))
    ks, vs = _m(n_pages, page, Hkv), _m(n_pages, page, Hkv)
    bt, lengths = _m(B, max_pages, dtype=torch.int32), _m(B, dtype=torch.int32)
    _, cost, pricer = price(paged_attention, q, kq, vq, bt, lengths, k_scale=ks, v_scale=vs)
    tokens = B * max_pages * page
    want = (tokens * Hkv * 2 * (hd + 4) + 2 * B * Hkv * n_rep * hd * 4 + 4 * B * max_pages
            + 4 * B)
    assert pricer.units["paged_attention"].bytes == want
    assert pricer.units["paged_attention"].flops == 4.0 * n_rep * hd * Hkv * tokens


def test_units_at_the_smokes_kernel_shapes():
    """The training and personal kernels' units at ``chip_smoke.py``'s
    shapes (T = 4·512, d 2048, d_a 256, V 92544, int8 entries) against
    the nbytes its bounds charge: ``adapter_fuse`` equal; the mixes 4
    bytes more (λ, which the kernels read and the smoke leaves out);
    ``ce_fwd`` equal; ``ce_bwd`` 4·T bytes less (the smoke charges a
    fourth T-vector beside labels, lse and g)."""
    from repro_torch.kernels import cached_mix, lmhead_ce, ops

    T, d, da, V = 4 * 512, 2048, 256, 92544
    ent = QTensor(_m(T, d, dtype=torch.int8), _m(T, d // 128), 8, 128, d)
    ent_bytes = T * d + T * (d // 128) * 4
    w, a, g, lam = _m(d, da), _m(T, da), _m(T, da), _m()

    def unit(fn, *args):
        (name, c), = price(fn, *args)[2].units.items()
        return c.bytes

    assert unit(cached_mix.mix_fwd, ent, w, a, lam) == ent_bytes + 4 * (d * da + 3 * T * da) + 4
    assert unit(cached_mix.mix_dw, ent, g, lam, d) == ent_bytes + 4 * (T * da + d * da) + 4
    h, head, labels, vec = _m(T, d), _m(d, V), _m(T, dtype=torch.int32), _m(T)
    assert unit(lmhead_ce.ce_fwd, h, head, labels) == 4.0 * (T * d + d * V + 3 * T)
    assert unit(lmhead_ce.ce_bwd, h, head, labels, vec, vec) == 4.0 * (2 * T * d + d * V + 3 * T)
    for T1 in (1, 8):
        assert unit(ops.adapter_fuse, _m(T1, d), w, _m(T1, da), lam) == (
            T1 * d * 4 + d * da * 4 + 2 * T1 * da * 4 + 4)


def test_training_units_price_forward_and_backward_apart():
    """The cached step's mix and CE run as units forward and backward:
    ``ce_bwd`` recomputes the logits (4·T·d·V), ``mix_dw`` is
    2·T·d·d_a, each charged once a call."""
    cfg = get_arch("internlm2-1.8b").reduced()
    case = build_case(cfg, InputShape("t", 64, 2, "train"), technique="pac_cached",
                      quant_bits=8, tap_policy="int8")
    pricer = case.price()[0]
    T, d, V = 2 * 64, cfg.d_model, cfg.vocab
    da = int(case.args[1]["downs"].shape[-1])
    assert pricer.unit_calls == {"mix_fwd": cfg.n_periods + 1, "mix_dw": cfg.n_periods + 1,
                                 "ce_fwd": 1, "ce_bwd": 1}
    assert pricer.units["ce_fwd"].flops == 2 * T * d * V
    assert pricer.units["ce_bwd"].flops == 4 * T * d * V
    assert pricer.units["mix_dw"].flops == (cfg.n_periods + 1) * 2 * T * d * da
    assert price_case(case).flops == pricer.cost.flops


def test_serving_cells_price_the_kernels_the_card_launches():
    """The roofline's serving cells at full internlm2-1.8b width: each
    priced unit a launch the smoke counts on those paths (a prefill and
    a decode step: 168 ``quant_matmul`` with 24 flash or paged; a
    personal step: 168 ``quant_matmul`` and 24 ``adapter_fuse``)."""
    from repro_torch.launch.specs import (engine_decode_case, engine_prefill_case,
                                          personal_decode_case)

    cfg = get_arch("internlm2-1.8b")
    cells = {
        "prefill": (engine_prefill_case(cfg, batch=8, prompt_pad=512, page=16, max_len=544,
                                        n_users=4), "flash_attention"),
        "decode": (engine_decode_case(cfg, batch=8, page=16, max_len=544, n_users=4),
                   "paged_attention"),
        "personal": (personal_decode_case(cfg, max_len=64), "adapter_fuse")}
    for name, (case, other) in cells.items():
        pricer = case.price()[0]
        assert pricer.unit_calls == {"quant_matmul": 7 * 24, other: 24}, name
        assert case.note.startswith("int8")
        terms = analyze(pricer.cost, arch=cfg.name, shape=case.shape, technique="pac",
                        n_active_params=cfg.active_param_count())
        assert terms.bottleneck == "memory" and terms.t_memory > 0, name


# ---------------------------------------------------------------------------
# Against the reference's pricer
# ---------------------------------------------------------------------------


def _ref_dynamic_slice_flops(hlo_text: str) -> float:
    """The FLOPs the reference's pricer charges for ``dynamic-slice``
    instructions (1 an element, trip counts applied): its scan slicing a
    period's weights out of the stacked blocks, which the port indexes
    as views."""
    from repro.launch import hlo_cost as H

    comps, memo = H.parse_module(hlo_text), {}

    def elements(inst):
        return math.prod(H._first_shape(inst.result_segment)[1] or [1])

    def cost(comp):
        if comp.name not in memo:
            tot = 0.0
            for inst in comp.instructions:
                if inst.opcode == "while":
                    trip = H._while_trip(inst, comps)
                    for rx in (H._BODY_RE, H._COND_RE):
                        m = rx.search(inst.line)
                        if m and m.group(1) in comps:
                            tot += cost(comps[m.group(1)]) * trip
                elif inst.opcode in ("call", "conditional", "async-start"):
                    for c in H._CALLS_RE.findall(inst.line) + re.findall(
                            r"(?:branch_computations|to_apply)=\{?%?([\w.\-]+)", inst.line):
                        if c in comps:
                            tot += cost(comps[c])
                elif inst.opcode == "fusion":
                    m = H._CALLS_RE.search(inst.line)
                    called = comps.get(m.group(1)) if m else None
                    tot += sum(elements(ci) for ci in (called.instructions if called else [])
                               if ci.opcode == "dynamic-slice")
                elif inst.opcode == "dynamic-slice":
                    tot += elements(inst)
            memo[comp.name] = tot
        return memo[comp.name]

    entry = next(line.strip() for line in hlo_text.splitlines()
                 if line.strip().startswith("ENTRY"))
    return cost(comps[H._COMP_HEADER_RE.match(entry).group(2)])


def _adjusted(port_pricer, ref_flops, ref_hlo, cfg, shape):
    """(port FLOPs, reference FLOPs) without the three differences of
    program between the two, each known exactly:

    * the port's ``ce_bwd`` recomputes the logits (the card's kernel
      does; the reference's plain VJP keeps them): half its unit's FLOPs;
    * the reference's scan slices each period's weights out of the
      stacked blocks (``dynamic-slice``, 1 FLOP an element in its
      pricer); the port takes views;
    * the reference's ``prefill_step`` computes every position's logits
      and keeps the last (``steps.py:498``); the port's computes the
      last's only: 2·B·(S−1)·d·V."""
    port = port_pricer.cost.flops
    if "ce_bwd" in port_pricer.units:
        port -= port_pricer.units["ce_bwd"].flops / 2
    ref = ref_flops - _ref_dynamic_slice_flops(ref_hlo)
    if shape.mode == "prefill":
        ref -= 2.0 * shape.global_batch * (shape.seq_len - 1) * cfg.d_model * cfg.vocab
    return port, ref


REF_CASES = [(a, t, m) for a in ("internlm2-1.8b", "mixtral-8x7b", "qwen2-vl-7b")
             for t, m in (("pac", "train"), ("pac_cached", "train"), ("pac", "prefill"),
                          ("pac", "decode"))] + [("xlstm-125m", "pac", "decode")]


@pytest.mark.parametrize("arch,technique,mode", REF_CASES)
def test_priced_step_matches_the_reference(arch, technique, mode):
    from repro.configs import InputShape as RefShape
    from repro.configs import get_arch as ref_arch
    from repro.core.parallel_adapters import adapter_param_count as ref_adapter_count
    from repro.launch import mesh as ref_mesh
    from repro.launch.roofline import analyze as ref_analyze
    from repro.launch.specs import build_case as ref_build

    cfg, rcfg = get_arch(arch).reduced(), ref_arch(arch).reduced()
    shape, rshape = InputShape("t", 64, 2, mode), RefShape("t", 64, 2, mode)
    mesh = ref_mesh.make_mesh((1, 1), ("data", "model"))
    rcase = ref_build(rcfg, rshape, mesh, technique=technique)
    with mesh:
        compiled = rcase.lower().compile()
    n_ad = ref_adapter_count(rcfg) if technique.startswith("pac") else 0
    want = ref_analyze(compiled, arch=arch, shape=rshape, mesh=mesh, technique=technique,
                       note=rcase.note, n_active_params=rcfg.active_param_count(),
                       n_adapter_params=n_ad)

    case = build_case(cfg, shape, technique=technique)
    pricer = case.price()[0]
    n_ad_port = adapter_param_count(cfg) if technique.startswith("pac") else 0
    got = analyze(pricer.cost, arch=arch, shape=shape, technique=technique, note=case.note,
                  n_active_params=cfg.active_param_count(), n_adapter_params=n_ad_port)
    assert n_ad_port == n_ad
    assert got.model_flops_total == pytest.approx(want.model_flops_total, rel=1e-12)
    assert got.note == want.note
    port, ref = _adjusted(pricer, want.flops_per_device, compiled.as_text(), cfg, shape)
    assert port == pytest.approx(ref, rel=FLOPS_RTOL), (port / ref, got.flops_per_device
                                                        / want.flops_per_device)


# ---------------------------------------------------------------------------
# Full width and depth on meta
# ---------------------------------------------------------------------------


class _NoHlo:
    """A compiled module with nothing in it: the reference's ``analyze``
    then gives its closed forms (model FLOPs) alone."""

    def as_text(self):
        return "ENTRY %main () -> f32[] {\n  ROOT %c = f32[] constant(0)\n}\n"

    def memory_analysis(self):
        return ""


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "train_4k"),
                                        ("moonshot-v1-16b-a3b", "train_4k"),
                                        ("xlstm-125m", "decode_32k"),
                                        ("qwen2-vl-7b", "prefill_32k"),
                                        ("internlm2-1.8b", "long_500k")])
def test_full_width_cases_price_on_meta(arch, shape):
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_arch as ref_arch
    from repro.core.parallel_adapters import adapter_param_count as ref_adapter_count
    from repro.launch import mesh as ref_mesh
    from repro.launch.roofline import analyze as ref_analyze
    from repro.launch.specs import resolve_cfg_for_shape as ref_resolve

    rec = run_case(arch, shape, verbose=False)
    rcfg, note = ref_resolve(ref_arch(arch), REF_SHAPES[shape])
    want = ref_analyze(_NoHlo(), arch=arch, shape=REF_SHAPES[shape],
                       mesh=ref_mesh.make_mesh((1, 1), ("data", "model")), technique="pac",
                       note=note, n_active_params=rcfg.active_param_count(),
                       n_adapter_params=ref_adapter_count(rcfg))
    assert rec["note"] == note
    assert rec["model_flops_total"] == pytest.approx(want.model_flops_total, rel=1e-12)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert 0 < rec["useful_compute_ratio"] < 1.5
    if shape == "long_500k":
        assert all(s.window == SERVE_WINDOW for s in build_case(arch, shape).cfg.pattern)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_dryrun_cli_writes_roofline_records(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--shape", "decode_32k", "--quant", "8", "--kv-quant", "8", "--out", str(tmp_path)],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all dry-run cases priced OK" in out.stdout
    (path,) = tmp_path.glob("*.json")
    assert path.name == "internlm2-1.8b_decode_32k_1x1_pac_int8_kv8.json"
    rec = json.loads(path.read_text())
    assert set(RooflineTerms.__dataclass_fields__) <= set(rec)
    assert rec["status"] == "ok" and rec["note"] == "int8 kv8"
    assert rec["units"]["quant_matmul"]["calls"] == 7 * 24


def test_dryrun_cli_exits_1_on_a_failing_case(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--shape", "decode_32k", "--dp", "2", "--stages", "2"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "1 failures" in out.stdout and "EdgeMesh layout prices" in out.stdout


def test_a_layout_prices_every_rank_with_its_mesh_bytes():
    """dp 2 x stages 2 on reduced internlm2: both steps price four ranks;
    every rank all-reduces the loss parts and the adapter's gradients;
    the epoch-1 step's later stages send their taps and outputs to their
    row's first stage, the cached step's owner scatters the rows."""
    cfg = get_arch("internlm2-1.8b").reduced()
    shape = InputShape("t", 16, 8, "train")
    for technique in ("pac", "pac_cached"):
        rec = run_case(cfg, shape, technique=technique, quant_bits=8, tap_policy="int8",
                       layout=(2, 2), verbose=False)
        ranks = rec["ranks"]
        assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
        assert rec["mesh"] == "2x2"
        assert all(r["allreduce_bytes"] == 4 * (2 + adapter_param_count(cfg)) for r in ranks)
        if technique == "pac_cached":
            assert [r["p2p_bytes"] > 0 for r in ranks] == [True, False, False, False]
        else:
            assert all(r["p2p_bytes"] > 0 for r in ranks)
