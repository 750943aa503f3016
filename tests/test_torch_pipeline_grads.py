"""The backward through the port's pipeline against ``jax.grad`` through
the reference's ``pipeline_apply``.

The reference runs in a subprocess on four forced host devices; the port
runs as gloo ranks on the CPU (``repro_torch.launch.mesh.spawn``, gloo
timeout 60 s, join deadline 120 s) through
``repro_torch.core.pipeline.pipeline_grads``, on the same numpy inputs:

* the twin of ``tests/test_pipeline.py``'s gradient check: tanh-scan
  slabs, 4 stages, 6 micro-batches of 3, d 16;
* the (2, 2) mesh with ``collect_taps=True`` and a loss that reads the
  taps (each slab's gradient summed over the dp rows);
* a ragged 3-stage partition of 5 periods (a masked padding slot, whose
  gradient is zero, as the reference's slab gradient has it);
* reduced internlm2-1.8b's CE through the real ``_backbone_stage_fn``
  under ``ref`` on the (2, 2) mesh (``steps.pipeline_lm_loss``);
* PAC+ through ``pipeline_grads`` (``steps.pipeline_pac_loss``) bit-equal
  to ``pipeline_pac_loss_and_grads``, under ``ref`` and under ``cuda``
  with int8 taps, with no point-to-point bytes beyond the forward's;
* each rank's executed F/B order against ``build_1f1b_schedule`` and
  ``validate_schedule``; the backward's bytes equal to the forward's;
  an engaged call outside ``pipeline_grads`` refused on every rank.

Tolerances: values 1e-5; gradients 1e-4, the reference's own
(``tests/test_pipeline.py``). The reference's pipelined gradients are
held to its un-pipelined ones at the same bounds first.
"""

import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import pipeline, steps
from repro_torch.core.quantization import quantize_tree, tree_leaves
from repro_torch.launch.mesh import EdgeMesh, spawn

REPO = Path(__file__).resolve().parents[1]
GLOO_TIMEOUT, DEADLINE = 60.0, 120.0
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
D = 16
BOUNDS, MASKS = (0, 1, 3, 5), ((True, False), (True, True), (True, True))

# the reference's four cases, each as jax.value_and_grad through its
# pipeline_apply and through the same function un-pipelined; inputs drawn
# with numpy from seed 0 (written out with the results)
_REFERENCE = textwrap.dedent(
    """
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.core import steps
    from repro.core.pipeline import pipeline_apply, stack_stages, stack_stages_ragged
    from repro.data import DataPipeline
    from repro.launch.mesh import make_edge_mesh
    from repro.models import backbone as bb

    d = {D}
    rng = np.random.default_rng(0)
    out = {{}}

    def tanh_fn(w, h):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w),) * 2, h, w)

    def plain(Wp, x, taps):
        h, acc = x, 0.0
        for i in range(Wp.shape[0]):
            h = jnp.tanh(h @ Wp[i])
            acc = acc + 0.5 * jnp.sum(jnp.sin(h))
        return jnp.sum(h ** 2) + (acc if taps else 0.0)

    # 4 stages, 6 micro-batches of 3
    W = (rng.standard_normal((8, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((6, 3, d)).astype(np.float32)
    mesh = make_edge_mesh(1, 4)
    def toy(Wp):
        with mesh:
            o = pipeline_apply(lambda w, h: tanh_fn(w, h)[0], stack_stages(Wp, 4), x, mesh)
        return jnp.sum(o ** 2)
    out["toy"] = dict(W=W, x=x, pipe=jax.value_and_grad(toy)(W),
                      plain=jax.value_and_grad(lambda w: plain(w, x, False))(W))

    # the (2, 2) mesh, taps read by the loss: 3 micro-batches of 4
    W = (rng.standard_normal((8, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    mesh22 = make_edge_mesh(2, 2)
    def taps(Wp):
        with mesh22:
            o, t = pipeline_apply(tanh_fn, stack_stages(Wp, 2), x, mesh22, batch_axis="dp",
                                  collect_taps=True)
        return jnp.sum(o ** 2) + 0.5 * jnp.sum(jnp.sin(t))
    out["taps"] = dict(W=W, x=x, pipe=jax.value_and_grad(taps)(W),
                       plain=jax.value_and_grad(lambda w: plain(w, x, True))(W))

    # 5 periods over 3 stages (1, 2, 2): stage 0's second slot is padding
    W = (rng.standard_normal((5, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 2, d)).astype(np.float32)
    mesh3 = make_edge_mesh(1, 3, devices=jax.devices()[:3])
    masks = np.array({MASKS})
    def masked_fn(local, h):
        def body(c, xs):
            w, m = xs
            hh = jnp.where(m, jnp.tanh(c @ w), c)
            return hh, hh
        return jax.lax.scan(body, h, (local["w"], local["mask"]))
    def ragged(slab):
        with mesh3:
            o, t = pipeline_apply(masked_fn, {{"w": slab, "mask": jnp.asarray(masks)}}, x, mesh3,
                                  collect_taps=True, periods_per_stage=(1, 2, 2))
        return jnp.sum(o ** 2) + 0.5 * jnp.sum(jnp.sin(t))
    slab = np.asarray(stack_stages_ragged(W, {BOUNDS}))
    out["ragged"] = dict(W=W, x=x, slab=slab, pipe=jax.value_and_grad(ragged)(slab),
                         plain=jax.value_and_grad(lambda w: plain(w, x, True))(W))

    # reduced internlm2-1.8b's CE through the real stage function, (2, 2) mesh
    cfg = get_arch("internlm2-1.8b").reduced()
    bp = bb.init_backbone(jax.random.PRNGKey(0), cfg)
    B, S, n_micro = 8, 16, 2
    batch = {{"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}}
    micro = DataPipeline.dp_microbatches(batch, n_micro, 2)
    fn = steps._backbone_stage_fn(cfg)
    def lm(blocks):
        p = dict(bp, blocks=blocks)
        x, _ = bb.embed_inputs(p, cfg, {{"tokens": micro["tokens"].reshape(B, S)}})
        with mesh22:
            o = pipeline_apply(lambda b, h: fn(b, h)[0], stack_stages(blocks, 2),
                               x.reshape((n_micro, B // n_micro) + x.shape[1:]), mesh22,
                               batch_axis="dp")
        logits = bb.logits_from_hidden(p, cfg, o.reshape((B,) + o.shape[2:]))
        return bb.cross_entropy(logits, micro["labels"].reshape(B, S))
    def lm_plain(blocks):
        p = dict(bp, blocks=blocks)
        return bb.cross_entropy(bb.backbone_logits(p, cfg, batch), batch["labels"])
    out["lm"] = dict(bp=bp, batch=batch, pipe=jax.value_and_grad(lm)(bp["blocks"]),
                     plain=jax.value_and_grad(lm_plain)(bp["blocks"]))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, out), f)
    """
).format(D=D, MASKS=repr(MASKS), BOUNDS=repr(BOUNDS))


# ---------------------------------------------------------------------------
# What each rank runs (module-level, so the spawned processes can import it)
# ---------------------------------------------------------------------------


def _tanh_stage(w, h):
    taps = []
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i])
        taps.append(h)
    return h, torch.stack(taps)


def _masked_stage(local, h):
    taps = []
    for i, active in enumerate(local["mask"]):
        if active:
            h = torch.tanh(h @ local["w"][i])
        taps.append(h)
    return h, torch.stack(taps)


def _row_x(x, mesh):
    """This dp row's share of dim 1 of the micro-batched input, on the
    row's first stage (a meta tensor of its shape elsewhere)."""
    q = x.shape[1] // mesh.dp
    mine = x[:, mesh.dp_rank * q: (mesh.dp_rank + 1) * q]
    return mine if mesh.stage == 0 else torch.empty(mine.shape, device="meta")


def _tap_loss(slab, frozen, x, mesh, *, ragged=False):
    """sum(out²) + 0.5·sum(sin(taps)), summed over the dp rows."""
    fn, params = ((_masked_stage, {"w": slab, "mask": frozen}) if ragged
                  else (_tanh_stage, slab))
    res = pipeline.pipeline_apply(fn, params, _row_x(x, mesh), mesh, collect_taps=True,
                                  periods_per_stage=(1, 2, 2) if ragged else None)
    local = None if res is None else (res[0] ** 2).sum() + 0.5 * torch.sin(res[1]).sum()
    total = mesh.all_reduce_tree(torch.zeros(()) if local is None else local.detach())
    return total if local is None else pipeline.carry_grad(total, local)


def _toy_loss(slab, frozen, x, mesh):
    out = pipeline.pipeline_apply(lambda w, h: _tanh_stage(w, h)[0], slab, _row_x(x, mesh), mesh)
    return None if out is None else (out ** 2).sum()


def _toy_rank(ref):
    mesh = EdgeMesh(1, 4, device="cpu")
    W, x = torch.tensor(ref["W"]), torch.tensor(ref["x"])
    slab = pipeline.stack_stages(W, 4)[mesh.stage]
    trace, fwd = [], {}

    def loss_fn(*a):
        loss = _toy_loss(*a)
        fwd["p2p"] = mesh.stats["p2p_bytes"]
        return loss

    loss, g = pipeline.pipeline_grads(loss_fn, slab, None, x, mesh, trace=trace)
    out = {"loss": float(loss), "grad": g.numpy(), "trace": [(o.micro, o.kind) for o in trace],
           "fwd_bytes": fwd["p2p"], "bwd_bytes": mesh.stats["p2p_bytes"] - fwd["p2p"]}
    # the same stages requiring grad outside pipeline_grads: refused on every rank
    try:
        _toy_loss(slab.clone().requires_grad_(True), None, x, mesh)
        out["outside"] = None
    except RuntimeError as e:
        out["outside"] = str(e)
    mesh.close()
    return out


def _ragged_rank(ref):
    mesh = EdgeMesh(1, 3, device="cpu")
    slab, x = torch.tensor(ref["slab"][mesh.stage]), torch.tensor(ref["x"])
    trace = []
    loss, g = pipeline.pipeline_grads(functools.partial(_tap_loss, ragged=True), slab,
                                      MASKS[mesh.stage], x, mesh, trace=trace)
    mesh.close()
    return {"loss": float(loss), "grad": g.numpy(), "trace": [(o.micro, o.kind) for o in trace]}


def _digest(tree) -> list:
    return [t.detach().numpy().tobytes() for t in tree_leaves(tree)]


def _mesh22_rank(taps_ref, lm_ref, ap):
    mesh = EdgeMesh(2, 2, device="cpu")
    out = {}
    # taps read by the loss, each slab's gradient summed over the rows
    W, x = torch.tensor(taps_ref["W"]), torch.tensor(taps_ref["x"])
    loss, g = pipeline.pipeline_grads(_tap_loss, pipeline.stack_stages(W, 2)[mesh.stage], None,
                                      x, mesh)
    out["taps"] = (float(loss), g.numpy())
    # reduced internlm2's CE through the real stage function
    cfg = get_arch("internlm2-1.8b").reduced()
    bp = bridge.to_torch(lm_ref["bp"])
    batch = {k: torch.tensor(v) for k, v in lm_ref["batch"].items()}
    local = steps.stage_backbone(bp, cfg, mesh)
    loss, g = pipeline.pipeline_grads(
        functools.partial(steps.pipeline_lm_loss, cfg=cfg, n_micro=2), local["blocks"], local,
        batch, mesh)
    out["lm"] = (float(loss), bridge.to_numpy(g))
    # PAC+ through pipeline_grads against pipeline_pac_loss_and_grads, bit
    # for bit, under ref and under cuda (plain versions here) with int8 taps
    ap = bridge.to_torch(ap)
    out["pac"] = {}
    for impl, tap, backbone in (("ref", "f32", bp), ("cuda", "int8", quantize_tree(bp, bits=8))):
        kw = dict(cfg=cfg, n_micro=2, r=4, kernel_impl=impl, tap_policy=tap)
        want_loss, want_g, _ = steps.pipeline_pac_loss_and_grads(backbone, ap, batch, mesh=mesh,
                                                                 **kw)
        before = mesh.stats["p2p_bytes"]
        with torch.no_grad():  # the loss's forward alone
            steps.pipeline_pac_loss(ap, backbone, batch, mesh, **kw)
        mid = mesh.stats["p2p_bytes"]
        loss, g = pipeline.pipeline_grads(functools.partial(steps.pipeline_pac_loss, **kw), ap,
                                          backbone, batch, mesh, shared="world")
        out["pac"][impl] = {
            "loss_equal": loss.numpy().tobytes() == want_loss.numpy().tobytes(),
            "grads_equal": _digest(g) == _digest(want_g),
            "p2p": (mid - before, mesh.stats["p2p_bytes"] - mid)}
    mesh.close()
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port 1x4 ranks, port 1x3 ranks, port 2x2 ranks). The
    reference's script draws the inputs; the port's ranks start once it
    has written them."""
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.core.parallel_adapters import init_adapter

    path = tmp_path_factory.mktemp("pipeline_grads") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ap = jax.tree.map(np.asarray, init_adapter(jax.random.PRNGKey(1),
                                               jax_arch("internlm2-1.8b").reduced(), r=4))
    toy = spawn(_toy_rank, 1, 4, "cpu", args=(ref["toy"],), timeout=GLOO_TIMEOUT,
                deadline=DEADLINE)
    ragged = spawn(_ragged_rank, 1, 3, "cpu", args=(ref["ragged"],), timeout=GLOO_TIMEOUT,
                   deadline=DEADLINE)
    mesh22 = spawn(_mesh22_rank, 2, 2, "cpu", args=(ref["taps"], ref["lm"], ap),
                   timeout=GLOO_TIMEOUT, deadline=DEADLINE)
    return ref, toy, ragged, mesh22


def _max_diff(a, b) -> float:
    la, lb = tree_leaves(bridge.to_torch(a)), tree_leaves(bridge.to_torch(b))
    assert len(la) == len(lb)
    return max(float((x - y).abs().max()) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", ["toy", "taps", "ragged", "lm"])
def test_the_reference_pipeline_gradient_is_the_plain_one(runs, case):
    """The yardstick first: ``jax.grad`` through the reference's
    pipeline_apply equals its un-pipelined gradient."""
    ref = runs[0][case]
    assert abs(float(ref["pipe"][0]) - float(ref["plain"][0])) <= VALUE_TOL * max(
        1.0, abs(float(ref["plain"][0])))
    pipe = ref["pipe"][1]
    if case == "ragged":  # the padded slab, its active slots in layer order
        pipe = np.concatenate([pipe[s, :b - a] for s, (a, b) in
                               enumerate(zip(BOUNDS, BOUNDS[1:]))])
    assert _max_diff(pipe, ref["plain"][1]) <= GRAD_TOL


def test_four_stage_gradients_match_the_reference(runs):
    ref, toy = runs[0]["toy"], runs[1]
    want = ref["pipe"][1].reshape((4, 2) + ref["pipe"][1].shape[1:])
    for r in toy:
        assert abs(r["loss"] - float(ref["pipe"][0])) <= VALUE_TOL * abs(float(ref["pipe"][0]))
    for s, r in enumerate(toy):
        np.testing.assert_allclose(r["grad"], want[s], atol=GRAD_TOL)


def test_taps_on_the_dp_mesh_match_the_reference(runs):
    ref, ranks = runs[0]["taps"], runs[3]
    want = ref["pipe"][1].reshape((2, 4) + ref["pipe"][1].shape[1:])
    for r in ranks:
        loss, g = r["taps"]
        assert abs(loss - float(ref["pipe"][0])) <= VALUE_TOL * abs(float(ref["pipe"][0]))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["taps"][1], want[rank % 2], atol=GRAD_TOL)
    # the rows' sums: both rows of a stage hold the same bits
    assert ranks[0]["taps"][1].tobytes() == ranks[2]["taps"][1].tobytes()


def test_ragged_partition_matches_the_reference_with_zero_padding_grads(runs):
    ref, ranks = runs[0]["ragged"], runs[2]
    for s, r in enumerate(ranks):
        assert abs(r["loss"] - float(ref["pipe"][0])) <= VALUE_TOL * abs(float(ref["pipe"][0]))
        np.testing.assert_allclose(r["grad"], ref["pipe"][1][s], atol=GRAD_TOL)
    assert not ranks[0]["grad"][1].any() and not ref["pipe"][1][0, 1].any()


def test_internlm2_ce_through_the_stages_matches_the_reference(runs):
    """Reduced internlm2-1.8b's CE, the blocks trained through the real
    stage function under ``ref`` on the (2, 2) mesh."""
    ref, ranks = runs[0]["lm"], runs[3]
    stages = pipeline.stack_stages(bridge.to_torch(ref["pipe"][1]), 2)
    for rank, r in enumerate(ranks):
        loss, g = r["lm"]
        assert abs(loss - float(ref["pipe"][0])) <= VALUE_TOL
        want = pipeline.map_arrays(lambda t: t[rank % 2], stages)
        assert _max_diff(g, bridge.to_numpy(want)) <= GRAD_TOL


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_pac_through_pipeline_grads_is_bit_equal_with_no_backward_bytes(runs, impl):
    for r in runs[3]:
        pac = r["pac"][impl]
        assert pac["loss_equal"] and pac["grads_equal"], pac
        fwd, through_grads = pac["p2p"]
        assert through_grads == fwd  # the forward's messages alone: nothing crosses back


@pytest.mark.parametrize("which", ["toy", "ragged"])
def test_each_rank_runs_its_1f1b_order_within_the_bound(runs, which):
    """The F (graph built) and B ops each rank ran: its stage's list of
    ``build_1f1b_schedule``, which ``validate_schedule`` accepts (at most
    S − s micro-batches' graphs alive)."""
    ranks = runs[1] if which == "toy" else runs[2]
    S, M = len(ranks), 6 if which == "toy" else 4
    sched = [[pipeline.Op(s, m, k) for m, k in r["trace"]] for s, r in enumerate(ranks)]
    want = pipeline.build_1f1b_schedule(S, M)
    assert sched == want
    pipeline.validate_schedule(sched, M)


def test_backward_bytes_equal_the_forward_and_outside_calls_are_refused(runs):
    toy = runs[1]
    act = 6 * 3 * D * 4  # the micro-batches' activations, f32
    for r in toy:
        assert r["fwd_bytes"] == r["bwd_bytes"] == act
        assert r["outside"] is not None and "pipeline_grads" in r["outside"]
