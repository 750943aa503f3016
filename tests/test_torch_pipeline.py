"""The port's pipeline pieces against the JAX reference's, in one process:
the 1F1B schedule op for op, ``validate_schedule``'s refusals, the stage
slabs (``stack_stages``, ``stack_stages_ragged``) on bridged trees, one
stage's frozen forward (``_backbone_stage_fn``, even and masked), the
micro-batch layout of the hybrid trainer, and the cached batch's split
over the pool (``launch.sharding``)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pipeline as jpipe
from repro.core import steps as jsteps
from repro.core.quantization import QTensor as JaxQTensor
from repro.core.quantization import quantize_tree as jax_quantize_tree
from repro.data import DataPipeline as JaxPipeline
from repro.launch.sharding import cached_batch_axes as jax_cached_batch_axes
from repro.models import backbone as jbb
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import pipeline, steps
from repro_torch.data import DataPipeline
from repro_torch.launch.sharding import cached_batch_axes, rank_rows, rows_count

torch.set_num_threads(2)


@pytest.mark.parametrize("S", range(1, 9))
def test_1f1b_schedule_equals_the_reference(S):
    for M in range(1, 17):
        mine, ref = pipeline.build_1f1b_schedule(S, M), jpipe.build_1f1b_schedule(S, M)
        assert [[(o.stage, o.micro, o.kind) for o in ops] for ops in mine] == \
               [[(o.stage, o.micro, o.kind) for o in ops] for ops in ref]
        pipeline.validate_schedule(mine, M)


def _swap_first_fs(sched):
    ops = list(sched[0])
    i, j = [k for k, o in enumerate(ops) if o.kind == "F"][:2]
    ops[i], ops[j] = ops[j], ops[i]
    return [ops] + sched[1:]


def _all_f_first(sched):
    """Stage 0 runs every F before any B: more in flight than 1F1B allows."""
    ops = sched[0]
    return [[o for o in ops if o.kind == "F"] + [o for o in ops if o.kind == "B"]] + sched[1:]


@pytest.mark.parametrize("break_it", [
    _swap_first_fs,
    lambda s: [s[0][:-1]] + s[1:],                           # a B missing
    lambda s: [[o for o in s[0] if o.micro != 2]] + s[1:],   # a micro missing
    _all_f_first,
    lambda s: s,                                             # intact: no raise
])
def test_validate_schedule_raises_where_the_reference_does(break_it):
    S, M = 3, 6
    mine = break_it(pipeline.build_1f1b_schedule(S, M))
    ref = break_it(jpipe.build_1f1b_schedule(S, M))
    try:
        jpipe.validate_schedule(ref, M)
        ref_raised = False
    except AssertionError:
        ref_raised = True
    if ref_raised:
        with pytest.raises(ValueError):
            pipeline.validate_schedule(mine, M)
    else:
        pipeline.validate_schedule(mine, M)


@pytest.fixture(scope="module")
def blocks():
    """The reduced backbone's block trees (4 periods), f32 and INT8."""
    import dataclasses

    cfg = dataclasses.replace(jax_arch("internlm2-1.8b").reduced(), n_layers=4)
    bp = jbb.init_backbone(jax.random.PRNGKey(0), cfg)
    return {"f32": bp["blocks"], "int8": jax_quantize_tree(bp, bits=8)["blocks"]}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_tree(mine, ref):
    got = bridge.to_numpy(mine)
    want = _numpy(ref)
    a = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, bridge.NumpyQTensor))
    b = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, JaxQTensor))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, JaxQTensor):
            assert (x.bits, x.block, x.orig_last) == (y.bits, y.block, y.orig_last)
            np.testing.assert_array_equal(x.q, y.q)
            np.testing.assert_array_equal(x.scale, y.scale)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stack_stages_equals_the_reference(blocks, kind, n_stages):
    tree = blocks[kind]
    _assert_same_tree(pipeline.stack_stages(bridge.to_torch(_numpy(tree)), n_stages),
                      jpipe.stack_stages(tree, n_stages))


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("boundaries", [(0, 1, 4), (0, 2, 3, 4), (0, 3, 4)])
def test_stack_stages_ragged_equals_the_reference(blocks, kind, boundaries):
    tree = blocks[kind]
    _assert_same_tree(pipeline.stack_stages_ragged(bridge.to_torch(_numpy(tree)), boundaries),
                      jpipe.stack_stages_ragged(tree, boundaries))


def test_stack_stages_refuses_an_uneven_split(blocks):
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        pipeline.stack_stages(bridge.to_torch(_numpy(blocks["f32"])), 3)


@pytest.mark.parametrize("masked", [False, True])
def test_stage_fn_equals_the_reference(blocks, masked):
    """One stage's frozen forward on its slab: the hidden state and the
    taps (a masked slab's padding period repeats the carry)."""
    import dataclasses

    jcfg = dataclasses.replace(jax_arch("internlm2-1.8b").reduced(), n_layers=4)
    cfg = dataclasses.replace(get_arch("internlm2-1.8b").reduced(), n_layers=4)
    h = jax.random.normal(jax.random.PRNGKey(5), (2, 12, cfg.d_model), jnp.float32)
    if masked:  # stage 0 of (0, 1, 4): one period and two padding slots
        slab = jax.tree.map(lambda x: x[0], jpipe.stack_stages_ragged(blocks["f32"], (0, 1, 4)))
        ref_in = {"blocks": slab, "mask": jnp.asarray([True, False, False])}
        mine_in = {"blocks": bridge.to_torch(_numpy(slab)), "mask": (True, False, False)}
    else:
        ref_in = jax.tree.map(lambda x: x[1], jpipe.stack_stages(blocks["f32"], 2))
        mine_in = bridge.to_torch(_numpy(ref_in))
    want_h, want_taps = jsteps._backbone_stage_fn(jcfg, masked=masked)(ref_in, h)
    got_h, got_taps = steps._backbone_stage_fn(cfg, masked=masked)(
        mine_in, torch.from_numpy(np.array(h)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_taps.numpy(), np.asarray(want_taps), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,n_micro,dp", [(8, 2, 2), (12, 3, 2), (8, 1, 4), (6, 6, 1)])
def test_dp_microbatches_layout_equals_the_reference(B, n_micro, dp):
    batch = {"tokens": np.arange(B * 5, dtype=np.int32).reshape(B, 5),
             "labels": np.arange(B, dtype=np.int32)}
    mine = DataPipeline.dp_microbatches(batch, n_micro, dp)
    ref = JaxPipeline.dp_microbatches(batch, n_micro, dp)
    for k in batch:
        np.testing.assert_array_equal(mine[k], ref[k])
    # dp rank r of micro m owns samples [m·mb + r·mb/dp, m·mb + (r+1)·mb/dp)
    mb = B // n_micro
    for m in range(n_micro):
        for r in range(dp):
            rows = mine["labels"][m, r * mb // dp: (r + 1) * mb // dp]
            np.testing.assert_array_equal(rows, np.arange(m * mb + r * mb // dp,
                                                          m * mb + (r + 1) * mb // dp))
    t = DataPipeline.dp_microbatches({"x": torch.from_numpy(batch["tokens"])}, n_micro, dp)["x"]
    np.testing.assert_array_equal(t.numpy(), ref["tokens"])


@pytest.mark.parametrize("B,n_micro,dp", [(6, 2, 2), (8, 3, 1), (4, 0, 1), (4, 1, 0)])
def test_dp_microbatches_errors_equal_the_reference(B, n_micro, dp):
    batch = {"tokens": np.zeros((B, 3), np.int32)}
    with pytest.raises(ValueError) as ref:
        JaxPipeline.dp_microbatches(batch, n_micro, dp)
    with pytest.raises(ValueError) as mine:
        DataPipeline.dp_microbatches(batch, n_micro, dp)
    assert str(mine.value) == str(ref.value)


def _mesh(dp, stages, rank=0):
    return SimpleNamespace(dp=dp, stages=stages, world=dp * stages, rank=rank,
                           dp_rank=rank // stages, stage=rank % stages,
                           axis_names=("dp", "stage"), shape={"dp": dp, "stage": stages})


@pytest.mark.parametrize("B,dp,stages", [(8, 2, 2), (2, 2, 2), (4, 1, 4), (6, 2, 3), (4, 4, 1)])
def test_cached_batch_split_follows_the_reference(B, dp, stages):
    """The reference's axes; every row held by exactly one counted rank,
    dp-major then stage."""
    labels = np.zeros((B, 3), np.int32)
    axes = cached_batch_axes({"labels": labels}, _mesh(dp, stages))
    assert axes == jax_cached_batch_axes({"labels": labels}, _mesh(dp, stages))
    assert axes == cached_batch_axes(B, _mesh(dp, stages))
    counted = []
    for rank in range(dp * stages):
        mesh = _mesh(dp, stages, rank)
        if rows_count(mesh, axes):
            counted += list(range(B))[rank_rows(B, mesh, axes)]
        assert rank_rows(B, mesh, axes) == rank_rows(B, _mesh(dp, stages), axes, rank)
    assert counted == list(range(B))
