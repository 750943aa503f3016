"""The port's block quantization and bridge against the JAX reference.

Quantize/dequantize (INT8, packed INT4, ragged ``orig_last``, all-zero
blocks), the KV-page quantizer and ``quantize_tree``'s leaf rule must be
bit-exact; the bridge must carry numpy/QTensor/bf16 trees across and
back unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.serve.paging import quantize_kv_pages as jax_quantize_kv_pages
from repro_torch import bridge
from repro_torch.core import quantization as tq
from repro_torch.serve.paging import quantize_kv_pages

torch.set_num_threads(2)


def _input(shape, seed, zero_block=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_block:
        x[..., :128] = 0.0  # one all-zero block -> scale 0
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block,zero_block", [
    ((64, 256), 128, False),
    ((3, 17, 300), 128, True),    # ragged orig_last: padded tail block
    ((8, 129), 128, False),       # 1-element tail block
    ((4, 5, 7), 128, False),      # block clamps to orig_last (odd: int4 pads)
    ((2, 384), 64, True),
])
def test_quantize_dequantize_bit_exact(bits, shape, block, zero_block):
    x = _input(shape, seed=sum(shape) + bits, zero_block=zero_block)
    want = jq.quantize(jnp.asarray(x), bits=bits, block=block)
    got = tq.quantize(torch.from_numpy(x), bits=bits, block=block)
    assert (got.bits, got.block, got.orig_last) == (want.bits, want.block, want.orig_last)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if zero_block:
        assert (got.scale.numpy()[..., 0] == 0).all()
    np.testing.assert_array_equal(tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want)))
    assert got.shape == tuple(want.shape) and got.nbytes == want.nbytes


def test_quantize_kv_pages_bit_exact():
    t = _input((6, 5, 4, 64), seed=3) * 3.0
    t[1, 2] = 0.0  # all-zero token/head rows take the 1e-8 floor
    want_q, want_s = jax_quantize_kv_pages(jnp.asarray(t))
    got_q, got_s = quantize_kv_pages(torch.from_numpy(t))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _jax_tree():
    k = jax.random.PRNGKey(0)
    return {
        "embed": jax.random.normal(k, (64, 128)),
        "final_norm": jnp.zeros((128,)),
        "blocks": [{"ln1": jnp.zeros((2, 128)) + 0.5,
                    "mixer": {"wq": jax.random.normal(jax.random.fold_in(k, 1), (2, 128, 256))},
                    "router_w": jax.random.normal(jax.random.fold_in(k, 2), (128, 64))}],
        "small": jax.random.normal(jax.random.fold_in(k, 3), (4, 8)),
    }


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_reference_leaf_rule(bits):
    """Every ndim>=2 leaf of at least min_size is quantized — the stacked
    (n_p, d) norm gains included — and ``router`` leaves are skipped."""
    jtree = _jax_tree()
    want = jq.quantize_tree(jtree, bits=bits, min_size=256)
    got = tq.quantize_tree(bridge.to_torch(jax.tree.map(np.asarray, jtree)), bits=bits,
                           min_size=256)
    assert isinstance(got["blocks"][0]["ln1"], tq.QTensor)
    assert not isinstance(got["blocks"][0]["router_w"], tq.QTensor)
    assert not isinstance(got["small"], tq.QTensor) and not isinstance(got["final_norm"], tq.QTensor)
    assert tq.tree_storage_bytes(got) == jq.tree_storage_bytes(want)
    got_f = tq.maybe_dequantize_tree(got)
    want_f = jq.maybe_dequantize_tree(want)
    for g, w in zip(tq.tree_leaves(got_f), jax.tree.leaves(want_f)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bridge_round_trip_qtensor_and_bf16():
    jtree = jq.quantize_tree(_jax_tree(), bits=8, min_size=256)
    jtree["bf16"] = jnp.asarray(_input((3, 5), seed=9)).astype(jnp.bfloat16)
    jtree["tuple"] = (jnp.arange(4, dtype=jnp.int32), None)
    host = jax.tree.map(np.asarray, jtree)  # QTensor is a pytree: leaves to numpy
    t = bridge.to_torch(host)
    assert isinstance(t["embed"], tq.QTensor) and t["embed"].q.dtype == torch.int8
    assert t["bf16"].dtype == torch.bfloat16 and isinstance(t["tuple"], tuple)
    np.testing.assert_array_equal(t["bf16"].float().numpy(),
                                  np.asarray(jtree["bf16"].astype(jnp.float32)))
    back = bridge.to_numpy(t, qtensor=jq.QTensor)
    assert isinstance(back["embed"], jq.QTensor)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# MoE leaves: twins of tests/test_quantization.py:173-220, and the
# period-stacked 4-D expert leaves against the reference
# ---------------------------------------------------------------------------


def test_quantize_tree_skips_router_by_name():
    """A ``router`` leaf stays f32 whatever its size while its sibling
    expert weights of the same size quantize; dequantizing leaves the
    router bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import LeafMaker
    from repro_torch.models.moe import init_moe

    spec = get_arch("mixtral-8x7b").reduced().moe
    p = init_moe(LeafMaker(torch.Generator().manual_seed(0)), 128, spec)
    assert p["router"].numel() >= 256
    qt = tq.quantize_tree(p, bits=8, min_size=256)
    assert not isinstance(qt["router"], tq.QTensor) and qt["router"].dtype == torch.float32
    assert isinstance(qt["wi"], tq.QTensor) and isinstance(qt["wo"], tq.QTensor)
    assert torch.equal(tq.maybe_dequantize_tree(qt)["router"], p["router"])


def test_quantize_tree_skip_applies_at_any_depth():
    tree = {"blocks": [{"router": torch.ones(64, 64), "w": torch.ones(64, 64)},
                       {"router": torch.ones(64, 64), "w": torch.ones(64, 64)}]}
    qt = tq.quantize_tree(tree, min_size=1024)
    for blk in qt["blocks"]:
        assert not isinstance(blk["router"], tq.QTensor)
        assert isinstance(blk["w"], tq.QTensor)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_on_full_moe_backbone_matches_reference(bits):
    """The reference's mixtral reduced backbone, quantized by each package:
    every router f32, every period-stacked (n_p, E, d, d_e) expert leaf's
    codes and scales bit-equal, and the trees bridge both ways unchanged."""
    from repro.configs import get_arch as jax_get_arch
    from repro.models import backbone as jbb

    cfg = jax_get_arch("mixtral-8x7b").reduced()
    bp = jbb.init_backbone(jax.random.PRNGKey(0), cfg)
    want = jq.quantize_tree(bp, bits=bits, min_size=1024)
    got = tq.quantize_tree(bridge.to_torch(jax.tree.map(np.asarray, bp)), bits=bits,
                           min_size=1024)
    for jblk, tblk in zip(want["blocks"], got["blocks"]):
        assert not isinstance(jblk["ffn"]["router"], jq.QTensor)
        assert not isinstance(tblk["ffn"]["router"], tq.QTensor)
        np.testing.assert_array_equal(tblk["ffn"]["router"].numpy(),
                                      np.asarray(jblk["ffn"]["router"]))
        for name in ("wi", "wg", "wo"):
            j, t = jblk["ffn"][name], tblk["ffn"][name]
            assert t.q.ndim == 4 and t.shape == tuple(j.shape)
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    back = bridge.to_numpy(got, qtensor=jq.QTensor)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = bridge.to_torch(jax.tree.map(np.asarray, want))
    for a, b in zip(tq.tree_leaves(again), tq.tree_leaves(got)):
        for x, y in ((a.q, b.q), (a.scale, b.scale)) if isinstance(a, tq.QTensor) else ((a, b),):
            assert torch.equal(x, y)
