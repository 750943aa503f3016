"""The port's mrope (Qwen2-VL's multimodal rope) against the JAX package:
``apply_mrope`` with equal and with distinct t/h/w position streams, its
slot bounds at head widths whose halves do not divide by 8 (the adapter's
hd 148 at r = 8), the OpSets' method, the decode positions, and the
text-image-text layout of :func:`vision_positions`.

Inputs come from numpy with a fixed seed; the tolerance is the
reference's own (tests/test_attention.py:91, 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import apply_mrope as jax_apply_mrope
from repro_torch.configs import get_arch
from repro_torch.core.opset import get_opset
from repro_torch.core.parallel_adapters import adapter_config
from repro_torch.models.layers import apply_mrope, apply_rope, decode_positions, vision_positions

torch.set_num_threads(2)


def _x(B, S, H, hd, seed):
    return np.random.default_rng(seed).standard_normal((B, S, H, hd)).astype(np.float32)


def _streams(B, S, seed):
    """(3, B, S) position ids whose streams differ: each row a text prefix,
    an image grid of at most 2 x 3 x 4 patches and text after it, as
    Qwen2-VL lays them out (S > 25)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        t, h, w = int(rng.integers(1, 3)), int(rng.integers(2, 4)), int(rng.integers(2, 5))
        n_before = int(rng.integers(1, S - t * h * w))
        rows.append(vision_positions(n_before, (t, h, w), S - n_before - t * h * w))
    return torch.stack(rows, dim=1)


def test_mrope_matches_rope_for_text():
    """Twin of tests/test_attention.py:91: with t == h == w position ids,
    M-RoPE reduces to plain RoPE."""
    B, S, H, hd = 2, 6, 2, 16
    x = torch.from_numpy(_x(B, S, H, hd, 5))
    pos1 = torch.arange(S).expand(B, S)
    pos3 = pos1.expand(3, B, S)
    np.testing.assert_allclose(apply_mrope(x, pos3, theta=1e6).numpy(),
                               apply_rope(x, pos1, theta=1e6).numpy(), atol=1e-5)


@pytest.mark.parametrize("hd", [16, 128, 148])
def test_mrope_with_distinct_streams_matches_jax(hd):
    """Distinct t/h/w streams at hd 16, 128 (qwen2-vl-7b) and 148 (its
    adapter at r = 8, where the integer slot bounds 18/46/74 are not a
    multiple of the 2:3:3 split): within 1e-5 of the reference, and far
    from plain rope on the temporal stream."""
    B, S, H = 2, 32, 3
    x = _x(B, S, H, hd, hd)
    pos = _streams(B, S, hd)
    assert not torch.equal(pos[0], pos[1]) and not torch.equal(pos[1], pos[2])
    want = np.asarray(jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos.numpy()), theta=1e6))
    got = apply_mrope(torch.from_numpy(x), pos, theta=1e6).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    plain = apply_rope(torch.from_numpy(x), pos[0], theta=1e6).numpy()
    assert np.abs(got - plain).max() > 1e-2


@pytest.mark.parametrize("hd,bounds", [(128, (16, 40, 64)), (148, (18, 46, 74)), (16, (2, 5, 8))])
def test_mrope_slot_bounds_are_the_references(hd, bounds):
    """Each frequency slot reads the stream the reference's integer bounds
    ``half·acc // 8`` give it: moving one stream's positions moves exactly
    that stream's slots (and their rotate-half partners)."""
    B, S, H = 1, 4, 1
    x = torch.from_numpy(_x(B, S, H, hd, 1))
    base = torch.arange(S).expand(3, B, S).clone()
    out = apply_mrope(x, base, theta=1e6)
    lo = 0
    for stream, hi in enumerate(bounds):
        moved = base.clone()
        moved[stream] += 7
        d = (apply_mrope(x, moved, theta=1e6) - out).abs().amax(dim=(0, 1, 2))
        changed = (d > 0).nonzero().flatten().tolist()
        half = hd // 2
        assert changed == list(range(lo, hi)) + list(range(half + lo, half + hi)), stream
        lo = hi


def test_the_adapter_of_qwen2_vl_takes_head_width_148():
    acfg = adapter_config(get_arch("qwen2-vl-7b"), 8)
    assert (acfg.d_model, acfg.n_heads, acfg.n_kv_heads, acfg.hd) == (444, 3, 1, 148)
    assert acfg.rope == "mrope"


@pytest.mark.parametrize("kernel_impl", ["ref", "cuda"])
def test_opset_apply_mrope_is_the_function(kernel_impl):
    """Both OpSets' ``apply_mrope`` compute :func:`apply_mrope` (on the CPU)."""
    x = torch.from_numpy(_x(2, 32, 2, 128, 3))
    pos = _streams(2, 32, 3)
    ops = get_opset(kernel_impl)
    assert torch.equal(ops.apply_mrope(x, pos, 1e6), apply_mrope(x, pos, 1e6))


def test_decode_positions_broadcast_the_write_index():
    """A decode token's positions: (B, 1) for rope, (3, B, 1) with every
    stream at the row's write index for mrope, as the reference's decode
    paths give them (models/layers.py:396, serve/decode.py:59)."""
    pos = torch.tensor([3, 9], dtype=torch.int32)
    assert decode_positions(get_arch("internlm2-1.8b"), pos).tolist() == [[3], [9]]
    got = decode_positions(get_arch("qwen2-vl-7b"), pos)
    assert got.shape == (3, 2, 1) and got.tolist() == [[[3], [9]]] * 3


def test_vision_positions_lay_out_text_image_text():
    """Text ids equal on all streams; the image's t/h/w ids its grid index
    past the prefix; the text after it continues from the largest id + 1."""
    got = vision_positions(3, (1, 2, 3), 4)
    assert got.tolist() == [[0, 1, 2, 3, 3, 3, 3, 3, 3, 6, 7, 8, 9],
                            [0, 1, 2, 3, 3, 3, 4, 4, 4, 6, 7, 8, 9],
                            [0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 7, 8, 9]]
    assert torch.equal(vision_positions(5, (0, 0, 0), 0), torch.arange(5).expand(3, 5))
    video = vision_positions(0, (2, 2, 2), 1)
    assert video[0].tolist() == [0, 0, 0, 0, 1, 1, 1, 1, 2]
