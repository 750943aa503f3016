"""The ``ref`` OpSet's blocked attention against the reference's
``repro.models.layers.flash_attention`` (the twin of
``tests/test_attention.py``): values and ``torch.autograd.grad`` of
(q, k, v) against ``jax.grad`` over window x soft-cap x ``block_k``,
uneven key padding, grouped heads at n_rep 1, 2 and 7 through
``ref_attention_core``, and block sizes that differ; the backward saves
no score-sized tensor. Inputs are drawn with numpy from a seed.

Tolerances: values 2e-5 and gradients 3e-4, the reference's own
(``tests/test_attention.py``); both packages sum the same blocks in f32
in the same order, so the differences seen are ~1e-6."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers

torch.set_num_threads(2)
VALUE_TOL, GRAD_TOL = 2e-5, 3e-4


def _qkv(seed, B=2, H=3, Sq=37, hd=16, Sk=None, Hk=None):
    rng = np.random.default_rng(seed)
    Sk, Hk = Sk or Sq, Hk or H
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, Hk, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, Hk, Sk, hd)).astype(np.float32))


def _loss_j(fn):
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * jnp.cos(o))
    return loss


def _both(q, k, v, q_pos, k_pos, window, cap, block_k):
    """(port out, port grads, reference out, reference grads)."""
    jfn = lambda q, k, v: jlayers.flash_attention(  # noqa: E731
        q, k, v, jnp.asarray(q_pos), jnp.asarray(k_pos), True, window, cap, block_k)
    j_out = jfn(q, k, v)
    j_grads = jax.grad(_loss_j(jfn), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = layers.flash_attention(tq, tk, tv, torch.tensor(q_pos), torch.tensor(k_pos), True,
                                   window, cap, block_k)
    t_grads = torch.autograd.grad((t_out * torch.cos(t_out)).sum(), (tq, tk, tv))
    return t_out, t_grads, j_out, j_grads


def _close(t_out, t_grads, j_out, j_grads):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=VALUE_TOL)
    for a, b in zip(t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("block_k", [7, 16, 64])
def test_blocked_attention_matches_the_reference(window, cap, block_k):
    q, k, v = _qkv(0)
    pos = np.arange(q.shape[2])
    _close(*_both(q, k, v, pos, pos, window, cap, block_k))


def test_uneven_key_padding_matches_the_reference():
    """Sk not a multiple of block_k (the padded tail at the sentinel
    position), queries after the keys."""
    q, k, v = _qkv(2, Sq=11, Sk=29)
    _close(*_both(q, k, v, np.arange(11) + 18, np.arange(29), None, None, 8))


def test_queries_without_a_key_get_the_mean_of_v():
    """A window with no key in reach: the reference's answer, V's mean
    (every masked score is the same -1e30), and its gradients."""
    q, k, v = _qkv(3, Sq=9, Sk=12)
    q_pos, k_pos = np.arange(9) + 40, np.arange(12)
    t_out, t_grads, j_out, j_grads = _both(q, k, v, q_pos, k_pos, 5, None, 4)
    _close(t_out, t_grads, j_out, j_grads)
    np.testing.assert_allclose(t_out.detach().numpy(),
                               np.broadcast_to(v.mean(axis=2, keepdims=True), t_out.shape),
                               atol=VALUE_TOL)


@pytest.mark.parametrize("n_rep", [1, 2, 7])
@pytest.mark.parametrize("window,cap", [(None, None), (6, 30.0)])
def test_grouped_head_core_matches_the_reference(n_rep, window, cap):
    """``ref_attention_core``: the n_rep query heads sharing a kv head
    folded into the row axis, against the reference's core, value and
    gradients."""
    B, S, hkv, hd = 2, 13, 2, 8
    rng = np.random.default_rng(10 + n_rep)
    q = rng.standard_normal((B, S, hkv * n_rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, hd)).astype(np.float32)
    cfg = SimpleNamespace(n_heads=hkv * n_rep, n_kv_heads=hkv, hd=hd, attn_softcap=cap)
    spec = SimpleNamespace(window=window)
    jfn = lambda q, k, v: jlayers.ref_attention_core(q, k, v, cfg, spec, 4)  # noqa: E731
    j_out, j_grads = jfn(q, k, v), jax.grad(_loss_j(jfn), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_out = layers.ref_attention_core(tq, tk, tv, cfg, spec, 4)
    t_grads = torch.autograd.grad((t_out * torch.cos(t_out)).sum(), (tq, tk, tv))
    assert t_out.shape == (B, S, hkv * n_rep * hd)
    _close(t_out, t_grads, j_out, j_grads)


def test_block_size_does_not_change_the_result():
    """Block sizes that differ, dividing Sk or not, give the same values
    and gradients (the reference's block-invariance test)."""
    q, k, v = _qkv(8, B=1, H=2, Sq=29, hd=8)
    pos = torch.arange(29)
    outs = []
    for bk in (4, 8, 29, 64):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = layers.flash_attention(tq, tk, tv, pos, pos, True, None, None, bk)
        outs.append((o.detach(), torch.autograd.grad((o * torch.cos(o)).sum(), (tq, tk, tv))))
    for o, g in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0][0].numpy(), atol=VALUE_TOL)
        for a, b in zip(g, outs[0][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_TOL)


def test_backward_saves_no_score_sized_tensor():
    """The Function keeps q, k, v, o, lse and the two position vectors:
    nothing with an (Sq, Sk) pair of axes, however many blocks."""
    q, k, v = _qkv(5, B=1, H=2, Sq=48, hd=8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    pos = torch.arange(48)
    for bk in (16, 48):
        o = layers.flash_attention(tq, tk, tv, pos, pos, True, None, 30.0, bk)
        saved = o.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [
            (1, 2, 48, 8), (1, 2, 48, 8), (1, 2, 48, 8), (48,), (48,), (1, 2, 48, 8), (1, 2, 48)]
        assert all(t.numel() < 48 * 48 for t in saved)
