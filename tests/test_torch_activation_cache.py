"""The port's activation cache against the JAX reference: byte counts,
payloads, the compressed and decompressed batch handoff, storage-form
adoption, eviction and spill — and spill shards that each package
reads from the other."""

import os

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import activation_cache as jac
from repro.core.quantization import quantize as jax_quantize
from repro_torch.configs import get_arch
from repro_torch.core import activation_cache as tac
from repro_torch.core.quantization import QTensor, quantize

POLICIES = ["f32", "bf16", "int8"]
N_P, B, S, D = 2, 3, 5, 300  # D not a multiple of the 128 block


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b0 = rng.standard_normal((B, S, D)).astype(np.float32)
    taps = rng.standard_normal((N_P, B, S, D)).astype(np.float32) * 4
    bf = rng.standard_normal((B, S, D)).astype(np.float32)
    return b0, taps, bf


def _pair(policy, seed=0, **kw):
    b0, taps, bf = _batch(seed)
    j = jac.ActivationCache(budget_bytes=1 << 30, compress=policy, **kw)
    t = tac.ActivationCache(budget_bytes=1 << 30, compress=policy, **kw)
    keys = [10 + i for i in range(B)]
    j.put_batch(keys, b0, taps, bf)
    t.put_batch(keys, torch.from_numpy(b0), torch.from_numpy(taps), torch.from_numpy(bf))
    return j, t, keys


def _bits(x) -> np.ndarray:
    """A payload's raw bytes (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).view(np.uint8)


def _assert_ct_equal(jct, tct):
    assert (jct.policy, jct.orig_last, jct.block) == (tct.policy, tct.orig_last, tct.block)
    np.testing.assert_array_equal(_bits(tct.data), _bits(jct.data))
    if jct.scale is None:
        assert tct.scale is None
    else:
        np.testing.assert_array_equal(tct.scale.numpy(), np.asarray(jct.scale))
    assert tct.nbytes == jct.nbytes


@pytest.mark.parametrize("policy", POLICIES)
def test_put_batch_entries_and_bytes_match_reference(policy):
    j, t, keys = _pair(policy)
    assert len(t) == len(j) == B and t.nbytes == j.nbytes
    for k in keys:
        for (_, jct), (_, tct) in zip(j._ram[k].parts(), t._ram[k].parts()):
            _assert_ct_equal(jct, tct)


@pytest.mark.parametrize("policy", POLICIES)
def test_get_batch_matches_reference(policy):
    j, t, keys = _pair(policy)
    order = [keys[2], keys[0]]
    want = j.get_batch(order, with_final=True)
    got = t.get_batch(order, with_final=True)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = j.get_batch(order, with_final=True, dtype=None, compressed=True)
    got = t.get_batch(order, with_final=True, dtype=None, compressed=True)
    for w, g in zip(want, got):
        if policy == "int8":
            assert isinstance(g, QTensor) and g.q.dtype == torch.int8 and g.orig_last == D
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w["q"]))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w["scale"]))
        else:
            assert g.dtype == (torch.bfloat16 if policy == "bf16" else torch.float32)
            np.testing.assert_array_equal(_bits(g), _bits(w))
    assert got[1].shape[:2] == (N_P, 2)
    assert t.get_batch([keys[0], 999]) is None and j.get_batch([keys[0], 999]) is None
    assert (t.hits, t.misses) == (j.hits, j.misses)


def test_storage_form_taps_are_adopted():
    """An int8 QTensor from the tap site is stored as it is, equal to the
    reference adopting its {"q", "scale"} dict; other policies refuse it."""
    b0, taps, bf = _batch(1)
    jq = [jax_quantize(x, bits=8, block=128) for x in (b0, taps, bf)]
    j = jac.ActivationCache(budget_bytes=1 << 30, compress="int8")
    j.put_batch([0, 1, 2], *({"q": q.q, "scale": q.scale} for q in jq), orig_last=D)
    t = tac.ActivationCache(budget_bytes=1 << 30, compress="int8")
    t.put_batch([0, 1, 2], *(quantize(torch.from_numpy(x), 8, 128) for x in (b0, taps, bf)),
                orig_last=D)
    for k in range(3):
        for (_, jct), (_, tct) in zip(j._ram[k].parts(), t._ram[k].parts()):
            _assert_ct_equal(jct, tct)
    with pytest.raises(ValueError):
        tac.ActivationCache(compress="bf16").put_batch(
            [0, 1, 2], quantize(torch.from_numpy(b0), 8, 128), torch.from_numpy(taps))


@pytest.mark.parametrize("policy", POLICIES)
def test_spill_shards_read_across_packages(policy, tmp_path):
    """An entry spilled by either package loads in the other, equal."""
    j, t, keys = _pair(policy)
    k = keys[1]
    tpath, jpath = tmp_path / "port.npz", tmp_path / "ref.npz"
    np.savez(tpath, **tac._entry_to_npz(t._ram[k]))
    np.savez(jpath, **jac._entry_to_npz(j._ram[k]))
    with np.load(tpath) as z:
        from_port = jac._entry_from_npz(z)
    with np.load(jpath) as z:
        from_ref = tac._entry_from_npz(z)
    for (_, a), (_, b) in zip(from_port.parts(), t._ram[k].parts()):
        _assert_ct_equal(a, b)
    for (_, a), (_, b) in zip(j._ram[k].parts(), from_ref.parts()):
        _assert_ct_equal(a, b)


@pytest.mark.parametrize("policy", ["f32", "int8"])
def test_eviction_spill_and_promotion_match_reference(policy, tmp_path):
    """Under a budget of two entries, the same operations leave the same
    keys in RAM and on disk, the same hit/miss counts and byte totals."""
    b0, taps, bf = _batch(2)
    one = jac.CacheEntry(*(jac._compress(x[0] if x is not taps else x[:, 0], policy)
                           for x in (b0, taps, bf))).nbytes
    caches = [jac.ActivationCache(budget_bytes=2 * one, compress=policy,
                                  spill_dir=str(tmp_path / "ref")),
              tac.ActivationCache(budget_bytes=2 * one, compress=policy,
                                  spill_dir=str(tmp_path / "port"))]
    for c in caches:
        conv = np.asarray if c.__class__ is jac.ActivationCache else torch.from_numpy
        for k in range(B):
            c.put(k, conv(b0[k]), conv(taps[:, k]), conv(bf[k]))
        c.get(0, with_final=True)          # a disk hit, promoted
        c.put(1, conv(b0[1]), conv(taps[:, 1]), conv(bf[1]))  # re-put replaces
        c.get(7)
    j, t = caches
    assert (set(t._ram), set(t._disk)) == (set(j._ram), set(j._disk))
    assert (t.hits, t.misses, t.nbytes, len(t)) == (j.hits, j.misses, j.nbytes, len(j))
    assert t.covers(range(B), with_final=True)
    got = t.get(2, with_final=True)
    want = j.get(2, with_final=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    paths = list(t._disk.values())
    t.clear()
    assert len(t) == 0 and t.nbytes == 0 and not any(os.path.exists(p) for p in paths)


def test_oversized_entry_goes_to_disk_and_put_owns_its_bytes(tmp_path):
    b0, taps, bf = _batch(3)
    t = tac.ActivationCache(budget_bytes=100, compress="f32", spill_dir=str(tmp_path))
    t.put(0, torch.from_numpy(b0[0]), torch.from_numpy(taps[:, 0]))
    assert 0 in t._disk and t.nbytes == 0
    assert t.get(0, with_final=True) is None  # stored without b_final
    x = torch.from_numpy(b0[1].copy())
    big = tac.ActivationCache(compress="f32")
    big.put(1, x, torch.from_numpy(taps[:, 1]))
    x.zero_()
    np.testing.assert_array_equal(big.get(1)[0].numpy(), b0[1])


@pytest.mark.parametrize("policy", POLICIES)
def test_storage_cost_model_matches_reference(policy):
    jcfg, tcfg = jax_get_arch("internlm2-1.8b"), get_arch("internlm2-1.8b")
    bpv = tac.policy_bytes_per_value(policy)
    assert bpv == jac.policy_bytes_per_value(policy)
    for wf in (False, True):
        assert (tac.cache_bytes_per_sequence(tcfg, 512, bpv, with_final=wf)
                == jac.cache_bytes_per_sequence(jcfg, 512, bpv, with_final=wf))
