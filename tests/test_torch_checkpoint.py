"""The port's checkpoint format, persistent activation cache and
session outputs against the JAX reference.

* Checkpoints cross both ways bit for bit (the file bytes too),
  including ``QTensor``, tuple and scalar leaves; a bf16 leaf is
  refused; the port packs msgpack itself (the card's machine has no
  ``msgpack`` package).
* ``EdgeSession`` with ``ckpt`` writes a file JAX's ``load_checkpoint``
  reads equal to the session's adapter; ``snapshot``/``restore`` round
  trip; ``serving_engine()`` serves the trained adapter as ``"local"``.
* A warm ``cache_dir`` rerun runs no backbone forward and gives the
  same losses; a seed change, or a directory the JAX package wrote,
  invalidates the cache loudly and re-captures it.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint import tree_fingerprint as jax_fingerprint
from repro.core.quantization import QTensor as JaxQTensor
from repro.core.quantization import quantize as jax_quantize
from repro.runtime import EdgeSession as JaxSession
from repro.runtime import RunSpec as JaxSpec
from repro_torch import bridge
from repro_torch.checkpoint import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
    tree_fingerprint,
)
from repro_torch.checkpoint.io import packb, unpackb
from repro_torch.core import steps
from repro_torch.core.parallel_adapters import init_adapter_cache
from repro_torch.core.quantization import QTensor, tree_leaves
from repro_torch.models.backbone import init_cache
from repro_torch.runtime import EdgeSession, EpochRunner, RunSpec, RunSpecError

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -1, -32, -33,
    -128, -129, -32769, -2 ** 31 - 1, -2 ** 63, 0.25, -1e300, "", "x" * 31, "x" * 32,
    "é" * 200, "y" * 70000, b"", b"z" * 256, b"z" * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"nested": [1, {"deep": None}, "s"]},
], ids=lambda v: repr(v)[:24])
def test_msgpack_subset_equals_msgpack(value):
    """The port's packer writes msgpack-python's bytes (smallest
    encoding of each value) and its reader inverts them."""
    want = msgpack.packb(value, use_bin_type=True)
    assert packb(value) == want
    back = unpackb(want)
    assert (bytes(back) if isinstance(back, memoryview) else back) == value


def _tree(rng):
    """Every leaf kind of the framing: float/int/bool arrays (a 0-d one
    too), an int8 QTensor, a tuple, a list, scalars."""
    w = rng.standard_normal((4, 256)).astype(np.float32)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "count": np.array(7, np.int32),
        "mask": rng.random((2, 3)) > 0.5,
        "q": jax_quantize(jnp.asarray(w), 8),
        "pair": (np.arange(4, dtype=np.int32), [1.5, "name", None, True, -3]),
        "config": "internlm2-1.8b-reduced",
    }


def _assert_tree_equal(got, want):
    """Port tree (tensors, QTensor) against a JAX/numpy tree, bit for bit."""
    if isinstance(want, JaxQTensor):
        assert isinstance(got, QTensor)
        assert (got.bits, got.block, got.orig_last) == (want.bits, want.block, want.orig_last)
        _assert_tree_equal(got.q, want.q)
        _assert_tree_equal(got.scale, want.scale)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    elif isinstance(want, (np.ndarray, jax.Array)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_bit_for_bit(direction, tmp_path):
    tree = _tree(np.random.default_rng(0))
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jax_save(jpath, tree)
    n = save_checkpoint(tpath, bridge.to_torch(tree))
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes() and n == os.path.getsize(jpath)
    assert not Path(tpath + ".tmp").exists()
    if direction == "jax_to_port":
        _assert_tree_equal(load_checkpoint(jpath, device="cpu"), tree)
    else:
        _assert_tree_equal(bridge.to_torch(jax_load(tpath)), tree)


def test_bf16_leaves_are_refused(tmp_path):
    """numpy has no bf16 dtype string: the reference writes ``|V2`` and
    cannot read its own file back; the port refuses to write such a
    leaf, and names the problem when it meets the reference's file."""
    path = tmp_path / "bf16.msgpack"
    with pytest.raises(CheckpointError, match="bfloat16 leaf at .adapter.w"):
        save_checkpoint(str(path), {"adapter": {"w": torch.zeros(2, dtype=torch.bfloat16)}})
    assert not path.exists() and not Path(str(path) + ".tmp").exists()
    jax_save(str(path), {"w": jnp.zeros(2, jnp.bfloat16)})
    with pytest.raises(CheckpointError, match="bfloat16"):
        load_checkpoint(str(path), device="cpu")


def test_load_checkpoint_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``device=None`` means the card, as for the port's other entry
    points: with no card it raises, and only ``device="cpu"`` runs."""
    path = str(tmp_path / "a.msgpack")
    save_checkpoint(path, {"x": torch.arange(3.0)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)
    assert load_checkpoint(path, device="cpu")["x"].device.type == "cpu"


def test_checkpoint_needs_no_msgpack_package(tmp_path):
    """Save, load and fingerprint with ``msgpack`` made unimportable, as
    on the card's machine."""
    code = ("import sys; sys.modules['msgpack'] = None\n"
            "import torch\n"
            "from repro_torch.checkpoint import (load_checkpoint, save_checkpoint,\n"
            "                                    tree_fingerprint)\n"
            f"p = {str(tmp_path / 'a.msgpack')!r}\n"
            "t = {'x': torch.arange(6.).reshape(2, 3), 'n': (1, 'a')}\n"
            "save_checkpoint(p, t); b = load_checkpoint(p, device='cpu')\n"
            "assert torch.equal(b['x'], t['x']) and b['n'] == (1, 'a')\n"
            "assert len(tree_fingerprint(t)) == 16\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_tree_fingerprint_detects_changes():
    """Equal trees hash equal; a one-bit flip or a changed structure
    changes the digest; the digest is the port's own, never the
    reference's (which hashes JAX's treedef repr)."""
    rng = np.random.default_rng(3)
    tree = bridge.to_torch({"a": rng.standard_normal((4, 4)).astype(np.float32),
                            "b": [np.arange(3, dtype=np.int32)]})
    fp = tree_fingerprint(tree)
    assert fp == tree_fingerprint(bridge.to_torch({"b": [np.arange(3, dtype=np.int32)],
                                                   "a": tree["a"].numpy()}))
    flipped = {"a": tree["a"].clone(), "b": tree["b"]}
    flipped["a"].view(torch.int32)[0, 0] ^= 1
    assert tree_fingerprint(flipped) != fp
    assert tree_fingerprint({"a": tree["a"], "b": tuple(tree["b"])}) != fp
    assert fp != jax_fingerprint(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))


KW = dict(reduced=True, steps_per_epoch=2, batch=2, seq=16, quant=8, cache_compress="int8")


def test_session_checkpoint_reads_in_jax(tmp_path):
    """``run()`` ends in ``finish()``: the checkpoint holds ``{"adapter",
    "config"}`` and JAX's ``load_checkpoint`` reads the adapter equal,
    bit for bit, to the session's."""
    ckpt = str(tmp_path / "adapter.msgpack")
    s = EdgeSession(RunSpec(**KW, epochs=1, ckpt=ckpt), device="cpu")
    s.run()
    loaded = jax_load(ckpt)
    assert loaded["config"] == s.cfg.name
    _assert_tree_equal(s.adapter, loaded["adapter"])


def _run(spec, monkeypatch, capsys):
    """One session run; (epoch reports, backbone forwards, stderr, session)."""
    forwards = []
    real = steps.backbone_forward

    def counted(*a, **k):
        forwards.append(1)
        return real(*a, **k)

    monkeypatch.setattr(steps, "backbone_forward", counted)
    s = EdgeSession(spec, device="cpu")
    reports = s.run()
    return reports, len(forwards), capsys.readouterr().err, s


def test_warm_cache_dir_rerun_and_seed_change(tmp_path, monkeypatch, capsys):
    """Run 1 fills ``cache_dir``; run 2 reopens it warm: every epoch
    cached, zero backbone forwards, the same losses (the cuda OpSet's
    epoch-1 loss already reads the int8 taps the cache stores). A new
    seed changes the backbone and corpus fingerprints: invalidated
    loudly, re-captured."""
    spec = RunSpec(**KW, epochs=2, cache_dir=str(tmp_path / "act"))
    cold, n_cold, _, _ = _run(spec, monkeypatch, capsys)
    assert [r.mode for r in cold] == ["full", "cached"] and n_cold == 2
    assert (tmp_path / "act" / "manifest.json").exists()
    warm, n_warm, _, s = _run(spec, monkeypatch, capsys)
    assert s.warm and [r.mode for r in warm] == ["cached", "cached"] and n_warm == 0
    np.testing.assert_allclose([r.mean_loss for r in warm], [r.mean_loss for r in cold],
                               rtol=0, atol=1e-6)
    new, n_new, err, s = _run(spec.replace(seed=1, epochs=1), monkeypatch, capsys)
    assert "ACTIVATION CACHE INVALIDATED" in err and "backbone" in err and "corpus" in err
    assert not s.warm and [r.mode for r in new] == ["full"] and n_new == 2


def test_cache_dir_of_the_jax_package_is_recaptured(tmp_path, monkeypatch, capsys):
    """The JAX session's manifest fails the port's identity check (the
    fingerprints differ by construction): the port invalidates it and
    re-captures instead of reading the other package's entries."""
    cache_dir = str(tmp_path / "act")
    js = JaxSession(JaxSpec(**KW, epochs=1, cache_dir=cache_dir))
    js.run()
    assert (tmp_path / "act" / "manifest.json").exists()
    reports, n, err, s = _run(RunSpec(**KW, epochs=1, cache_dir=cache_dir), monkeypatch, capsys)
    assert "ACTIVATION CACHE INVALIDATED" in err and "backbone" in err
    assert not s.warm and [r.mode for r in reports] == ["full"] and n == 2


def test_snapshot_restore_round_trip(tmp_path):
    """A snapshot saved to disk and restored into a fresh session gives
    back the adapter and optimizer state bit for bit, and the caller's
    cursor; a snapshot of another arch is refused."""
    spec = RunSpec(**KW, epochs=1)
    s = EdgeSession(spec, device="cpu").open()
    EpochRunner(s).run()
    path = s.save_snapshot(str(tmp_path / "snap.msgpack"), extra={"epoch": 1, "step": 2})
    t = EdgeSession(spec, device="cpu").open()
    assert t.restore_snapshot(path) == {"epoch": 1, "step": 2}
    for a, b in zip(tree_leaves((t.adapter, t.opt)), tree_leaves((s.adapter, s.opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(RunSpecError, match="snapshot is for arch"):
        t.restore({**s.snapshot(), "config": "other-arch"})
    s.close()
    t.close()


def test_serving_engine_serves_the_trained_adapter():
    """``serving_engine()`` serves the session's adapter as ``"local"``
    from its backbone: the stream equals the one-request
    ``pac_decode_step`` greedy loop over the same prompt (f32 KV)."""
    spec = RunSpec(**KW, epochs=1)
    s = EdgeSession(spec, device="cpu").open()
    EpochRunner(s).run()
    prompt, n_new, max_len = [3, 9, 4, 1, 7], 4, 16
    eng = s.serving_engine(kv_policy="f32", page_size=4, max_len=max_len, max_batch=2)
    assert eng.adapter_names == ["local"]
    handle = eng.submit(prompt, "local", max_new_tokens=n_new)
    eng.drain()
    got = handle.result()
    cache = init_cache(s.cfg, 1, max_len)
    acache = init_adapter_cache(s.cfg, 1, max_len, r=spec.r)
    seq = list(prompt)
    for pos in range(len(prompt) + n_new - 1):
        lg, cache, acache = steps.pac_decode_step(
            s.backbone, s.adapter, {"tokens": torch.tensor([[seq[pos]]], dtype=torch.int32)},
            cache, acache, pos, cfg=s.cfg, r=spec.r, kernel_impl="cuda")
        if pos >= len(prompt) - 1:
            seq.append(int(lg[0, 0].argmax()))
    assert got == seq[len(prompt):]
    s.close()
