"""The port's trainer against the JAX reference: the corpus and its
epoch order bit for bit, the RunSpec's refusals, the device rule, and
whole ``--reduced`` runs of ``EdgeSession``/``EpochRunner`` whose
per-epoch losses match the JAX session's (epoch 0 full, later epochs
cached), plus the CLI on the CPU."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JaxPipeline
from repro.data import SyntheticPersonalCorpus as JaxCorpus
from repro.runtime import EdgeSession as JaxSession
from repro.runtime import EpochRunner as JaxRunner
from repro.runtime import RunSpec as JaxSpec
from repro_torch import bridge
from repro_torch.data import DataPipeline, SyntheticPersonalCorpus
from repro_torch.optim import adamw_init
from repro_torch.runtime import ConsoleHook, EdgeSession, EpochRunner, RunSpec, RunSpecError

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("vocab,seq,n,seed", [(512, 17, 8, 0), (92544, 33, 12, 3)])
def test_corpus_and_epoch_order_are_identical(vocab, seq, n, seed):
    jc, tc = JaxCorpus(vocab, seq, n, seed=seed), SyntheticPersonalCorpus(vocab, seq, n, seed=seed)
    np.testing.assert_array_equal(tc.tokens, jc.tokens)
    np.testing.assert_array_equal(tc.classes, jc.classes)
    jp, tp = JaxPipeline(jc, global_batch=4, seed=seed), DataPipeline(tc, global_batch=4, seed=seed)
    assert tp.steps_per_epoch() == jp.steps_per_epoch()
    for epoch in range(3):
        for a, b in zip(tp.epoch_order(epoch), jp.epoch_order(epoch)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tp.epoch(epoch), jp.epoch(epoch)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("field,value", [("plan", "auto"), ("pool", 4), ("calibrate", True),
                                         ("save_plan", "p.json")])
def test_runspec_refuses_later_slices(field, value):
    """The planner's four fields, refused until the planner slice, now
    validate as the reference's do, with the same derived layout."""
    spec, ref = RunSpec(**{field: value}).validate(), JaxSpec(**{field: value}).validate()
    assert getattr(spec, field) == value
    assert {k: v for k, v in spec.to_dict().items() if k != "kernels"} == {
        k: v for k, v in ref.to_dict().items() if k != "kernels"}
    assert (spec.plan_mode, spec.default_micro()) == (ref.plan_mode, ref.default_micro())


@pytest.mark.parametrize("field,value", [("kernels", "pallas"), ("init", "lora"), ("quant", 3),
                                         ("cache_compress", "fp8"), ("batch", 0),
                                         ("arch", "no-such-arch")])
def test_runspec_refuses_bad_values(field, value):
    with pytest.raises(RunSpecError):
        RunSpec(**{field: value}).validate()


def test_runspec_round_trips_and_reads_the_reference_json():
    spec = RunSpec(reduced=True, quant=8, cache_compress="int8", kernels="ref")
    assert RunSpec.from_json(spec.to_json()) == spec
    assert RunSpec().kernels == "cuda"
    ref = JaxSpec(reduced=True, quant=8, cache_compress="int8")
    assert RunSpec.from_json(ref.to_json()).validate().to_dict() == ref.to_dict()
    with pytest.raises(RunSpecError):
        RunSpec.from_dict({"nope": 1})


def test_session_without_a_card_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeSession(RunSpec(reduced=True))
    assert EdgeSession(RunSpec(reduced=True), device="cpu").device.type == "cpu"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("compress,kernels,quant", [
    pytest.param("f32", "cuda", 8, id="f32-cuda"), pytest.param("int8", "cuda", 8, id="int8-cuda"),
    pytest.param("int8", "ref", 8, id="int8-ref"),
    pytest.param("int8", "cuda", 4, id="int8-cuda-int4"),
    pytest.param("int8", "ref", 4, id="int8-ref-int4")])
def test_reduced_run_matches_the_jax_session(compress, kernels, quant):
    """The reference's acceptance run (3 epochs x 2 steps, batch 2, seq
    16, INT8 backbone, or INT4: ``--quant 4``): the port's session, with the JAX session's
    backbone and adapter bridged in after ``open()``, gives the same
    per-epoch losses — f32 within 5e-4, int8 within 5e-2, the
    reference's own tolerances (tests/test_cached_step.py:257): under
    ``cuda`` epoch 0 trains on taps already quantized at the tap site,
    where the reference's ``ref`` path trains on f32 taps."""
    kw = dict(reduced=True, epochs=3, steps_per_epoch=2, batch=2, seq=16, quant=quant,
              cache_compress=compress)
    js = JaxSession(JaxSpec(**kw, kernels="ref")).open()
    backbone, adapter = js.backbone, js.adapter
    want = JaxRunner(js).run()
    js.close()
    ts = EdgeSession(RunSpec(**kw, kernels=kernels), device="cpu").open()
    ts.backbone = bridge.to_torch(_np(backbone))
    ts.adapter = bridge.to_torch(_np(adapter))
    ts.opt = adamw_init(ts.adapter)
    lines = []
    got = EpochRunner(ts, hooks=[ConsoleHook(lines.append)]).run()
    assert [r.mode for r in got] == ["full", "cached", "cached"] == [r.mode for r in want]
    assert len(ts.cache) == 4 and ts.cache.compress == compress
    ts.close()
    tol = 5e-4 if (compress == "f32" or kernels == "ref") else 5e-2
    for a, b in zip(got, want):
        assert abs(a.mean_loss - b.mean_loss) < tol, ([r.mean_loss for r in got],
                                                       [r.mean_loss for r in want])
    assert got[-1].mean_loss < got[0].mean_loss
    assert re.fullmatch(r"epoch 2: loss=[0-9.]+ time=[0-9.]+s \(cached\) cache\[4 seqs, 0 MB, "
                        + compress + r"\]", lines[-1])


def test_cli_on_the_cpu(tmp_path):
    """The reference's CLI run, with ``--cache-dir`` and ``--ckpt``: the
    first run trains full then cached and writes the checkpoint and the
    cache manifest; a second run over the same directory is warm (every
    epoch cached) and gives the same losses."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
           "--epochs", "3", "--steps-per-epoch", "2", "--batch", "2", "--seq", "16",
           "--quant", "8", "--cache-compress", "int8", "--cache-dir", str(tmp_path / "act"),
           "--ckpt", str(tmp_path / "adapter.msgpack")]
    runs = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        # the reference CLI test's regex (tests/test_cached_step.py:241)
        losses = [float(m) for m in re.findall(r"epoch \d+: loss=([0-9.]+)", out.stdout)]
        modes = re.findall(r"\((full|cached)\)", out.stdout)
        assert len(losses) == 3 and losses[-1] < losses[0]
        assert "checkpoint: " in out.stdout and "cache manifest: " in out.stdout
        runs.append((losses, modes, out.stdout))
    assert runs[0][1] == ["full", "cached", "cached"]
    assert runs[1][1] == ["cached"] * 3 and "warm manifest" in runs[1][2]
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=0, atol=1e-4)
    assert (tmp_path / "adapter.msgpack").exists()
    assert (tmp_path / "act" / "manifest.json").exists()


def test_importing_the_training_slice_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.train, repro_torch.kernels.cached_step, "
            "repro_torch.core.activation_cache, repro_torch.core.init_methods; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
