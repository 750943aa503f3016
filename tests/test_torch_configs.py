"""The port's config registry against the JAX package's: all 14 of the
reference's configs — seven dense, four MoE, two SSM (xlstm-125m, the
hybrid jamba) and the vision-language qwen2-vl-7b — field for field
(with their analytic and active parameter counts, ``reduced()``, the
serving window variant and the adapter's widths), ``pruning_init`` at
each reduced config, the configs once refused as a later slice's now
accepted, the trainer's ``--arch`` on the CPU, and the attention
kernels' guards."""

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
from test_torch_cached_step import _assert_tree_close

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.core.init_methods import pruning_init as jax_pruning_init
from repro.core.parallel_adapters import adapter_config as jax_adapter_config
from repro.core.parallel_adapters import adapter_param_count as jax_adapter_param_count
from repro.models.backbone import init_backbone as jax_init_backbone
from repro.runtime import EdgeSession as JaxSession
from repro.runtime import EpochRunner as JaxRunner
from repro.runtime import RunSpec as JaxSpec
from repro_torch import bridge
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.init_methods import pruning_init
from repro_torch.core.parallel_adapters import adapter_config, adapter_param_count
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.optim import adamw_init
from repro_torch.runtime import EdgeSession, EpochRunner, RunSpec, RunSpecError

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PORTED = ["internlm2-1.8b", "t5-base-pac", "bart-large-pac", "t5-large-pac", "gemma2-2b",
          "granite-20b", "musicgen-large", "mixtral-8x7b", "moonshot-v1-16b-a3b", "grok-1-314b",
          "kimi-k2-1t-a32b", "xlstm-125m", "jamba-1.5-large-398b", "qwen2-vl-7b"]
#: the configs the later-slice refusal named before the SSM (A6.5) and
#: mrope (A6.6) slices landed
FORMERLY_LATER = ["jamba-1.5-large-398b", "qwen2-vl-7b", "xlstm-125m"]
#: the adapter's widths (d_a, heads, hd) at r = 8 (ROADMAP A6.1)
ADAPTER_WIDTHS = {"gemma2-2b": (288, 1, 288), "t5-base-pac": (96, 1, 96),
                  "bart-large-pac": (128, 2, 64), "t5-large-pac": (128, 2, 64),
                  "qwen2-vl-7b": (444, 3, 148)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_the_port_registers_the_seven_dense_configs():
    assert list_archs() == sorted(PORTED)
    assert set(list_archs()) <= set(jax_list_archs())


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_the_reference_field_for_field(arch):
    cfg, ref = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert cfg.reduced().param_count() == ref.reduced().param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.reduced().active_param_count() == ref.reduced().active_param_count()
    assert cfg.hd == ref.hd and cfg.n_periods == ref.n_periods
    assert cfg.is_subquadratic() == ref.is_subquadratic()
    assert dataclasses.asdict(cfg.with_window(4096)) == dataclasses.asdict(ref.with_window(4096))
    assert cfg.with_window(4096).is_subquadratic()


@pytest.mark.parametrize("r", [4, 8])
@pytest.mark.parametrize("arch", PORTED)
def test_adapter_widths_equal_the_reference(arch, r):
    for cfg, ref in ((get_arch(arch), jax_get_arch(arch)),
                     (get_arch(arch).reduced(), jax_get_arch(arch).reduced())):
        assert dataclasses.asdict(adapter_config(cfg, r)) == dataclasses.asdict(
            jax_adapter_config(ref, r))
        assert adapter_param_count(cfg, r) == jax_adapter_param_count(ref, r)
    if r == 8 and arch in ADAPTER_WIDTHS:
        acfg = adapter_config(get_arch(arch), r)
        assert (acfg.d_model, acfg.n_heads, acfg.hd) == ADAPTER_WIDTHS[arch]


@pytest.mark.parametrize("arch", PORTED[1:])
def test_pruning_init_matches_the_reference(arch):
    """The adapter drawn by pruning the reduced backbone, bit for bit."""
    ref = jax_get_arch(arch).reduced()
    backbone = jax_init_backbone(jax.random.PRNGKey(0), ref)
    want = jax_pruning_init(jax.random.PRNGKey(1), backbone, ref, r=4)
    got = pruning_init(torch.Generator().manual_seed(1), bridge.to_torch(_np(backbone)),
                       get_arch(arch).reduced(), r=4)
    _assert_tree_close(want, got, atol=0.0)


def test_later_slices_name_exactly_the_configs_still_to_port():
    """None is left: the port lists all 14 of the reference's configs and
    keeps no table of configs still to come."""
    from repro_torch.configs import base

    assert list_archs() == sorted(jax_list_archs())
    assert len(PORTED) == 14 and len(jax_list_archs()) == 14
    assert not hasattr(base, "LATER_SLICES")


@pytest.mark.parametrize("arch", FORMERLY_LATER)
def test_a_config_of_a_later_slice_is_refused_with_its_slice(arch):
    """The configs refused until their slice landed (the SSM configs,
    A6.5; qwen2-vl-7b, mrope, A6.6) are accepted; an unknown name is
    still refused, naming the 14 known."""
    with pytest.raises(KeyError, match="unknown arch") as e:
        get_arch("no-such-arch")
    assert all(a in str(e.value) for a in PORTED)
    with pytest.raises(RunSpecError, match="unknown arch"):
        RunSpec(arch="no-such-arch").validate()
    assert get_arch(arch).name == arch
    assert RunSpec(arch=arch).validate().arch_config() == get_arch(arch)
    assert RunSpec(arch=arch, reduced=True).validate().arch_config() == get_arch(arch).reduced()


@pytest.mark.parametrize("arch", PORTED)
def test_runspec_takes_every_ported_config(arch):
    spec = RunSpec(arch=arch, reduced=True).validate()
    assert spec.arch_config() == get_arch(arch).reduced()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env, timeout=300)


TRAIN = dict(epochs=3, steps_per_epoch=2, batch=2, seq=16)


def test_cli_trains_a_paper_model_on_the_cpu():
    """``--arch bart-large-pac --reduced --device cpu``: the CLI's epoch
    losses are those of the port's session for the same spec (the CLI
    prints four decimals), epoch 0 full and later epochs cached, loss
    falling."""
    out = _cli("--arch", "bart-large-pac", "--reduced", "--device", "cpu", "--epochs", "3",
               "--steps-per-epoch", "2", "--batch", "2", "--seq", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "arch=bart-large-pac-reduced" in out.stdout
    losses = [float(m) for m in re.findall(r"epoch \d+: loss=([0-9.]+)", out.stdout)]
    assert re.findall(r"\((full|cached)\)", out.stdout) == ["full", "cached", "cached"]
    s = EdgeSession(RunSpec(arch="bart-large-pac", reduced=True, **TRAIN), device="cpu").open()
    want = [r.mean_loss for r in EpochRunner(s).run()]
    s.close()
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]


def test_session_on_a_paper_model_matches_the_jax_trainer():
    """The port's session for bart-large-pac, with the JAX session's
    backbone and adapter bridged in after ``open()`` (each package draws
    its own otherwise), gives the JAX trainer's epoch losses within 5e-2:
    INT8 backbone and cache, the reference's int8 trainer tolerance
    (tests/test_cached_step.py:257)."""
    kw = dict(arch="bart-large-pac", reduced=True, quant=8, cache_compress="int8", **TRAIN)
    js = JaxSession(JaxSpec(**kw, kernels="ref")).open()
    backbone, adapter = js.backbone, js.adapter
    want = [r.mean_loss for r in JaxRunner(js).run()]
    js.close()
    ts = EdgeSession(RunSpec(**kw, kernels="cuda"), device="cpu").open()
    ts.backbone, ts.adapter = bridge.to_torch(_np(backbone)), bridge.to_torch(_np(adapter))
    ts.opt = adamw_init(ts.adapter)
    got = [r.mean_loss for r in EpochRunner(ts).run()]
    ts.close()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_cli_refuses_a_config_of_a_later_slice():
    """The config the CLI refused until the mrope slice (A6.6) landed now
    trains: ``--arch qwen2-vl-7b --reduced --device cpu``, epoch 0 full,
    then cached, loss falling; ``--help`` lists it."""
    out = _cli("--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu", "--epochs", "3",
               "--steps-per-epoch", "2", "--batch", "2", "--seq", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "arch=qwen2-vl-7b-reduced" in out.stdout
    assert f"params≈{get_arch('qwen2-vl-7b').reduced().param_count() / 1e6:.1f}M" in out.stdout
    losses = [float(m) for m in re.findall(r"epoch \d+: loss=([0-9.]+)", out.stdout)]
    assert re.findall(r"\((full|cached)\)", out.stdout) == ["full", "cached", "cached"]
    assert losses[-1] < losses[0]
    assert "not ported" not in out.stderr
    assert "qwen2-vl-7b" in _cli("--help").stdout.replace("\n", " ")


def test_cli_trains_an_ssm_config_on_the_cpu():
    """``--arch xlstm-125m --reduced --device cpu``: epoch 0 full, then
    cached, loss falling, the analytic parameter count printed; and the
    help lists the 14 ported configs."""
    out = _cli("--arch", "xlstm-125m", "--reduced", "--device", "cpu", "--epochs", "3",
               "--steps-per-epoch", "2", "--batch", "2", "--seq", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "arch=xlstm-125m-reduced" in out.stdout
    assert f"params≈{get_arch('xlstm-125m').reduced().param_count() / 1e6:.1f}M" in out.stdout
    losses = [float(m) for m in re.findall(r"epoch \d+: loss=([0-9.]+)", out.stdout)]
    assert re.findall(r"\((full|cached)\)", out.stdout) == ["full", "cached", "cached"]
    assert losses[-1] < losses[0]
    helped = _cli("--help").stdout.replace("\n", " ")
    assert all(a in helped for a in PORTED)


def test_cli_trains_an_moe_config_on_the_cpu():
    """``--arch mixtral-8x7b --reduced --device cpu``: epoch 0 full, then
    cached, loss falling, the MoE backbone's parameter count printed."""
    out = _cli("--arch", "mixtral-8x7b", "--reduced", "--device", "cpu", "--epochs", "3",
               "--steps-per-epoch", "2", "--batch", "2", "--seq", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "arch=mixtral-8x7b-reduced" in out.stdout
    assert f"params≈{get_arch('mixtral-8x7b').reduced().param_count() / 1e6:.1f}M" in out.stdout
    losses = [float(m) for m in re.findall(r"epoch \d+: loss=([0-9.]+)", out.stdout)]
    assert re.findall(r"\((full|cached)\)", out.stdout) == ["full", "cached", "cached"]
    assert losses[-1] < losses[0]


def test_moe_active_parameters():
    """The active count drops the experts a token does not use: mixtral's
    46.7 B parameters, 12.9 B active (top 2 of 8)."""
    cfg = get_arch("mixtral-8x7b")
    assert cfg.param_count() == 46_702_788_608
    assert cfg.active_param_count() == 12_879_921_152
    for arch in PORTED[:7]:
        assert get_arch(arch).active_param_count() == get_arch(arch).param_count()


def test_kernel_guards_keep_their_envelope():
    """On the card flash takes hd 64, 112, 128 and 256 only, and paged
    attention those widths with at most 8 query rows a kv head; the plan
    refuses the rest too."""
    for hd in fa.HEAD_DIMS:
        fa.require_head_dim(hd)
        pa.require_card_shape(hd, pa.MAX_ROWS)
    assert fa.HEAD_DIMS == pa.HEAD_DIMS == (64, 112, 128, 256)
    for hd in (32, 96, 120, 192, 512):
        with pytest.raises(ValueError, match="head dim"):
            fa.require_head_dim(hd)
        with pytest.raises(ValueError, match="head dim"):
            pa.require_card_shape(hd, 2)
        with pytest.raises(ValueError):
            pa.plan(8, 4, 2, hd, 16, 34, 0, 132)
    with pytest.raises(ValueError, match="n_rep"):
        pa.require_card_shape(256, pa.MAX_ROWS + 1)
    with pytest.raises(ValueError):
        pa.plan(1, 1, 48, 128, 16, 34, 0, 132)  # granite-20b's MQA, n_rep 48
