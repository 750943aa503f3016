"""The port's twins of the reference's last free functions, each against
the reference on seeded numpy inputs: SGD with momentum and the two
learning-rate schedules (``repro.optim``), ``glue_like_task``
(``repro.data``: the corpus's tokens bit for bit), ``layer_norm``
(``repro.models.layers``), ``pac_loss_fn`` (``repro.core.steps``: the
loss and the adapter's gradient, and the gradient highway: no block and
no embedding gets a gradient) and ``register_opset``
(``repro.core.opset``: a registered factory resolves by name, one
instance per (name, tap_policy), in both packages).

Tolerances: the optimizer and the norm 1e-6 (f32 elementwise ops in the
same order), the schedules 1e-6 relative (the reference's f32 against
the port's float), the loss 1e-5 and the gradient 1e-4 (the reference's
step tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import opset as jopset
from repro.core import steps as jsteps
from repro.core.parallel_adapters import init_adapter
from repro.data.pipeline import _GLUE_SIZES as JAX_GLUE_SIZES
from repro.data.pipeline import glue_like_task as jax_glue_like_task
from repro.models import backbone as jbb
from repro.models.layers import layer_norm as jax_layer_norm
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import linear_warmup as jax_warmup
from repro.optim import sgdm_init as jax_sgdm_init
from repro.optim import sgdm_update as jax_sgdm_update
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import opset, steps
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.data import glue_like_task
from repro_torch.data.pipeline import _GLUE_SIZES
from repro_torch.models.layers import layer_norm
from repro_torch.optim import cosine_schedule, linear_warmup, sgdm_init, sgdm_update
from repro_torch.runtime import RunSpec, RunSpecError
from repro_torch.runtime.spec import KERNEL_IMPLS

torch.set_num_threads(2)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = [rng.standard_normal((7,)).astype(dtype), rng.standard_normal((3, 2)).astype(dtype)]
    return {"b": b, "w": rng.standard_normal((5, 7)).astype(dtype)}  # keys in JAX's order


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sgdm_matches_the_reference_over_steps(dtype):
    """Three momentum steps: the f32 momentum, and the parameters cast
    back to their dtype."""
    params = _tree(0)
    cast_j = (lambda t: jnp.asarray(t, jnp.bfloat16)) if dtype == "bf16" else jnp.asarray
    cast_t = (lambda t: torch.tensor(t).to(torch.bfloat16)) if dtype == "bf16" else torch.tensor
    jp, tp = jax.tree.map(cast_j, params), tree_map(cast_t, params)
    js, ts = jax_sgdm_init(jp), sgdm_init(tp)
    for step in range(3):
        g = _tree(10 + step)
        jp, js = jax_sgdm_update(jp, g, js, lr=0.05, momentum=0.8)
        tp, ts = sgdm_update(tp, tree_map(torch.tensor, g), ts, lr=0.05, momentum=0.8)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(a.dtype).endswith("bfloat16" if dtype == "bf16" else "float32")
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=1e-6)
    for a, b in zip(tree_leaves(ts["m"]), jax.tree.leaves(js["m"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("tensor_step", [False, True])
def test_schedules_match_the_reference(tensor_step):
    for step in range(0, 120, 7):
        s = torch.tensor(step) if tensor_step else step
        for got, want in ((linear_warmup(s, 10, 3e-3), jax_warmup(step, 10, 3e-3)),
                          (cosine_schedule(s, 100, 1.0, warmup_steps=10),
                           jax_cosine(step, 100, 1.0, warmup_steps=10)),
                          (cosine_schedule(s, 50, 2e-4, final_frac=0.0),
                           jax_cosine(step, 50, 2e-4, final_frac=0.0))):
            assert isinstance(got, torch.Tensor) == tensor_step
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,scale,seed", [("mrpc", 0.01, 0), ("STS-B", 0.002, 3),
                                             ("sst2", 0.0001, 1), ("qnli", 0.0, 2)])
def test_glue_like_task_is_the_reference_corpus(name, scale, seed):
    assert _GLUE_SIZES == JAX_GLUE_SIZES
    mine, ref = glue_like_task(name, 128, 16, scale=scale, seed=seed), jax_glue_like_task(
        name, 128, 16, scale=scale, seed=seed)
    assert len(mine) == len(ref) == max(8, int(JAX_GLUE_SIZES[name.lower().replace("-", "")]
                                               * scale))
    np.testing.assert_array_equal(mine.tokens, ref.tokens)
    np.testing.assert_array_equal(mine.classes, ref.classes)
    with pytest.raises(KeyError):
        glue_like_task("cola", 128, 16)


@pytest.mark.parametrize("shape", [(4, 9), (2, 3, 64)])
def test_layer_norm_matches_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    b = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = np.asarray(jax_layer_norm(x, w, b))
    got = layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    got16 = layer_norm(torch.tensor(x).to(torch.bfloat16), torch.tensor(w), torch.tensor(b))
    assert got16.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def pac_case():
    import jax.random as jr

    from repro.configs import get_arch as jax_arch

    jcfg = jax_arch("internlm2-1.8b").reduced()
    bp = jbb.init_backbone(jr.PRNGKey(0), jcfg)
    ap = init_adapter(jr.PRNGKey(1), jcfg, r=4)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, jax.tree.map(np.asarray, bp), jax.tree.map(np.asarray, ap), batch


def test_pac_loss_fn_matches_the_reference(pac_case):
    jcfg, bp, ap, batch = pac_case
    j_loss, j_grad = jax.value_and_grad(
        lambda a: jsteps.pac_loss_fn(a, bp, jcfg, batch, r=4))(ap)
    cfg = get_arch("internlm2-1.8b").reduced()
    leaves = tree_map(lambda t: t.requires_grad_(True), bridge.to_torch(ap))
    loss = steps.pac_loss_fn(leaves, bridge.to_torch(bp), cfg,
                             {k: torch.tensor(v) for k, v in batch.items()}, r=4)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-5)
    for a, b in zip(grads, jax.tree.leaves(j_grad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_pac_loss_fn_keeps_the_gradient_highway(pac_case):
    """d(loss)/d(backbone): zero for every block and the embedding (never
    computed: the frozen path runs under no grad), non-zero for the head
    and final norm, as the reference's test holds."""
    _, bp, ap, batch = pac_case
    cfg = get_arch("internlm2-1.8b").reduced()
    backbone = tree_map(lambda t: t.requires_grad_(True), bridge.to_torch(bp))
    loss = steps.pac_loss_fn(bridge.to_torch(ap), backbone, cfg,
                             {k: torch.tensor(v) for k, v in batch.items()}, r=4)
    flat = tree_leaves(backbone)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=True)))
    assert all(grads[id(t)] is None for t in tree_leaves(backbone["blocks"]))
    assert grads[id(backbone["embed"])] is None
    assert float(grads[id(backbone["lm_head"])].abs().sum()) > 0


@pytest.fixture
def _opset_registries():
    """Both registries as they were: a dummy registered here does not
    outlive the test."""
    saved = [(dict(mod._REGISTRY), mod) for mod in (jopset, opset)]
    saved_instances = dict(opset._INSTANCES)
    yield
    for reg, mod in saved:
        mod._REGISTRY.clear()
        mod._REGISTRY.update(reg)
    jopset._cached.cache_clear()
    opset._INSTANCES.clear()
    opset._INSTANCES.update(saved_instances)


def test_registry_extension_point(_opset_registries):
    """The twin of tests/test_opset.py::test_registry_extension_point: a
    registered dummy resolves by name, instances are cached per (name,
    tap_policy), as the reference's; registering the name again replaces
    its factory; ``RunSpec.kernels`` still takes the port's two names."""
    class _Dummy(opset.OpSet):
        name = "dummy-test"

        def __init__(self, tap_policy="f32"):
            self.tap_policy = tap_policy

    class _JaxDummy(jopset.OpSet):
        name = "dummy-test"

        def __init__(self, tap_policy="f32", interpret=None):
            self.tap_policy = tap_policy

    opset.register_opset("dummy-test", _Dummy)
    jopset.register_opset("dummy-test", _JaxDummy)
    for mod, cls in ((opset, _Dummy), (jopset, _JaxDummy)):
        got = mod.get_opset("dummy-test", "bf16")
        assert isinstance(got, cls) and got.tap_policy == "bf16"
        assert mod.get_opset("dummy-test", "bf16") is got
        assert mod.get_opset("dummy-test", "f32") is not got
    mine = opset.get_opset("dummy-test", "bf16")
    assert opset.get_opset(mine) is mine  # an instance passes through
    assert isinstance(opset.get_opset("cuda"), opset.CudaOpSet)

    class _Other(_Dummy):
        pass

    opset.register_opset("dummy-test", _Other)
    assert type(opset.get_opset("dummy-test", "bf16")) is _Other
    assert KERNEL_IMPLS == ("ref", "cuda")
    with pytest.raises(RunSpecError):
        RunSpec(kernels="dummy-test").validate()


def test_registry_unknown_opset_raises():
    with pytest.raises(ValueError, match="unknown OpSet"):
        opset.get_opset("not-a-kernel-impl")
