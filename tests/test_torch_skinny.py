"""The decode path's one-launch GEMV (``csrc/skinny.cuh``) and flash's
rows with no key, on the CPU against the JAX Pallas kernels (interpret
mode).

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions. Here a float32 model of the GEMV's
summation order — each lane's rows in order, a warp's row lanes by a
butterfly, the block's warps in warp order, the cluster's ranks in rank
order — taken with the plan the wrappers pass to the kernel
(``repro_torch.kernels.skinny.plan``), is held to the reference's
kernels at its tolerances; and the wrapper's fill of flash's keyless rows
is held to the reference's answer there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jax_quantize
from repro.kernels.adapter_fuse import adapter_fuse as jax_adapter_fuse
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from repro_torch.core.quantization import QTensor, dequantize
from repro_torch.kernels import skinny
from repro_torch.kernels.flash_attention import _fill_keyless, _keyless_from, flash_attention

torch.set_num_threads(2)
SMS = 132  # an H100 SXM's SMs


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# flash: rows with no key
# ---------------------------------------------------------------------------


def test_keyless_from_matches_a_brute_force_mask():
    """The first row whose band is empty, in closed form, against the
    mask the reference builds, causal or not."""
    for Sq in (1, 5, 16, 37, 64):
        for Sk in (1, 4, 16, 37):
            for window in (None, 1, 3, 8, 40):
                for causal in (True, False):
                    q, k = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
                    mask = np.ones((Sq, Sk), bool)
                    if causal:
                        mask &= q >= k
                    if window is not None:
                        mask &= q - k < window
                    empty = ~mask.any(axis=1)
                    first = int(np.argmax(empty)) if empty.any() else Sq
                    assert empty[first:].all() and _keyless_from(Sq, Sk, window) == first, (
                        Sq, Sk, window, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_flash_rows_with_no_key_get_the_references_answer(causal, n_rep):
    """Sq = 64 queries over Sk = 16 keys with window 8: rows 23..63 have
    no key. The port (its CPU path, and the fill its CUDA path applies
    after the kernel wrote 0 there) against the Pallas kernel, atol 3e-5
    (tests/test_kernels.py:105)."""
    BHkv, Sq, Sk, hd, window = 2, 64, 16, 32, 8
    q = _randn((BHkv * n_rep, Sq, hd), seed=1)
    k, v = _randn((BHkv, Sk, hd), seed=2), _randn((BHkv, Sk, hd), seed=3)
    kr, vr = (np.repeat(t, n_rep, axis=0) for t in (k, v))
    want = np.asarray(flash_attention_tpu(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
                                          causal=causal, window=window, bq=16, bk=16,
                                          interpret=True))
    first = _keyless_from(Sq, Sk, window)
    assert first == 23
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    zeroed = torch.from_numpy(want.copy())
    zeroed[:, first:] = 0.0  # what the kernel writes there
    filled = _fill_keyless(zeroed, torch.from_numpy(v), n_rep, window)
    np.testing.assert_allclose(filled.numpy(), want, atol=3e-5)
    untouched = _fill_keyless(torch.from_numpy(want.copy()), torch.from_numpy(v), n_rep, None)
    assert np.array_equal(untouched.numpy(), want)


# ---------------------------------------------------------------------------
# the GEMV's plan and summation order
# ---------------------------------------------------------------------------

DECODE_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048)]  # (K, N), one layer


@pytest.mark.parametrize("bits", [32, 16, 8, 4])
def test_skinny_plan_meets_its_targets(bits):
    """Every plan is one the kernel takes (skinny.cuh's launch_rows
    checks), and at the decode shapes its blocks fit one wave and reach a
    quarter of the SMs."""
    shapes = DECODE_SHAPES + [(2048, 256), (2047, 130), (1000, 384), (136, 128), (5, 3)]
    for M in range(1, skinny.SKINNY_ROWS + 1):
        for K, N in shapes:
            if bits in (8, 4) and N % 128:
                continue
            p = skinny.plan(M, K, N, bits, SMS)
            lpr = p.cols // p.lane
            assert p.rows >= M and p.rows & (p.rows - 1) == 0
            assert p.rows * p.lane <= skinny.MAX_ACC and p.lane * bits <= 128
            assert p.cols % p.lane == 0 and lpr <= 32 and lpr & (lpr - 1) == 0
            assert 128 % p.cols == 0 and 1 <= p.ranks <= skinny.MAX_RANKS
            assert p.cols * bits // 8 >= skinny.MIN_SEGMENT
            assert (2048 // p.rows) % p.row_lanes == 0  # x chunks keep each lane's row order
            blocks = -(-N // p.cols) * p.ranks
            decode = (K, N) in DECODE_SHAPES if bits <= 8 else (K, N) == (2048, 256)
            if decode:  # one wave, a quarter of the SMs or more
                assert SMS // 4 <= blocks <= 2 * SMS * 9 // 10, (M, K, N, p)
    assert skinny.plan(1, 2048, 256, 32, SMS) == skinny.Plan(1, 4, 8, 32)  # adapter_fuse, T = 1
    assert skinny.plan(1, 2048, 2048, 8, SMS) == skinny.Plan(1, 16, 8, 128)
    assert skinny.plan(8, 2048, 2048, 8, SMS) == skinny.Plan(8, 8, 8, 128)
    assert skinny.plan(1, 2048, 8192, 8, SMS) == skinny.Plan(1, 16, 3, 128)


def _fma(acc: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(x, w, acc)``: the product exact in float64, one rounding
    of the sum (to float64, then float32)."""
    return (acc.double() + x.double() * w.double()).float()


def _skinny_order(x: torch.Tensor, w: torch.Tensor, p: skinny.Plan) -> torch.Tensor:
    """x (M, K) @ w (K, N), both f32, summed in the kernel's order."""
    M, K = x.shape
    N = w.shape[1]
    ks, rl = -(-K // p.ranks), p.row_lanes
    total = torch.zeros(M, N)
    for r in range(p.ranks):
        lo, hi = r * ks, min(K, (r + 1) * ks)
        acc = torch.zeros(rl, M, N)
        for j0 in range(lo, hi, rl):
            k = torch.arange(j0, j0 + rl)
            ok = (k < hi)[:, None, None]
            kc = k.clamp(max=K - 1)
            acc = torch.where(ok, _fma(acc, x[:, kc].T[:, :, None], w[kc][:, None, :]), acc)
        lanes = acc.reshape(skinny.WARPS, rl // skinny.WARPS, M, N)
        while lanes.shape[1] > 1:  # the butterfly: lane 0's pairwise tree
            lanes = lanes[:, 0::2] + lanes[:, 1::2]
        part = torch.zeros(M, N)
        for warp in range(skinny.WARPS):
            part = part + lanes[warp, 0]
        total = total + part
    return total


@pytest.mark.parametrize("T,d,da", [(1, 2048, 256), (3, 2047, 130)])
def test_skinny_order_holds_adapter_fuse_to_the_reference(T, d, da):
    """adapter_fuse at T = 1, d = 2048, d_a = 256 (one period's mix at
    decode), and ragged: the kernel's order within atol 1e-4 of the Pallas
    kernel (tests/test_kernels.py:68)."""
    b, w, a = _randn((T, d), 1), _randn((d, da), 2, d ** -0.5), _randn((T, da), 3)
    lam = 0.7
    want = jax_adapter_fuse(jnp.asarray(b), jnp.asarray(w), jnp.asarray(a), jnp.float32(lam),
                            bt=8, bj=128, bk=512, interpret=True)
    p = skinny.plan(T, d, da, 32, SMS)
    s = _skinny_order(torch.from_numpy(b), torch.from_numpy(w), p)
    got = lam * s + (1.0 - lam) * torch.from_numpy(a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(1, 8192, 256), (3, 1000, 384)])
def test_skinny_order_holds_quant_matmul_to_the_reference(bits, M, K, N):
    """quant_matmul at M = 1, K = 8192 (the down projection's depth), and
    ragged, int8 and int4: each weight dequantized as f32(q·s), then the
    kernel's order, within the reference's atol 1e-3 + rtol 1e-4
    (tests/test_kernels.py:38)."""
    x = _randn((M, K), 4)
    qt = jax_quantize(jnp.asarray(_randn((K, N), 5, K ** -0.5)), bits=bits, block=128)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), qt.q, qt.scale, bits=bits,
                                       bk=min(K, 1024) if K % 1024 == 0 else K, interpret=True))
    w = dequantize(QTensor(torch.from_numpy(np.array(qt.q)), torch.from_numpy(np.array(qt.scale)),
                           bits, 128, N), torch.float32)
    got = _skinny_order(torch.from_numpy(x), w, skinny.plan(M, K, N, bits, SMS))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
