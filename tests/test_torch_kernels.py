"""The port's kernel modules against the JAX Pallas kernels (interpret mode).

On the CPU each wrapper computes its plain PyTorch version (the CUDA
kernels build and run only on the card, where ``chip_smoke.py`` holds
them against these same plain versions). Inputs come from numpy with a
fixed seed and go through both packages; tolerances are the reference's
own (tests/test_kernels.py, tests/test_decode_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jax_quantize
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from repro.serve.paging import quantize_kv_pages as jax_quantize_kv_pages
from repro_torch.core.quantization import QTensor, quantize, unpack_int4
from repro_torch.kernels import ref
from repro_torch.kernels.cached_step import entry_as_f32
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.quant_matmul import quant_matmul

torch.set_num_threads(2)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(64, 256, 128), (8, 512, 256), (24, 200, 384), (1, 136, 128)])
def test_quant_matmul_matches_pallas(bits, M, K, N):
    x = _randn((M, K), seed=M + K)
    qt = jax_quantize(jnp.asarray(_randn((K, N), seed=N)), bits=bits, block=128)
    want = jax_quant_matmul(jnp.asarray(x), qt.q, qt.scale, bits=bits, interpret=True)
    xt = torch.from_numpy(x)
    q, s = torch.from_numpy(np.array(qt.q)), torch.from_numpy(np.array(qt.scale))
    got = ref.quant_matmul_ref(xt, q, s, bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-4)
    # the wrapper takes the plain version on CPU tensors, exactly
    torch.testing.assert_close(quant_matmul(xt, q, s, bits=bits), got, atol=0, rtol=0)


def test_quant_matmul_wrapper_validates():
    x = torch.zeros(4, 256)
    q = torch.zeros(256, 128, dtype=torch.int8)
    s = torch.zeros(256, 1)
    with pytest.raises(ValueError):
        quant_matmul(x, q[:, :64], s, bits=8)  # int8 q must be (K, N)
    with pytest.raises(ValueError):
        quant_matmul(x.double(), q, s, bits=8)
    with pytest.raises(ValueError):
        quant_matmul(x, q, s, bits=3)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_flash_attention_matches_pallas(causal, window, cap):
    BH, S, hd = 3, 128, 32
    q, k, v = (_randn((BH, S, hd), seed=i) for i in range(3))
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               window=window, attn_softcap=cap, bq=32, bk=32, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_flash_attention_grouped_kv_equals_repeated_layout():
    """Grouped KV (query row bh reads kv row bh // n_rep) is the Pallas
    kernel's repeated-KV layout without the copy."""
    B, hkv, n_rep, S, hd = 2, 2, 2, 64, 32
    q = _randn((B * hkv * n_rep, S, hd), seed=4)
    k, v = _randn((B * hkv, S, hd), seed=5), _randn((B * hkv, S, hd), seed=6)
    rep = lambda t: np.repeat(t, n_rep, axis=0)  # noqa: E731
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(rep(k)), jnp.asarray(rep(v)),
                               bq=32, bk=32, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

PAGED_TOL = {"f32": 2e-4, "bf16": 3e-2, "int8": 2e-4}  # test_decode_parity.py:36


def _paged_case(policy, seed=0):
    rng = np.random.default_rng(seed)
    B, hkv, n_rep, hd, page, max_pages, n_pages = 4, 2, 2, 64, 4, 5, 16
    q = _randn((B, hkv, n_rep, hd), seed + 1)
    kf = _randn((n_pages, page, hkv, hd), seed + 2)
    vf = _randn((n_pages, page, hkv, hd), seed + 3)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, max_pages), np.int32)
    lengths = np.array([17, 3, 0, 9], np.int32)  # row 2: a padding row (null page)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + 1) // page) if lengths[b] else 0
        bt[b, :n] = perm[used:used + n]
        used += n
    pages = {"k": kf, "v": vf}
    if policy == "int8":
        pages = {}
        for name, t in (("k", kf), ("v", vf)):
            qv, s = jax_quantize_kv_pages(jnp.asarray(t))
            pages[name], pages[name + "_scale"] = np.array(qv), np.array(s)
    return q, pages, bt, lengths


def _to_torch_pages(pages, policy):
    if policy == "bf16":
        return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in pages.items()}
    return {k: torch.from_numpy(v) for k, v in pages.items()}


def _to_jax_pages(pages, policy):
    if policy == "bf16":
        return {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in pages.items()}
    return {k: jnp.asarray(v) for k, v in pages.items()}


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window,cap", [(None, None), (6, None), (None, 20.0)])
def test_paged_attention_matches_pallas(policy, window, cap):
    q, pages, bt, lengths = _paged_case(policy)
    jp, tp = _to_jax_pages(pages, policy), _to_torch_pages(pages, policy)
    want = jax_paged_attention(
        jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(bt), jnp.asarray(lengths),
        k_scale=jp.get("k_scale"), v_scale=jp.get("v_scale"), window=window,
        attn_softcap=cap, interpret=True)
    args = (torch.from_numpy(q), tp["k"], tp["v"], torch.from_numpy(bt),
            torch.from_numpy(lengths))
    kw = dict(k_scale=tp.get("k_scale"), v_scale=tp.get("v_scale"), window=window,
              attn_softcap=cap)
    got = ref.paged_attention_ref(*args, **kw)
    assert np.isfinite(got.numpy()).all()  # the length-0 padding row included
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_TOL[policy])
    torch.testing.assert_close(paged_attention(*args, **kw), got, atol=0, rtol=0)


def test_paged_attention_wrapper_validates():
    q, pages, bt, lengths = _paged_case("int8")
    tp = _to_torch_pages(pages, "int8")
    args = (torch.from_numpy(q), tp["k"], tp["v"], torch.from_numpy(bt), torch.from_numpy(lengths))
    with pytest.raises(ValueError):
        paged_attention(*args, k_scale=tp["k_scale"])  # scales come in pairs
    with pytest.raises(ValueError):
        paged_attention(*args[:3], torch.from_numpy(bt[:2]), args[4])


# ---------------------------------------------------------------------------
# mix_dw's bf16 split (the CUDA kernel's arithmetic, emulated)
# ---------------------------------------------------------------------------


def _bf16_terms(v: torch.Tensor, n: int) -> list:
    """f32 ``v`` as ``n`` bf16 terms in float64, hi first: hi = bf16(v),
    mid = bf16(v - hi), lo = bf16(v - hi - mid)."""
    terms = []
    for _ in range(n):
        t = v.bfloat16().float()
        terms.append(t.double())
        v = v - t
    return terms


def _mix_dw_split(entry, g: torch.Tensor, lam: float, d: int, n: int) -> torch.Tensor:
    """``mix_dw`` as the kernel computes it with an ``n``-term split of its
    f32 operand: int8 codes and bf16 entries go to the MMA whole (exact in
    bf16), an int8 block's scale folded into ``g`` in f32; an f32 entry is
    split too, keeping the products of terms i + j < n. Products are
    summed in float64 (the split's error alone), then rounded to f32."""
    if isinstance(entry, QTensor):
        out = torch.zeros(d, g.shape[1], dtype=torch.float64)
        for kb in range(-(-d // entry.block)):
            cols = slice(kb * entry.block, min(d, (kb + 1) * entry.block))
            scaled = entry.scale[:, kb:kb + 1] * g
            out[cols] = entry.q[:, cols].double().T @ sum(_bf16_terms(scaled, n))
    else:
        a = entry[:, :d]
        a_terms = [a.double()] if a.dtype == torch.bfloat16 else _bf16_terms(a.float(), n)
        b_terms = _bf16_terms(g, n)
        out = sum(x.T @ y for i, x in enumerate(a_terms) for j, y in enumerate(b_terms)
                  if i + j < n)
    return out.float() * lam


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_mix_dw_bf16_split_error_model(storage):
    """The split behind ``mix_dw``'s tensor-core kernel, at T = 2048 (the
    training contraction, which sets the error) with narrow d and d_a:
    three bf16 terms meet ``chip_smoke.py``'s ``mix_dw`` check against the
    plain version (|Δ| <= 2e-4 + 1e-3·|want|, the reference's custom-VJP
    tolerance), and two terms (~16 significant bits) err at least 10x more
    against the exact product, which is why the kernel takes three."""
    T, d, da, lam = 2048, 256, 64, 0.7
    b = torch.from_numpy(_randn((T, d), 11))
    g = torch.from_numpy(_randn((T, da), 12))
    entry = {"f32": b, "bf16": b.bfloat16(), "int8": quantize(b, 8, 128)}[storage]
    want = ref.mix_dw_ref(entry, g, lam, d)
    exact = lam * (entry_as_f32(entry, d).double().T @ g.double())
    three, two = (_mix_dw_split(entry, g, lam, d, n) for n in (3, 2))
    assert float(((three - want).abs() - 1e-3 * want.abs()).max()) <= 2e-4
    err3 = float((three.double() - exact).abs().max())
    err2 = float((two.double() - exact).abs().max())
    assert err2 >= 10 * err3, (err2, err3)


# ---------------------------------------------------------------------------
# mix_fwd's bf16 split (the CUDA kernel's arithmetic, emulated)
# ---------------------------------------------------------------------------


def _mix_fwd_split(entry, w: torch.Tensor, n: int) -> torch.Tensor:
    """``bw = dequant(entry)[:, :d] @ w`` as the kernel computes it with an
    ``n``-term split of ``w``: int8 codes and bf16 entries go to the MMA
    whole, an f32 entry is split too, keeping the products of terms
    i + j < n. An int8 entry's sum over each 16-deep step of the
    contraction is multiplied by its token's scale for that step. Products
    are summed in float64 (the split's error alone), then rounded to f32."""
    d, da = w.shape
    w_sum = sum(_bf16_terms(w, n))
    if isinstance(entry, QTensor):
        steps = -(-d // 16)
        codes = torch.zeros(entry.q.shape[0], steps * 16, dtype=torch.float64)
        codes[:, :d] = entry.q[:, :d].double()
        w_pad = torch.zeros(steps * 16, da, dtype=torch.float64)
        w_pad[:d] = w_sum
        parts = torch.einsum("tsk,skn->tsn", codes.reshape(-1, steps, 16),
                             w_pad.reshape(steps, 16, da))
        step_scale = entry.scale[:, torch.arange(steps) * 16 // entry.block].double()
        out = (step_scale[..., None] * parts).sum(dim=1)
    else:
        b = entry[:, :d]
        b_terms = [b.double()] if b.dtype == torch.bfloat16 else _bf16_terms(b.float(), n)
        out = sum(x @ y for i, x in enumerate(b_terms) for j, y in enumerate(_bf16_terms(w, n))
                  if i + j < n)
    return out.float()


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int8_q32_ragged"])
def test_mix_fwd_bf16_split_error_model(storage):
    """The split behind ``mix_fwd``'s tensor-core kernel, at d = 2048 (the
    training contraction, which sets the error) with narrow T and d_a, and
    on a ragged int8 entry (qblock 32, d = 1000 inside ld = 1024): three
    bf16 terms meet the forward's check against the plain version
    (|Δ| <= 1e-4 + 1e-4·|want| for out and bw, the reference's
    dq_adapter_mix tolerance, tests/test_cached_step.py:53-56), and two
    terms err at least 10x more against the exact product."""
    T, d, da, lam, qblock = 64, 2048, 32, 0.7, 128
    if storage == "int8_q32_ragged":
        T, d, da, qblock = 37, 1000, 24, 32
    b = torch.from_numpy(_randn((T, d), 13))
    w = torch.from_numpy(_randn((d, da), 14, d ** -0.5))
    a = torch.from_numpy(_randn((T, da), 15))
    entry = {"f32": b, "bf16": b.bfloat16()}[storage] if storage in ("f32", "bf16") \
        else quantize(b, 8, qblock)
    if storage == "int8_q32_ragged":
        assert entry.q.shape[1] > d
    want_out, want_bw = ref.mix_fwd_ref(entry, w, a, lam)
    exact = entry_as_f32(entry, d).double() @ w.double()
    three, two = (_mix_fwd_split(entry, w, n) for n in (3, 2))
    out3 = lam * three + (1 - lam) * a
    for got, want in ((three, want_bw), (out3, want_out)):
        assert float(((got - want).abs() - 1e-4 * want.abs()).max()) <= 1e-4
    err3 = float((three.double() - exact).abs().max())
    err2 = float((two.double() - exact).abs().max())
    assert err2 >= 10 * err3, (err2, err3)


# ---------------------------------------------------------------------------
# ce_fwd's bf16 split (the CUDA kernel's arithmetic, emulated)
# ---------------------------------------------------------------------------


def _ce_fwd_split(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, softcap, n: int,
                  bn: int = 128):
    """``ce_fwd`` as the kernel computes it with both operands split in
    ``n`` bf16 terms: the products of terms i + j < n summed in float64,
    rounded to f32 (the logits the tensor cores leave), then the soft-cap
    and the online softmax over vocab tiles of ``bn`` columns in float64.
    Returns float64 (nll, lse)."""
    z = sum(x @ y for i, x in enumerate(_bf16_terms(h, n)) for j, y in enumerate(_bf16_terms(w, n))
            if i + j < n)
    return _online_ce(z.float(), labels, softcap, bn)


def _online_ce(z: torch.Tensor, labels: torch.Tensor, softcap, bn: int = 128):
    z = z.double()
    if softcap is not None:
        z = softcap * torch.tanh(z / softcap)
    m = torch.full((z.shape[0],), -1e30, dtype=torch.float64)
    l = torch.zeros(z.shape[0], dtype=torch.float64)
    for v0 in range(0, z.shape[1], bn):
        tile = z[:, v0:v0 + bn]
        m_new = torch.maximum(m, tile.max(dim=1).values)
        l = l * torch.exp(m - m_new) + torch.exp(tile - m_new[:, None]).sum(dim=1)
        m = m_new
    lse = m + torch.log(l)
    return lse - z[torch.arange(z.shape[0]), labels], lse


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_ce_fwd_bf16_split_error_model(softcap):
    """The split behind ``ce_fwd``'s tensor-core kernel, at d = 2048 (the
    training contraction, which sets the error) with narrow T and a V that
    ends inside a 128-column tile: three bf16 terms meet the forward's
    check against the plain version (|Δ| <= 2e-5 + 1e-5·|want| for nll and
    lse, the reference's blockwise-CE tolerance, tests/test_cached_step.py:
    105), and two terms err at least 10x more against the exact result.
    Why the kernel takes three: two terms (~16 significant bits) meet the
    check here too, but err ~1e-5 against the exact result, half the
    check's absolute term and ~10x the plain f32 version's own error, so
    larger logits would cross it; three err ~5e-8, below the f32 rounding
    of the result. One term (bf16 alone) errs ~8e-3 and fails it."""
    T, d, V = 64, 2048, 1000
    h = torch.from_numpy(_randn((T, d), 16))
    w = torch.from_numpy(_randn((d, V), 17, d ** -0.5))
    labels = torch.from_numpy(np.random.default_rng(18).integers(0, V, T))
    want = ref.ce_fwd_ref(h, w, labels, softcap)
    exact = _online_ce(h.double() @ w.double(), labels, softcap)
    three, two = (_ce_fwd_split(h, w, labels, softcap, n) for n in (3, 2))
    for got, x in zip(three, want):
        assert float(((got.float() - x).abs() - 1e-5 * x.abs()).max()) <= 2e-5
    err3 = max(float((g - x).abs().max()) for g, x in zip(three, exact))
    err2 = max(float((g - x).abs().max()) for g, x in zip(two, exact))
    assert err2 >= 10 * err3, (err2, err3)


def test_ce_fwd_chunk_fills_whole_waves():
    """The forward's W chunk: about FWD_CHUNK columns, a whole number of
    waves of one block per SM where the token tiles allow, never past the
    vocab or twice FWD_CHUNK (the scratch's bound)."""
    from repro_torch.kernels.lmhead_ce import FWD_CHUNK, fwd_chunk_tiles

    bn, sms = 128, 132
    chunk = fwd_chunk_tiles(16, 723, bn, sms)  # T = 2048, V = 92544 on an H100
    assert chunk == 66 and chunk * 16 % sms == 0
    for t_tiles, v_tiles in ((1, 723), (8, 24), (3, 5), (16, 1), (40, 723), (200, 723)):
        c = fwd_chunk_tiles(t_tiles, v_tiles, bn, sms)
        assert 1 <= c <= min(v_tiles, 2 * FWD_CHUNK // bn), (t_tiles, v_tiles, c)


def test_ce_bwd_chunk_and_scratch_sizes():
    """The backward's W chunk is the forward's (whole waves at the training
    shape); its scratch is h's three bf16 planes with d padded to whole
    dh tiles, and one chunk's W and P planes: ~0.23 GB at T = d = 2048,
    V = 92544, with d padded to 128 at ragged widths."""
    from repro_torch.kernels.lmhead_ce import ce_bwd_scratch, fwd_chunk_tiles

    bm = bn = 128
    chunk, n_h, n_w, n_p = ce_bwd_scratch(2048, 2048, 92544, bm, bn, 132)
    assert chunk == fwd_chunk_tiles(16, 723, bn, 132) == 66
    assert (n_h, n_w, n_p) == (3 * 2048 * 2048, 3 * 2048 * 66 * 128, 3 * 2048 * 66 * 128)
    assert 2 * (n_h + n_w + n_p) < 0.3e9
    for T, d, V, tp, dp in ((1001, 1000, 3001, 1024, 1024), (37, 130, 517, 128, 256)):
        chunk, n_h, n_w, n_p = ce_bwd_scratch(T, d, V, bm, bn, 132)
        assert chunk == fwd_chunk_tiles(tp // bm, -(-V // bn), bn, 132) <= -(-V // bn)
        assert (n_h, n_w, n_p) == (3 * tp * dp, 3 * dp * chunk * bn, 3 * tp * chunk * bn)


def _ce_grad(z: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, softcap) -> torch.Tensor:
    """``(exp(s − lse) − onehot)·slope`` in ``z``'s dtype, ``s`` and the
    slope ``1 − tanh²`` from the soft-cap (slope 1 without one)."""
    slope = 1.0
    if softcap is not None:
        th = torch.tanh(z / softcap)
        z, slope = softcap * th, 1.0 - th * th
    p = torch.exp(z - lse.to(z.dtype)[:, None])
    p[torch.arange(z.shape[0]), labels] -= 1.0
    return p * slope


def _ce_bwd_split(h, w, labels, lse, g, softcap, n: int) -> torch.Tensor:
    """``ce_bwd`` as the kernel computes it with ``n``-term splits: the
    logits from the products of h's and W's terms i + j < n, summed in
    float64 and rounded to f32 (the forward's logits); P in f32; then P's
    ``n`` terms times W's ``n`` terms (i + j < n) in float64, rounded to
    f32, times g."""
    w_terms = _bf16_terms(w, n)
    z = sum(x @ y for i, x in enumerate(_bf16_terms(h, n)) for j, y in enumerate(w_terms)
            if i + j < n)
    p = _ce_grad(z.float(), labels, lse, softcap)
    dh = sum(x @ y.T for i, x in enumerate(_bf16_terms(p, n)) for j, y in enumerate(w_terms)
             if i + j < n)
    return dh.float() * g


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_ce_bwd_bf16_split_error_model(softcap):
    """The splits behind ``ce_bwd``'s tensor-core kernel (the logits as the
    forward computes them, then P split in three terms against the same
    W terms), at d = 2048 with narrow T and a V that ends inside a
    128-column tile, the forward's lse: three bf16 terms meet the
    backward's check against the plain version (|Δdh| <= 1e-5 +
    1e-4·|want|, the reference's tolerance, tests/test_cached_step.py:113),
    and two terms err at least 10x more against the float64 result on the
    same lse. Two terms err ~1.4e-6 (cap off) and ~1.8e-6 (cap 30)
    against it, ~8x the plain f32 version's own error, inside the check;
    three ~2e-8, below it."""
    T, d, V = 64, 2048, 1000
    h = torch.from_numpy(_randn((T, d), 19))
    w = torch.from_numpy(_randn((d, V), 20, d ** -0.5))
    labels = torch.from_numpy(np.random.default_rng(21).integers(0, V, T))
    g = torch.from_numpy(_randn((T,), 22))
    _, lse = ref.ce_fwd_ref(h, w, labels, softcap)
    want = ref.ce_bwd_ref(h, w, labels, lse, g, softcap)
    exact = (_ce_grad(h.double() @ w.double(), labels, lse, softcap) @ w.double().T
             * g.double()[:, None])
    three, two = (_ce_bwd_split(h, w, labels, lse, g[:, None], softcap, n) for n in (3, 2))
    assert float(((three - want).abs() - 1e-4 * want.abs()).max()) <= 1e-5
    err3 = float((three.double() - exact).abs().max())
    err2 = float((two.double() - exact).abs().max())
    assert err2 >= 10 * err3, (err2, err3)


# ---------------------------------------------------------------------------
# the bf16-head CE branches on the wgmma loop: the tensor core's truncating
# adds and the stage-wise promotion (the CUDA kernels' arithmetic, emulated)
# ---------------------------------------------------------------------------


def _tc_add(c: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """One wgmma k16 step as the tensor core adds it (mix_tile.cuh's note):
    C (M, N) and the 16 exact products (M, N, 16), every addend truncated
    toward zero on the grid of the largest (24 significant bits at its
    exponent), summed, rounded to f32. Float64 in and out."""
    add = torch.cat([c[..., None], prods], -1)
    big = add.abs().amax(-1, keepdim=True)
    grid = torch.exp2(torch.floor(torch.log2(torch.where(big > 0, big, torch.ones_like(big)))) - 23)
    return (torch.trunc(add / grid) * grid).sum(-1).float().double()


def _wgmma_sum(a_terms, b: torch.Tensor, promote) -> torch.Tensor:
    """``A @ B`` as the wgmma loop sums it: A in bf16 terms (M, K), B one
    bf16 plane (K, N), K a multiple of 16. Each promotion group of
    ``promote`` k16 steps (None: the whole contraction) goes into a fresh
    sum, the terms smallest first, each over the group's steps in order,
    every step one truncating tensor-core add; one f32 add then puts the
    group into the running sum. Returns f32."""
    K = b.shape[0]
    steps = K // 16
    promote = promote or steps
    acc = torch.zeros(a_terms[0].shape[0], b.shape[1], dtype=torch.float32)
    for g0 in range(0, steps, promote):
        part = torch.zeros(acc.shape, dtype=torch.float64)
        for a in reversed(a_terms):
            for k0 in range(16 * g0, 16 * min(steps, g0 + promote), 16):
                part = _tc_add(part, (a[:, k0:k0 + 16, None] * b[None, k0:k0 + 16]).transpose(1, 2))
        acc = acc + part.float()
    return acc


def _p_of(z: torch.Tensor, labels, lse, softcap) -> torch.Tensor:
    """The backward's P in f32 from the f32 logits (the kernels' epilogue)."""
    return _ce_grad(z, labels, lse.float(), softcap)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_ce_fwd_wgmma_promotion_error_model(softcap):
    """The bf16-head forward on the wgmma loop (h f32 in three terms, W
    bf16 whole), at d = 2048 with narrow T and a V that ends inside a tile:
    the stage-wise promotion the kernel takes (a fresh sum every BK = 64,
    four k16 steps) meets ``chip_smoke.py``'s forward check against the
    plain version (|Δ| <= 2e-5 + 1e-5·|want| for nll and lse) and errs
    on the logits no more than a fresh sum every k16 step (~1e-6, the f32
    running sum's rounding); promoting only at the end errs ~1.3e-5 on
    the logits, at least 5x the stage-wise sum: inside the check here
    (whose 1e-5·|nll| ~1e-4 dominates), but the tensor core's truncation
    of the small terms on the running total's grid, not f32's."""
    T, d, V = 16, 2048, 500
    h = torch.from_numpy(_randn((T, d), 16))
    w = torch.from_numpy(_randn((d, V), 17, d ** -0.5)).bfloat16()
    labels = torch.from_numpy(np.random.default_rng(18).integers(0, V, T))
    want = ref.ce_fwd_ref(h, w, labels, softcap)
    exact_z = h.double() @ w.double()
    z = {n: _wgmma_sum(_bf16_terms(h, 3), w.double(), n) for n in (1, 4, None)}
    err = {n: float((x.double() - exact_z).abs().max()) for n, x in z.items()}
    for got, x in zip(_online_ce(z[4], labels, softcap), want):
        assert float(((got.float() - x).abs() - 1e-5 * x.abs()).max()) <= 2e-5
    assert err[4] <= 1.5 * err[1] and err[4] < 3e-6, err
    assert err[None] >= 5 * err[4], err


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_ce_dh_wgmma_promotion_error_model(softcap):
    """The bf16-head backward's dh GEMM on the wgmma loop over one vocab
    chunk of the training shape (66 tiles, 8448 columns: 528 k16 steps, the
    longest contraction the loop runs), P from logits at d = 2048, 128 of
    dh's columns: the stage-wise promotion meets ``chip_smoke.py``'s dh
    check against the plain version (|Δ| <= 1e-5 + 1e-4·|want|). Promoting
    only at the end meets it too, by a margin of ~8x (~1.2e-6 against the
    float64 product on the same P, for ~7e-8 stage-wise): at least 5x the
    stage-wise error, which is why the kernel promotes each stage."""
    T, d, V, cols = 16, 2048, 66 * 128, 128
    h = torch.from_numpy(_randn((T, d), 19))
    w = torch.from_numpy(_randn((d, V), 20, d ** -0.5)).bfloat16()
    labels = torch.from_numpy(np.random.default_rng(21).integers(0, V, T))
    g = torch.from_numpy(_randn((T,), 22))
    _, lse = ref.ce_fwd_ref(h, w, labels, softcap)
    want = ref.ce_bwd_ref(h, w, labels, lse, g, softcap)[:, :cols]
    p = _p_of(_wgmma_sum(_bf16_terms(h, 3), w.double(), 4), labels, lse, softcap)
    wt = w.double()[:cols].T.contiguous()
    exact = (p.double() @ wt) * g.double()[:, None]
    dh = {n: _wgmma_sum(_bf16_terms(p, 3), wt, n) * g[:, None] for n in (4, None)}
    err = {n: float((x.double() - exact).abs().max()) for n, x in dh.items()}
    for x in dh.values():
        assert float(((x - want).abs() - 1e-4 * want.abs()).max()) <= 1e-5
    assert err[None] >= 5 * err[4] and err[None] < 1e-5 / 4, err


def test_ce_wgmma_route_and_scratch_sizes():
    """Which bf16 heads TMA reads in place (every row 16-byte aligned: V a
    multiple of 8 and the base at 16 bytes) and the scratch each loop
    takes: on the wgmma loop no W scratch at the training shape (one
    launch over all of V), the padded copy (d, V rounded up to 8) at the
    smoke's ragged shapes or an unaligned base, h's planes with d padded
    to whole 64-deep stages, the backward's P chunk as before; an f32 W
    keeps tile_mma's chunked scratch unchanged."""
    from repro_torch.kernels.lmhead_ce import (ce_bwd_scratch, ce_fwd_scratch, fwd_chunk_tiles,
                                               w_in_place)

    assert w_in_place(92544, 1 << 20) and w_in_place(50304, 256)
    assert not w_in_place(517, 256) and not w_in_place(3001, 256)
    assert not w_in_place(92544, (1 << 20) + 2) and not w_in_place(50265, 256)
    bm, bk, sms = 128, 64, 132
    bn = 256  # ce_fwd_wg's vocab tile: two 128-column halves a consumer warpgroup
    chunk, n_h, n_w = ce_fwd_scratch(2048, 2048, 92544, bm, bn, bk, sms, 3, 1, wgmma=True)
    assert (n_h, n_w) == (3 * 2048 * 2048, 0)
    bn = 128  # ce_grad_wg's: the backward's chunks are whole tiles of it
    chunk, n_h, n_w, n_p = ce_bwd_scratch(2048, 2048, 92544, bm, bn, sms, 3, 1, bk=bk,
                                          wgmma=True)
    assert chunk == fwd_chunk_tiles(16, 723, bn, sms) == 66
    assert (n_h, n_w, n_p) == (3 * 2048 * 2048, 0, 3 * 2048 * 66 * 128)
    for T, d, V, tp in ((37, 130, 517, 128), (1001, 1000, 3001, 1024)):
        dp, vp = -(-d // 64) * 64, -(-V // 8) * 8
        for h_terms in (3, 1):
            _, n_h, n_w = ce_fwd_scratch(T, d, V, bm, 256, bk, sms, h_terms, 1, wgmma=True,
                                         in_place=False)
            assert (n_h, n_w) == (h_terms * tp * dp, d * vp)
            chunk, n_h, n_w, n_p = ce_bwd_scratch(T, d, V, bm, bn, sms, h_terms, 1, bk=bk,
                                                  wgmma=True, in_place=False)
            assert (n_h, n_w, n_p) == (h_terms * tp * dp, d * vp, 3 * tp * chunk * bn)
    bn = 128  # tile_mma's
    # tile_mma's scratch (an f32 W, or a bf16 W routed back to it): W's planes a chunk
    chunk, n_h, n_w = ce_fwd_scratch(2048, 2048, 92544, bm, bn, bk, sms, 3, 3)
    assert (n_h, n_w) == (3 * 2048 * 2048, 3 * 2048 * chunk * bn)
    assert ce_bwd_scratch(37, 130, 517, bm, bn, sms, 3, 1)[1:3] == (3 * 128 * 256,
                                                                    1 * 256 * 5 * 128)


def test_ce_route_names_the_kernels_each_loop_launches():
    """The kernels the wrappers launch, by operand: a bf16 W on the wgmma
    loop (one forward launch, no W pass where TMA reads W in place, the
    padded copy first where it cannot), h split or (bf16) copied; an f32
    W, or a bf16 W routed back to tile_mma, on tile_mma with W's chunk
    passes."""
    from repro_torch.kernels.lmhead_ce import route

    assert route(False, True, True, True) == {
        "ce_fwd": ["ce_split (h)", "ce_fwd_wg<3, 2>", "ce_merge"],
        "ce_bwd": ["ce_split (h)", "ce_grad_wg<3, 1>", "ce_dh_wg<2>"]}
    r = route(True, True, False, True)
    assert r["ce_fwd"] == ["ce_pad (h)", "ce_pad (W, padded copy)", "ce_fwd_wg<1, 2>", "ce_merge"]
    assert r["ce_bwd"][2:] == ["ce_grad_wg<1, 1>", "ce_dh_wg<2>"]
    for in_place in (True, False):
        assert route(False, False, in_place, True)["ce_fwd"] == [
            "ce_split (h)", "ce_split (W chunk)", "ce_fwd_mma<3, 3>", "ce_merge"]
    assert route(False, True, True, False)["ce_bwd"] == [
        "ce_split (h)", "ce_pad (W chunk)", "ce_grad_mma<3, 1>", "ce_dh_mma<1>"]


# ---------------------------------------------------------------------------
# quant_matmul's tiled path: x·s split in bf16 terms (the CUDA kernel's
# arithmetic, emulated)
# ---------------------------------------------------------------------------


def _qmm_split(x: torch.Tensor, w: QTensor, n: int) -> torch.Tensor:
    """``x @ dequant(w)`` as the tiled kernel computes it with an ``n``-term
    split: per 128-column quantization block ``nb``, ``a = f32(x·s[:, nb])``
    split in ``n`` bf16 terms, times the exact int8 or int4 codes, each
    16-deep step of the contraction summed in float64, the steps summed,
    then rounded to f32."""
    codes = (unpack_int4(w.q) if w.bits == 4 else w.q).double()
    (M, K), N = x.shape, codes.shape[1]
    steps = -(-K // 16)
    c_pad = torch.zeros(steps * 16, N, dtype=torch.float64)
    c_pad[:K] = codes
    out = torch.zeros(M, N, dtype=torch.float64)
    for nb in range(N // 128):
        cols = slice(nb * 128, (nb + 1) * 128)
        a_pad = torch.zeros(M, steps * 16, dtype=torch.float64)
        a_pad[:, :K] = sum(_bf16_terms(x * w.scale[:, nb], n))
        parts = torch.einsum("msk,skn->msn", a_pad.reshape(M, steps, 16),
                             c_pad[:, cols].reshape(steps, 16, 128))
        out[:, cols] = parts.sum(dim=1)
    return out.float()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(64, 8192, 256), (37, 1000, 384)])
def test_quant_matmul_bf16_split_error_model(bits, M, K, N):
    """The split behind ``quant_matmul``'s tensor-core tiled path, at
    K = 8192 (the longest contraction of internlm2-1.8b's projections)
    with narrow M and N, and at a ragged M, K and N: three bf16 terms of
    x·s meet the reference's f32 check against the plain version
    (|Δ| <= 1e-3 + 1e-4·|want|, tests/test_kernels.py:38), two terms err
    at least 10x more than three against the exact product, and one term
    (bf16 x·s alone) misses the check: why the kernel takes three."""
    x = torch.from_numpy(_randn((M, K), 19))
    w = quantize(torch.from_numpy(_randn((K, N), 20, K ** -0.5)), bits, 128)
    want = ref.quant_matmul_ref(x, w.q, w.scale, bits)
    codes = (unpack_int4(w.q) if bits == 4 else w.q).double()
    exact = x.double() @ (codes * w.scale.double().repeat_interleave(128, dim=1))
    three, two, one = (_qmm_split(x, w, n) for n in (3, 2, 1))

    def check(got):
        return float(((got - want).abs() - 1e-4 * want.abs()).max())

    assert check(three) <= 1e-3
    assert check(one) > 1e-3
    err3 = float((three.double() - exact).abs().max())
    err2 = float((two.double() - exact).abs().max())
    assert err2 >= 10 * err3, (err2, err3)


# ---------------------------------------------------------------------------
# flash attention's bf16 split (the CUDA kernel's arithmetic, emulated)
# ---------------------------------------------------------------------------


def _split_product(a_terms, b_terms, eq: str, n: int, a_dim: int, b_dim: int) -> torch.Tensor:
    """Σ over 16-deep steps of the contraction, in f32, of each step's
    products of terms i + j < n summed in float64 (the kernel's fresh sum)
    and rounded to f32. ``a_dim``/``b_dim``: the contracted dim of each."""
    depth = a_terms[0].shape[a_dim]
    out = None
    for k0 in range(0, depth, 16):
        part = sum(torch.einsum(eq, x.narrow(a_dim, k0, 16), y.narrow(b_dim, k0, 16))
                   for i, x in enumerate(a_terms) for j, y in enumerate(b_terms) if i + j < n)
        out = part.float() if out is None else out + part.float()
    return out


def _flash_split(q, k, v, softcap, n: int, bkv: int = 64) -> torch.Tensor:
    """Causal flash attention as the kernel computes it with Q, K, V and
    the probabilities P each in ``n`` bf16 terms: S = Q·Kᵀ and each key
    tile's P·V keep the products of terms i + j < n per 16-deep step
    (:func:`_split_product`); scale, soft-cap, mask and the online softmax
    over key tiles of ``bkv`` in f32, l summed from the f32 p."""
    BH, S, hd = q.shape
    k_terms, v_terms = _bf16_terms(k, n), _bf16_terms(v, n)
    s_all = _split_product(_bf16_terms(q, n), k_terms, "bqd,bkd->bqk", n, 2, 2) * hd ** -0.5
    if softcap is not None:
        s_all = softcap * torch.tanh(s_all / softcap)
    pos = torch.arange(S)
    s_all = torch.where(pos[:, None] >= pos[None, :], s_all, torch.tensor(-torch.inf))
    m = torch.full((BH, S), -torch.inf)
    l, o = torch.zeros(BH, S), torch.zeros(BH, S, hd)
    for k0 in range(0, S, bkv):
        s = s_all[:, :, k0:k0 + bkv]
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _split_product(
            _bf16_terms(p, n), [t[:, k0:k0 + bkv] for t in v_terms], "bqk,bkd->bqd", n, 2, 1)
        m = m_new
    return o / torch.clamp(l, min=1e-30)[..., None]


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_flash_bf16_split_error_model(softcap):
    """The split behind flash attention's tensor-core kernel, causal at
    hd = 128 and S = 256: three bf16 terms of Q, K, V and P meet the
    reference's flash tolerance (atol 3e-5, tests/test_kernels.py:105)
    against the Pallas kernel in interpret mode; two terms err at least 10x
    more than three against float64 attention (~1e-5, at the tolerance),
    and one term (bf16 alone) misses the tolerance: why both products take
    three terms, six bf16 products each."""
    BH, S, hd = 2, 256, 128
    q, k, v = (_randn((BH, S, hd), seed) for seed in (21, 22, 23))
    want = np.asarray(flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          attn_softcap=softcap, bq=64, bk=64, interpret=True))
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qt.double(), kt.double()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    exact = torch.softmax(s, dim=-1) @ vt.double()
    three, two, one = (_flash_split(qt, kt, vt, softcap, n) for n in (3, 2, 1))
    np.testing.assert_allclose(three.numpy(), want, atol=3e-5)
    err3, err2, err1 = (float((x.double() - exact).abs().max()) for x in (three, two, one))
    assert err2 >= 10 * err3, (err2, err3)
    assert err1 > 3e-5, err1


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_bf16_split_error_model_hd256(softcap):
    """The same split at gemma2-2b's head width (hd = 256, S = 256, its
    attention soft-cap 50): the wider contraction still meets the
    reference's flash tolerance against the Pallas kernel in interpret
    mode with three terms, two err at least 10x more against float64
    attention, and one misses the tolerance."""
    BH, S, hd = 2, 256, 256
    q, k, v = (_randn((BH, S, hd), seed) for seed in (24, 25, 26))
    want = np.asarray(flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          attn_softcap=softcap, bq=64, bk=64, interpret=True))
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", qt.double(), kt.double()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    exact = torch.softmax(s, dim=-1) @ vt.double()
    three, two, one = (_flash_split(qt, kt, vt, softcap, n, bkv=32) for n in (3, 2, 1))
    np.testing.assert_allclose(three.numpy(), want, atol=3e-5)
    err3, err2, err1 = (float((x.double() - exact).abs().max()) for x in (three, two, one))
    assert err2 >= 10 * err3, (err2, err3)
    assert err1 > 3e-5, err1


def _tc_chain(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, steps) -> torch.Tensor:
    """C (BH, M, N) plus the k16 steps starting at ``steps`` of a (BH, M, K)
    @ b (BH, K, N), each step one truncating tensor-core add
    (:func:`_tc_add`). Float64 in and out."""
    for k0 in steps:
        c = _tc_add(c, (a[..., k0:k0 + 16, None] * b[:, None, k0:k0 + 16]).transpose(-1, -2))
    return c


def _flash_tc(q, k, v, softcap, qk: str, pv: str, bkv: int) -> torch.Tensor:
    """Causal flash attention on bf16 values (q, k, v f32 tensors holding
    them) as a tensor-core loop sums it, every k16 step one truncating add
    (:func:`_tc_add`). Q·Kᵀ: a fresh f32 sum each k16 step ("step", the
    ``mma.sync`` loop's), each 64-deep half of the head ("stage"), or one
    chain over the head ("chain"). P in three bf16 terms times V, over key
    tiles of ``bkv``: a fresh sum each k16 step ("step"), one a tile with
    the terms smallest first, each over the tile's steps ("tile"), or
    straight into the rescaled O ("into_o"). Scale, soft-cap, mask and the
    online softmax in f32, as the kernels. Returns O in f32."""
    BH, S, hd = q.shape
    kt, z = k.double().transpose(1, 2), torch.zeros(BH, S, S, dtype=torch.float64)
    steps = list(range(0, hd, 16))
    groups = {"step": [[k0] for k0 in steps], "stage": [steps[:4], steps[4:]],
              "chain": [steps]}[qk]
    s_all = sum(_tc_chain(z, q.double(), kt, g).float() for g in groups) * hd ** -0.5
    if softcap is not None:
        s_all = softcap * torch.tanh(s_all / softcap)
    pos = torch.arange(S)
    s_all = torch.where(pos[:, None] >= pos[None, :], s_all, torch.tensor(-torch.inf))
    m = torch.full((BH, S), -torch.inf)
    l, o = torch.zeros(BH, S), torch.zeros(BH, S, hd)
    for k0 in range(0, S, bkv):
        s = s_all[:, :, k0:k0 + bkv]
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        lo_first = _bf16_terms(p, 3)[::-1]
        vt = v.double()[:, k0:k0 + bkv]
        tile_steps = range(0, bkv, 16)
        if pv == "into_o":
            acc = (o * alpha[..., None]).double()
            for t in lo_first:
                acc = _tc_chain(acc, t, vt, tile_steps)
            o = acc.float()
            m = m_new
            continue
        zero = torch.zeros(BH, S, hd, dtype=torch.float64)
        if pv == "tile":
            part = zero
            for t in lo_first:
                part = _tc_chain(part, t, vt, tile_steps)
            o = o * alpha[..., None] + part.float()
        else:
            o = o * alpha[..., None]
            for j in tile_steps:
                part = zero
                for t in lo_first:
                    part = _tc_chain(part, t, vt, [j])
                o = o + part.float()
        m = m_new
    return o / torch.clamp(l, min=1e-30)[..., None]


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_flash_bf16_wgmma_promotion_error_model(softcap):
    """flash attention's bf16 branch on the wgmma loop (bf16 q, k, v at hd
    128, S 256, causal): Q·Kᵀ in a fresh f32 sum each 64-deep half of the
    head, P's three terms times V in a fresh sum each 64-key tile. After
    the bf16 rounding of O it meets ``chip_smoke.py``'s bf16 gate against
    the Pallas kernel in interpret mode on the same bf16 inputs (|Δ| <=
    2^-7·|O| + 1e-6). In f32 before the rounding it errs no more than 1.5x
    the ``mma.sync`` loop's order (a fresh sum each k16 step, 32-key
    tiles) against float64 attention, by the largest error and by the RMS
    (~1.0x here). The designs not taken err more by the RMS: one chain over
    the head for Q·Kᵀ (~1.25x, the tensor core truncating the second half
    on the first's grid), and P·V straight into the running O (~1.9x: the
    small terms truncated on O's grid), which is why the kernel sums as
    it does."""
    BH, S, hd = 2, 256, 128
    q, k, v = (torch.from_numpy(_randn((BH, S, hd), seed)).bfloat16().float()
               for seed in (41, 42, 43))
    want = torch.from_numpy(np.array(flash_attention_tpu(
        *(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v)), attn_softcap=softcap,
        interpret=True).astype(jnp.float32)))
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * hd ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    exact = torch.softmax(s, dim=-1) @ v.double()
    runs = {"present": ("step", "step", 32), "kernel": ("stage", "tile", 64),
            "qk_chain": ("chain", "tile", 64), "pv_into_o": ("stage", "into_o", 64)}
    out = {name: _flash_tc(q, k, v, softcap, *how) for name, how in runs.items()}
    got = out["kernel"].bfloat16().float()
    assert float(((got - want).abs() - 2.0 ** -7 * want.abs()).max()) <= 1e-6
    err = {name: (x.double() - exact) for name, x in out.items()}
    top = {name: float(e.abs().max()) for name, e in err.items()}
    rms = {name: float(e.pow(2).mean().sqrt()) for name, e in err.items()}
    assert top["kernel"] <= 1.5 * top["present"] and rms["kernel"] <= 1.5 * rms["present"], (
        top, rms)
    assert rms["qk_chain"] >= 1.1 * rms["kernel"] and rms["pv_into_o"] >= 1.4 * rms["kernel"], rms


def test_flash_wgmma_route_and_scratch_sizes():
    """Which loop a call at (dtype, hd) takes and the K/V scratch it needs:
    bf16 at hd 128 on the wgmma loop with none (TMA reads K and V in
    place); bf16 at hd 64, 112 and 256, or at 128 routed back, on
    ``flash_fwd_mma<hd, bf16>`` after flash_pad's one plane each, padded to
    whole key tiles (gemma2-2b's 4500-token prompt: 2 planes of 4 heads x
    4512 keys x 256); every f32 head width keeps flash_split's planes,
    2·3·(BH / n_rep)·Skp·hd; a head width the kernel is not built for is
    refused at either dtype."""
    from repro_torch.kernels.flash_attention import (BF16_HEAD_DIMS, HEAD_DIMS, on_wgmma, route,
                                                     scratch_elems)

    bf, f32 = torch.bfloat16, torch.float32
    assert BF16_HEAD_DIMS == HEAD_DIMS
    assert route(bf, 128) == ["flash_fwd_wg"] and on_wgmma(bf, 128)
    assert scratch_elems(128, 512, 128, 2, bf, 32) == 0
    assert scratch_elems(8, 1001, 128, 2, bf, 32) == 0
    assert route(bf, 128, wgmma=False) == ["flash_pad", "flash_fwd_mma<128, bf16>"]
    assert scratch_elems(8, 1001, 128, 2, bf, 32, wgmma=False) == 2 * 4 * 1024 * 128
    for hd in (64, 112, 256):
        for wgmma in (True, False):
            assert route(bf, hd, wgmma) == ["flash_pad", f"flash_fwd_mma<{hd}, bf16>"]
            assert not on_wgmma(bf, hd, wgmma)
        for BH, Sk, n_rep in ((64, 512, 2), (8, 37, 1), (256, 1001, 2)):
            skp = -(-Sk // 32) * 32
            assert scratch_elems(BH, Sk, hd, n_rep, bf, 32) == 2 * (BH // n_rep) * skp * hd
    assert scratch_elems(8, 4500, 256, 2, bf, 32) == 2 * 4 * 4512 * 256
    for hd in HEAD_DIMS:
        assert route(f32, hd) == ["flash_split", f"flash_fwd_mma<{hd}>"]
        assert not on_wgmma(f32, hd)
        for BH, Sk, n_rep in ((128, 512, 2), (8, 37, 1), (12, 1001, 6)):
            skp = -(-Sk // 32) * 32
            assert scratch_elems(BH, Sk, hd, n_rep, f32, 32) == 2 * 3 * (BH // n_rep) * skp * hd
    for hd in (32, 96, 192):
        for dtype in (bf, f32):
            with pytest.raises(ValueError):
                route(dtype, hd)
            with pytest.raises(ValueError):
                scratch_elems(8, 64, hd, 1, dtype, 32)


@pytest.mark.parametrize("harness,source", [("ce_fwd_variants", "lmhead_ce.cu"),
                                            ("ce_fwd_variants", "wgmma_loop.cuh"),
                                            ("qmm_variants", "quant_matmul.cu"),
                                            ("flash_variants", "flash_attention.cu"),
                                            ("skinny_variants", "skinny.cuh")])
def test_variant_harness_edits_apply_to_the_shipped_source(harness, source):
    """Each variant of a kernel's timing harness replaces text that occurs
    exactly once in the source it builds from, so a kernel edit that moves
    such text fails here rather than on the card. An edit is (old, new)
    in the harness's first source, or (source, old, new) in a header."""
    import importlib

    from repro_torch.kernels import _build

    variants = importlib.import_module(f"repro_torch.kernels.{harness}").VARIANTS
    text = (_build.CSRC / source).read_text()
    assert "shipped" in variants and not variants["shipped"]
    first = {"ce_fwd_variants": "lmhead_ce.cu"}.get(harness, source)
    for name, edits in variants.items():
        for edit in edits:
            where, old, new = edit if len(edit) == 3 else (first, *edit)
            assert (_build.CSRC / where).exists(), (name, where)
            if where == source:
                assert text.count(old) == 1 and new != old, (name, old)


# ---------------------------------------------------------------------------
# the build's cache key
# ---------------------------------------------------------------------------


def test_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source, the shared headers and
    the flags: editing a header renames (so rebuilds) every library, and
    every header a real source includes is one the hash reads."""
    import re

    from repro_torch.kernels import _build

    real = _build.CSRC
    for src in real.glob("*.cu"):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and (real / inc).is_file(), (src.name, inc)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
