"""The serving decode step's paged attention (``csrc/paged_attention.cu``)
on the CPU: its plan, and a float32 model of its order against the JAX
Pallas kernel (interpret mode).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against its plain version. Here the plan the wrapper passes to the kernel
(``repro_torch.kernels.paged_attention.plan``) is checked to cover every
page once, and a numpy model of the kernel's order — each rank's pages
staged a chunk at a time, the chunk's scores, one max and one exp a score,
P·V summed by warps over rows w, w + 8, ... and then in warp order, and
the ranks' (m, l, acc) merged in rank order, an empty rank adding 0 — is
held to the reference's kernel at the reference's tolerances
(tests/test_decode_parity.py:36).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propcheck import given, settings, strategies as st

from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.serve.paging import quantize_kv_pages as jax_quantize_kv_pages
from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)
SMS = 132  # an H100 SXM's SMs
PAGED_TOL = {"f32": 2e-4, "bf16": 3e-2, "int8": 2e-4}  # test_decode_parity.py:36
KIND = {"int8": 0, "f32": 1, "bf16": 2}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _check_plan(B, Hkv, n_rep, hd, page, max_pages, kind, sms):
    p = pa.plan(B, Hkv, n_rep, hd, page, max_pages, kind, sms)
    # rank r takes pages [r * pages, (r + 1) * pages): every page once, no rank empty
    covered = [pg for r in range(p.ranks) for pg in range(r * p.pages, (r + 1) * p.pages)
               if pg < max_pages]
    assert covered == list(range(max_pages)), p
    assert 1 <= p.ranks <= pa.MAX_RANKS and (p.ranks - 1) * p.pages < max_pages, p
    assert p.heads in (1, 2, 4, 8) and Hkv % p.heads == 0 and p.heads * n_rep <= pa.MAX_ROWS
    assert p.chunk == pa.chunk_rows(hd, kind) // p.heads >= 1
    return p


@settings(max_examples=200)
@given(B=st.integers(1, 64), Hkv=st.sampled_from([1, 2, 3, 4, 6, 8, 16, 32]),
       n_rep=st.integers(1, 8), hd=st.sampled_from([64, 128, 256]), page=st.sampled_from([1, 4, 16, 64]),
       max_pages=st.integers(1, 300), kind=st.sampled_from([0, 1, 2]),
       sms=st.sampled_from([1, 16, 78, 114, 132]))
def test_paged_plan_covers_every_page_once(B, Hkv, n_rep, hd, page, max_pages, kind, sms):
    p = _check_plan(B, Hkv, n_rep, hd, page, max_pages, kind, sms)
    blocks = p.ranks * B * Hkv // p.heads
    wave = pa.RESIDENT[hd] * sms
    # ranks only while the wave holds them; heads only while the pairs fill it
    assert p.ranks == 1 or blocks <= wave, p
    assert p.heads == 1 or B * Hkv // p.heads >= wave, p


@pytest.mark.parametrize("max_pages", [32, 33, 34])
def test_paged_plan_fills_the_card_at_the_serving_shape(max_pages):
    """B = 8, Hkv = 8, n_rep = 2, hd = 128, int8 pages of 16 tokens
    (max_len 512–544): at least 128 blocks in one wave."""
    p = _check_plan(8, 8, 2, 128, 16, max_pages, 0, SMS)
    blocks = p.ranks * 8 * 8 // p.heads
    assert 128 <= blocks <= pa.RESIDENT[128] * SMS, p
    assert pa.plan(8, 8, 2, 128, 16, 34, 0, SMS) == pa.Plan(4, 9, 1, 64)


def test_paged_plan_refuses_what_the_kernel_does_not_take():
    for args in ((8, 8, 9, 128, 16, 34, 0), (8, 8, 2, 96, 16, 34, 0), (0, 8, 2, 128, 16, 34, 0),
                 (8, 8, 2, 128, 16, 34, 3)):
        with pytest.raises(ValueError):
            pa.plan(*args, SMS)


# ---------------------------------------------------------------------------
# the kernel's order, modelled in float32
# ---------------------------------------------------------------------------


def emulate(q, k, v, ks, vs, bt, lengths, window, cap, p):
    """paged_attention.cu's arithmetic in its order, in float32 numpy."""
    f32 = np.float32
    B, Hkv, n_rep, hd = q.shape
    page, max_pages = k.shape[1], bt.shape[1]
    heads, tc, warps = p.heads, p.chunk, pa.WARPS
    scale = f32(hd ** -0.5)
    out = np.zeros_like(q)
    for b in range(B):
        pos = int(lengths[b])
        lo = max(0, pos - window + 1) if window else 0
        hi = min(pos, max_pages * page - 1)
        for g0 in range(0, Hkv, heads):
            qb = q[b, g0:g0 + heads]  # (heads, n_rep, hd)
            parts = []
            for rank in range(p.ranks):
                p0 = rank * p.pages
                t0 = max(lo, p0 * page)
                t1 = min(hi, min(p0 + p.pages, max_pages) * page - 1)
                m = np.full((heads, n_rep), -1e30, f32)
                l = np.zeros((heads, n_rep), f32)
                acc = np.zeros((warps, n_rep, hd), f32)  # warp w: kv head w % heads
                for tb in range(t0, t1 + 1, tc):
                    toks = np.arange(tb, min(tb + tc, t1 + 1))
                    pid, slot = bt[b, toks // page], toks % page
                    kr = k[pid, slot, g0:g0 + heads]  # (n, heads, hd)
                    vr = v[pid, slot, g0:g0 + heads]
                    if ks is not None:  # float(q) * scale, rounded to f32
                        kr = kr * ks[pid, slot, g0:g0 + heads][..., None]
                        vr = vr * vs[pid, slot, g0:g0 + heads][..., None]
                    s = np.einsum("grd,tgd->grt", qb, kr).astype(f32) * scale
                    if cap:
                        s = f32(cap) * np.tanh(s / f32(cap))
                    m_new = np.maximum(m, s.max(-1))
                    pr = np.exp(s - m_new[..., None])
                    alpha = np.exp(m - m_new)
                    l = l * alpha + pr.sum(-1)
                    m = m_new
                    n = len(toks)
                    for w in range(warps):  # rows j = t * heads + g, warp j % 8
                        g = w % heads
                        acc[w] *= alpha[g][:, None]
                        for j in range(w, n * heads, warps):
                            t = j // heads
                            acc[w] += pr[g][:, t:t + 1] * vr[t, g][None, :]
                o = np.zeros((heads, n_rep, hd), f32)
                for w in range(warps):  # the warps in warp order
                    o[w % heads] += acc[w]
                parts.append((m, l, o))
            M = np.max([pm for pm, _, _ in parts], axis=0)
            L = np.zeros_like(M)
            O = np.zeros((heads, n_rep, hd), f32)
            for pm, pl, po in parts:  # rank order
                c = np.exp(pm - M)
                L += pl * c
                O += po * c[..., None]
            out[b, g0:g0 + heads] = O / np.maximum(L, f32(1e-30))[..., None]
    return out


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


B, HKV, N_REP, HD, PAGE, MAX_PAGES = 6, 4, 2, 64, 4, 24
# the padding row (length 0 on the null page), lengths on page edges, and
# one past the table's end
LENGTHS = np.array([0, PAGE - 1, PAGE, MAX_PAGES * PAGE - 1, 57, MAX_PAGES * PAGE + 4], np.int32)


def _case(policy, hd=HD, hkv=HKV, n_rep=N_REP):
    rng = np.random.default_rng(7)
    n_pages = B * MAX_PAGES + 1
    q = _randn((B, hkv, n_rep, hd), 1)
    kf, vf = _randn((n_pages, PAGE, hkv, hd), 2), _randn((n_pages, PAGE, hkv, hd), 3)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    bt = np.zeros((B, MAX_PAGES), np.int32)
    for b in range(1, B):  # row 0 stays on the null page
        n = min(MAX_PAGES, -(-(int(LENGTHS[b]) + 1) // PAGE))
        bt[b, :n] = perm[b * MAX_PAGES:b * MAX_PAGES + n]
    if policy == "int8":
        (kq, ks), (vq, vs) = (jax_quantize_kv_pages(jnp.asarray(t)) for t in (kf, vf))
        return q, (np.array(kq), np.array(vq)), (np.array(ks), np.array(vs)), bt
    if policy == "bf16":  # the same bf16 values on both sides
        kf, vf = (torch.from_numpy(t).bfloat16().float().numpy() for t in (kf, vf))
    return q, (kf, vf), (None, None), bt


OPTIONS = {"plain": (None, None), "window64_cap30": (64, 30.0),
           "window9": (9, None)}  # window 9 leaves most ranks of each row empty


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_paged_kernel_order_matches_pallas(policy, option):
    _order_matches_pallas(policy, option, HD)


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_paged_kernel_order_matches_pallas_at_hd256(policy):
    """The same model at gemma2-2b's head width, with its window and
    soft-cap: the plan at hd 256 counts one block an SM."""
    _order_matches_pallas(policy, "window64_cap30", 256)


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_paged_kernel_order_matches_pallas_at_hd112(policy):
    """The same model at kimi-k2's head width 112, whose rows split into
    16-byte chunks taken by the scoring lanes in turn (the sum over a
    row's dims is the model's either way), and whose plan counts two
    blocks an SM."""
    _order_matches_pallas(policy, "window64_cap30", 112)
    assert pa.RESIDENT[112] == 2 and pa.chunk_rows(112, 0) == 64


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_paged_kernel_order_matches_pallas_at_n_rep7(policy):
    """The same model at qwen2-vl-7b's grouping, 7 query heads a kv head
    (28 over 4 kv heads, as here) at hd 128: the first odd count of query
    rows, 7 of a block's 8 live."""
    _order_matches_pallas(policy, "window64_cap30", 128, hkv=4, n_rep=7)
    _order_matches_pallas(policy, "plain", 128, hkv=4, n_rep=7)
    pa.require_card_shape(128, 7)


@pytest.mark.parametrize("hd", pa.HEAD_DIMS)
@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_paged_kernel_order_matches_pallas_with_a_bf16_q(policy, hd):
    """A bf16 backbone's query at every head width: the kernel widens it to
    f32 exactly as it stages it, so the model is the f32 q's on q's bf16
    values, held to the Pallas kernel given the bf16 q (its output f32, as
    the port's); the plans are an f32 q's."""
    _order_matches_pallas(policy, "window64_cap30", hd, q_bf16=True)


@pytest.mark.parametrize("hd", pa.HEAD_DIMS)
def test_paged_plan_takes_a_bf16_q_at_every_head_width(hd):
    """The card's guard admits a bf16 q at every head width the kernel is
    built for, up to 8 query rows a kv head, and refuses more. q's dtype
    enters neither the plan nor the kernel's shared memory (its rows are
    widened to f32 as they are staged), so a bf16 q takes an f32 q's plan
    over every page kind: at gemma2-2b's serving shape (B 8, Hkv 4, n_rep
    2, hd 256, 32 pages of 16) 4 ranks of 8 pages, one head a block, and a
    stage of 32 int8, 16 bf16 or 8 f32 rows."""
    assert pa.BF16_Q_HEAD_DIMS == pa.HEAD_DIMS
    for n_rep in (1, 2, pa.MAX_ROWS):
        pa.require_card_shape(hd, n_rep, torch.bfloat16)
    with pytest.raises(ValueError, match="n_rep"):
        pa.require_card_shape(hd, pa.MAX_ROWS + 1, torch.bfloat16)
    for kind in KIND.values():
        for B, Hkv, n_rep in ((8, 4, 2), (8, 8, 8), (8, 12, 1), (1, 4, 2)):
            _check_plan(B, Hkv, n_rep, hd, 16, 32, kind, SMS)
    if hd == 256:
        assert [pa.plan(8, 4, 2, 256, 16, 32, k, SMS) for k in (0, 2, 1)] == [
            pa.Plan(4, 8, 1, c) for c in (32, 16, 8)]


def _order_matches_pallas(policy, option, hd, hkv=HKV, n_rep=N_REP, q_bf16=False):
    window, cap = OPTIONS[option]
    q, (k, v), (ks, vs), bt = _case(policy, hd, hkv, n_rep)
    jq = jnp.asarray(q, jnp.bfloat16) if q_bf16 else jnp.asarray(q)
    if q_bf16:  # the kernel's exact widening of q's bf16 values
        q = torch.from_numpy(q).bfloat16().float().numpy()
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if policy == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    want = np.asarray(jax_paged_attention(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(LENGTHS),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        window=window, attn_softcap=cap, interpret=True))
    kf, vf = k.astype(np.float32), v.astype(np.float32)
    kind = KIND[policy]
    chunk = pa.chunk_rows(hd, kind)
    plans = [pa.plan(B, hkv, n_rep, hd, PAGE, MAX_PAGES, kind, SMS),  # 8 ranks of 3 pages
             pa.Plan(2, 12, 2, chunk // 2),  # two heads a block, a stage of chunk / 2 tokens
             pa.Plan(1, MAX_PAGES, 4, chunk // 4),  # no cluster: several stages a rank
             pa.Plan(5, 5, 1, chunk)]  # a short last rank
    for p in plans:
        got = emulate(q, kf, vf, ks, vs, bt, LENGTHS, window, cap, p)
        assert np.isfinite(got).all(), p
        np.testing.assert_allclose(got, want, atol=PAGED_TOL[policy], err_msg=str(p))
    if option == "window9":  # rows whose window leaves ranks empty exist
        p = plans[0]
        pos = LENGTHS[3]
        assert (pos - 9 + 1) // PAGE > p.pages  # ranks 0.. hold no attended page


def test_paged_variant_edits_apply_to_the_shipped_source():
    """Each variant of ``paged_variants.py`` replaces text that occurs
    exactly once in ``csrc/paged_attention.cu``, so a kernel edit that
    moves such text fails here rather than on the card."""
    from repro_torch.kernels import _build, paged_variants

    text = (_build.CSRC / "paged_attention.cu").read_text()
    assert "shipped" in paged_variants.VARIANTS and not paged_variants.VARIANTS["shipped"]
    for name, edits in paged_variants.VARIANTS.items():
        for old, new in edits:
            assert text.count(old) == 1 and new != old, (name, old)
