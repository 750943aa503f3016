"""Paged-KV decode attention (the serving engine's core).

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``_kernel`` / ``_paged_attention_call``, public ``paged_attention``),
with the CUDA kernel ``csrc/paged_attention.cu``: one decode step of
grouped-GQA attention over each request's pages up to ``lengths[b]``,
INT8 pages dequantized with per-(token, kv-head) scales, optional
sliding ``window`` and tanh ``attn_softcap``, f32/bf16/int8 pages, page
0 the null page.

What bounds it on the H100: bytes at long contexts — each attended K/V
row is read once (int8: 2·(hd + 4) bytes per token and kv head) for
4·n_rep·hd FLOPs — and at the serving shape the latency of one launch and
its dependent loads. The kernel runs one thread block cluster per
(request, group of kv heads); its ranks split the request's pages, stage
their rows into shared memory with asynchronous copies, score a stage at
a time, and merge their online-softmax states in rank order through
distributed shared memory (the source's note has the design).
:func:`plan` sets the grid. A padding row (length 0, null page) attends
one finite slot, so its output is finite. Limits on the card: hd in (64,
112, 128, 256), n_rep <= 8; page size and kv-head count are free. At
112 (kimi-k2) a row does not split into 8 equal loads, so its scoring
lanes take 16-byte chunks in turn (the source's note).

On CPU and meta tensors (``_build.plain_path``) the wrapper computes
:func:`~repro_torch.kernels.ref.paged_attention_ref`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import require
from repro_torch.kernels.ref import paged_attention_ref

#: launches of the CUDA kernel in this process (the CPU path does not count)
launches = 0

HEAD_DIMS = (64, 112, 128, 256)
BF16_Q_HEAD_DIMS = HEAD_DIMS  # a bf16 q's (a bf16 backbone's decode): every one
_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
KIND_BYTES = {0: 1, 1: 4, 2: 2}  # bytes an element of each page kind

# paged_attention.cu's constants
WARPS = 8          # a block's warps
MAX_ROWS = 8       # query rows a block: kv heads x n_rep
MAX_RANKS = 8      # the portable cluster size
STAGE_BYTES = 8192  # K (and V) bytes a ring stage holds at most
MAX_CHUNK = 64     # (token, kv head) rows a stage at most
#: blocks an SM holds, by hd (``min_blocks<HD>()`` in the source's
#: __launch_bounds__): one at 256, whose P·V sums need the registers
RESIDENT = {64: 2, 112: 2, 128: 2, 256: 1}


class Plan(NamedTuple):
    ranks: int  # blocks of a cluster, rank r taking pages [r * pages, (r + 1) * pages)
    pages: int  # block-table pages a rank
    heads: int  # kv heads a block
    chunk: int  # tokens a ring stage holds


def chunk_rows(hd: int, kind: int) -> int:
    """(token, kv head) rows a ring stage holds: 8 KB of K, at most 64
    (at hd 256: 8 f32, 16 bf16 or 32 int8 rows)."""
    return min(MAX_CHUNK, STAGE_BYTES // (hd * KIND_BYTES[kind]))


@functools.lru_cache(maxsize=512)
def plan(B: int, Hkv: int, n_rep: int, hd: int, page: int, max_pages: int, kind: int,
         sms: int) -> Plan:
    """The grid for q (B, Hkv, n_rep, hd) over a (B, max_pages) block
    table of ``page``-token pages of ``kind`` (0 int8, 1 f32, 2 bf16) on a
    card of ``sms`` SMs, from shapes alone (lengths live on the card).

    One wave is ``RESIDENT[hd]`` blocks an SM. kv heads are grouped in a
    block (a power of two dividing Hkv, with heads x n_rep <= 8 query
    rows) only while the (request, head group) pairs still fill that wave;
    then each pair's pages are split over as many ranks, up to 8, as the
    wave holds. Rank r takes pages [r * pages, (r + 1) * pages) of the
    table, and every rank has at least one. At the serving shape (B = 8,
    Hkv = 8, n_rep = 2, max_pages 34) on 132 SMs: 4 ranks of 9 pages, one
    head a block, 256 blocks, which ``paged_variants.py`` measured fastest
    there (PERF.md). At gemma2-2b's (B = 8, Hkv = 4, n_rep = 2, hd = 256,
    one block an SM): 4 ranks, one head a block, 128 blocks. q's dtype
    does not enter: a bf16 q is widened to f32 as it is staged, so its
    shared memory and stages are an f32 q's at every hd.
    """
    if not (B >= 1 and Hkv >= 1 and 1 <= n_rep <= MAX_ROWS and hd in HEAD_DIMS and page >= 1
            and max_pages >= 1 and kind in KIND_BYTES and sms >= 1):
        raise ValueError(f"no paged-attention plan for B={B} Hkv={Hkv} n_rep={n_rep} hd={hd} "
                         f"page={page} max_pages={max_pages} kind={kind}")
    wave = RESIDENT[hd] * sms
    heads = 1
    while (2 * heads <= WARPS and Hkv % (2 * heads) == 0 and 2 * heads * n_rep <= MAX_ROWS
           and B * Hkv // (2 * heads) >= wave):
        heads *= 2
    ranks = max(1, min(MAX_RANKS, max_pages, wave // (B * Hkv // heads)))
    pages = -(-max_pages // ranks)
    return Plan(-(-max_pages // pages), pages, heads, chunk_rows(hd, kind) // heads)


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(t: torch.Tensor, B: int, Hkv: int, n_rep: int, hd: int, page: int, max_pages: int,
             kind: int) -> Plan:
    """:func:`plan` on ``t``'s card."""
    return plan(B, Hkv, n_rep, hd, page, max_pages, kind, _sms(t.device.index))


def require_card_shape(hd: int, n_rep: int, q_dtype=torch.float32) -> None:
    """The head widths the kernel is built for (the same for an f32 and a
    bf16 q) and the query rows a block holds: any other is refused on the
    card (the plain version on the CPU takes any)."""
    require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS} for a {q_dtype} q")
    require(n_rep <= MAX_ROWS, f"n_rep {n_rep} > {MAX_ROWS}")


def _fn():
    lib = _build.library("paged_attention")
    fn = lib.paged_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention -> (B, Hkv, n_rep, hd) f32.

    q: (B, Hkv, n_rep, hd) f32 or bf16 (a bf16 backbone's: widened to
    f32 exactly as it is staged; the output stays f32, as the
    reference's) post-rope new-token query; k/v_pages:
    (n_pages, page, Hkv, hd) — int8 with ``k_scale``/``v_scale``
    (n_pages, page, Hkv) f32, or plain f32/bf16; block_tables:
    (B, max_pages) int32 (page 0 is the null page); lengths: (B,) int32,
    the index the new token was written at (``kpos <= lengths[b]``).
    """
    global launches
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    require(q.ndim == 4, "q must be (B, Hkv, n_rep, hd)")
    B, hkv, n_rep, hd = q.shape
    require(k_pages.ndim == 4 and k_pages.shape == v_pages.shape
            and k_pages.shape[2:] == (hkv, hd),
            f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    require(block_tables.ndim == 2 and block_tables.shape[0] == B and lengths.shape == (B,),
            "block_tables must be (B, max_pages) and lengths (B,)")
    quantized = k_scale is not None
    if quantized:
        require(k_pages.dtype == torch.int8, "scaled pages must be int8")
        require(k_scale.shape == v_scale.shape == k_pages.shape[:3], "scale shape")
    else:
        require(k_pages.dtype in (torch.float32, torch.bfloat16),
                "unscaled pages must be float32 or bfloat16")
    require(window is None or window > 0, "window must be positive")
    require(attn_softcap is None or attn_softcap > 0, "attn_softcap must be positive")
    if _build.plain_path(q):
        return _build.run_plain("paged_attention", paged_attention_ref, q, k_pages, v_pages,
                                block_tables, lengths, k_scale=k_scale, v_scale=v_scale,
                                window=window, attn_softcap=attn_softcap)
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    tensors = [q, k_pages, v_pages, block_tables, lengths] + ([k_scale, v_scale] if quantized else [])
    require(all(t.device == q.device for t in tensors), "arguments on different devices")
    require(all(t.is_contiguous() for t in tensors), "arguments must be contiguous")
    require(q.dtype in (torch.float32, torch.bfloat16), f"q must be float32 or bfloat16, "
                                                       f"got {q.dtype}")
    require(block_tables.dtype == torch.int32 and lengths.dtype == torch.int32,
            "block_tables and lengths must be int32")
    require(k_pages.dtype == v_pages.dtype, "k and v pages must share a dtype")
    require_card_shape(hd, n_rep, q.dtype)
    max_pages = block_tables.shape[1]
    kind = _KIND[k_pages.dtype]
    p = plan_for(q, B, hkv, n_rep, hd, k_pages.shape[1], max_pages, kind)
    lib, fn = _fn()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ks = k_scale.data_ptr() if quantized else None
    vs = v_scale.data_ptr() if quantized else None
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, hkv, n_rep, hd, k_pages.shape[1], max_pages, kind, window or 0,
            attn_softcap or 0.0, hd ** -0.5, *p, int(q.dtype == torch.bfloat16),
            _build.stream_of(q))
    _build.check(lib, rc, "paged_attention")
    launches += 1
    return out
