"""Paged KV cache: page pools, free-list allocator, page tables.

Counterpart of ``repro.serve.paging``. Every request's KV lives in
fixed-size **pages** drawn from one pool per attention pattern position,
stacked over periods:

* ``int8`` — ``{"q": int8 (n_p, n_pages, page, Hkv, hd),
  "scale": f32 (n_p, n_pages, page, Hkv)}`` per K and V: absmax
  quantization per (token, kv head). Pages are dequantized only inside
  the attention ops; this module writes pages and never reads them back.
* ``f32`` / ``bf16`` — plain tensors of the same page geometry.

An SSM pattern position holds per-slot **state rows** instead, (n_p,
n_slots, ...) leaves: one row per engine slot, kept compact by the
engine.

Page id **0 is the null page**: allocators never hand it out, padded
prompt positions and padding rows write their garbage there, and
attention masks it by position. Page writes update the pool tensors
**in place** (the reference returns new arrays).

:class:`PageAllocator` and :class:`PageTable` are plain Python on the
host, run between steps, and export numpy block tables.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import ssm

KV_POLICIES = ("f32", "bf16", "int8")


class OutOfPagesError(RuntimeError):
    """The pool has no free page left — admit fewer/shorter requests."""


# ---------------------------------------------------------------------------
# Device pools
# ---------------------------------------------------------------------------


def quantize_kv_pages(t: torch.Tensor):
    """Per-(token, kv-head) absmax INT8 over the last axis.
    t: (..., Hkv, hd) -> int8 payload + f32 scale (..., Hkv)."""
    tf = t.float()
    absmax = tf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _attn_pool(cfg, n_pages: int, page: int, policy: str, device):
    shape = (cfg.n_periods, n_pages, page, cfg.n_kv_heads, cfg.hd)
    if policy == "int8":
        def entry():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
        return {"k": entry(), "v": entry()}
    dtype = torch.bfloat16 if policy == "bf16" else torch.float32
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_state_rows(cfg, spec, n_slots: int, device=None) -> dict:
    """Per-slot recurrent state rows for one non-attention pattern
    position, stacked over periods: (n_p, n_slots, ...) leaves."""
    return ssm.init_state(cfg, spec.kind, n_slots, device=device, lead=cfg.n_periods)


def init_pools(cfg, n_pages: int, page: int, policy: str = "int8", device=None,
               n_slots: int = 0):
    """One entry per pattern position: a page pool for attention
    (``n_pages`` includes the null page, so usable pages = n_pages - 1),
    ``n_slots`` per-slot state rows for an SSM kind."""
    if policy not in KV_POLICIES:
        raise ValueError(f"kv policy must be one of {KV_POLICIES}, got {policy!r}")
    return [_attn_pool(cfg, n_pages, page, policy, device) if spec.kind == "attn"
            else init_state_rows(cfg, spec, n_slots, device) for spec in cfg.pattern]


def is_paged_entry(entry) -> bool:
    """True for an attention page pool ({"k": ..., "v": ...})."""
    return isinstance(entry, dict) and set(entry) == {"k", "v"}


def period_entry(entry, i: int):
    """Period ``i`` of a pool entry (views: writes land in the pool)."""
    if not is_paged_entry(entry):
        return {name: t[i] for name, t in entry.items()}
    if isinstance(entry["k"], dict):
        return {kv: {f: entry[kv][f][i] for f in ("q", "scale")} for kv in ("k", "v")}
    return {"k": entry["k"][i], "v": entry["v"][i]}


def entry_page_size(entry) -> int:
    leaf = entry["k"]["q"] if isinstance(entry["k"], dict) else entry["k"]
    return leaf.shape[-3]


# ---------------------------------------------------------------------------
# Page writes (one period slice of a pool, in place)
# ---------------------------------------------------------------------------


def _write(entry, k, v, pages, offs) -> None:
    """k, v: (N, Hkv, hd) to slots (pages[n], offs[n]). Duplicate targets
    (the null page) resolve arbitrarily — it holds garbage by contract."""
    if isinstance(entry["k"], dict):
        for name, t in (("k", k), ("v", v)):
            q, scale = quantize_kv_pages(t)
            entry[name]["q"][pages, offs] = q
            entry[name]["scale"][pages, offs] = scale
    else:
        entry["k"][pages, offs] = k.to(entry["k"].dtype)
        entry["v"][pages, offs] = v.to(entry["v"].dtype)


def _token_coords(block_tables, lengths, page: int):
    """Page/offset of the slot each request's *next* token lands in."""
    max_pages = block_tables.shape[1]
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    idx = torch.clamp_max(lengths // page, max_pages - 1)
    return block_tables[rows, idx].long(), (lengths % page).long()


def write_token_kv(entry, k, v, block_tables, lengths) -> None:
    """Write one new token's K/V into the pages. ``entry`` is one period
    slice of an attention pool (:func:`period_entry`); k, v: (B, 1, Hkv,
    hd) post-rope; lengths: (B,) write index. Padding rows must point
    their block-table row at the null page."""
    page = entry_page_size(entry)
    pages, offs = _token_coords(block_tables, lengths, page)
    _write(entry, k[:, 0], v[:, 0], pages, offs)


def write_prompt_kv(entry, k, v, block_tables, lengths) -> None:
    """Scatter a whole prompt's K/V into the pages. ``entry`` is one
    period slice; k, v: (B, S, Hkv, hd); positions ``s >= lengths[b]``
    (padding) go to the null page."""
    page = entry_page_size(entry)
    B, S = k.shape[:2]
    max_pages = block_tables.shape[1]
    s_idx = torch.arange(S, device=k.device)
    rows = torch.arange(B, device=k.device)[:, None]
    pages = block_tables[rows, torch.clamp_max(s_idx[None, :] // page, max_pages - 1)]
    valid = s_idx[None, :] < lengths[:, None]
    pages = torch.where(valid, pages, torch.zeros_like(pages)).long()
    offs = (s_idx % page).expand(B, S)
    _write(entry, k.reshape((B * S,) + k.shape[2:]), v.reshape((B * S,) + v.shape[2:]),
           pages.reshape(-1), offs.reshape(-1))


def kv_bytes_per_token(cfg, policy: str) -> int:
    """Device bytes one token's KV occupies across all attention layers."""
    n_attn = sum(1 for s in cfg.pattern if s.kind == "attn") * cfg.n_periods
    width = {"f32": 4, "bf16": 2, "int8": 1}[policy]
    per_layer = 2 * cfg.n_kv_heads * cfg.hd * width
    if policy == "int8":
        per_layer += 2 * cfg.n_kv_heads * 4  # f32 absmax scales
    return n_attn * per_layer


# ---------------------------------------------------------------------------
# Host-side allocator + page table
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free-list block allocator over page ids ``1..n_pages-1`` (page 0
    is the null page and is never handed out)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (one is the null page)")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() -> low ids first

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPagesError(f"requested {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)


class PageTable:
    """Per-request page-id runs over a shared :class:`PageAllocator`.

    Token ``t`` of a request lives in its ``t // page``-th page.
    :meth:`ragged` is the ``(indptr, pages)`` view; :meth:`dense` exports
    the ``(B, max_pages)`` block table + lengths the kernels consume
    (unused entries = the null page)."""

    def __init__(self, allocator: PageAllocator, page: int, max_pages: int):
        self.allocator = allocator
        self.page = page
        self.max_pages = max_pages
        self._pages: Dict[int, List[int]] = {}
        self._len: Dict[int, int] = {}

    def open(self, rid: int, n_tokens: int = 0) -> None:
        if rid in self._pages:
            raise ValueError(f"request {rid} already open")
        self._pages[rid], self._len[rid] = [], 0
        if n_tokens:
            self.extend_to(rid, n_tokens)
            self._len[rid] = n_tokens

    def close(self, rid: int) -> None:
        self.allocator.free(self._pages.pop(rid))
        del self._len[rid]

    def length(self, rid: int) -> int:
        return self._len[rid]

    def extend_to(self, rid: int, n_tokens: int) -> None:
        """Grow the page run to cover ``n_tokens`` tokens (allocates)."""
        need = -(-n_tokens // self.page)
        if need > self.max_pages:
            raise OutOfPagesError(
                f"request {rid}: {n_tokens} tokens need {need} pages "
                f"> max_pages {self.max_pages}")
        have = len(self._pages[rid])
        if need > have:
            self._pages[rid].extend(self.allocator.alloc(need - have))

    def append_token(self, rid: int) -> None:
        """Account one more token, allocating a page on a boundary."""
        self.extend_to(rid, self._len[rid] + 1)
        self._len[rid] += 1

    def ragged(self, rids: Optional[Sequence[int]] = None):
        """(indptr (B+1,), pages (nnz,)) int32 — CSR page runs."""
        rids = list(self._pages) if rids is None else list(rids)
        indptr = np.zeros(len(rids) + 1, np.int32)
        flat: List[int] = []
        for i, rid in enumerate(rids):
            flat.extend(self._pages[rid])
            indptr[i + 1] = len(flat)
        return indptr, np.asarray(flat, np.int32)

    def dense(self, rids: Sequence[int], rows: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """((rows, max_pages) block table, (rows,) lengths) int32 — rows
        beyond ``len(rids)`` are null-page/zero-length padding."""
        rows = len(rids) if rows is None else rows
        bt = np.zeros((rows, self.max_pages), np.int32)
        lengths = np.zeros(rows, np.int32)
        for i, rid in enumerate(rids):
            run = self._pages[rid]
            bt[i, : len(run)] = run
            lengths[i] = self._len[rid]
        return bt, lengths
