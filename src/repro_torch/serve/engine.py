"""Continuous-batching multi-tenant serving engine.

Counterpart of ``repro.serve.engine``. One :class:`ServeEngine` serves
many concurrent requests, each with its own per-user adapter, over one
shared KV page pool (``repro_torch.serve.paging``) and one frozen
(quantized) backbone.

* **Continuous batching** — requests join and leave the running decode
  batch between steps. A request's cache is its page-table row; only the
  per-slot rows (the adapter cache, SSM states) live at fixed indices,
  kept compacted to a prefix by swap-remove on completion, and zeroed
  when a stepwise request is admitted into one.
* **Power-of-two buckets** — each decode step runs at the smallest
  power of two ≥ the active count (capped at ``max_batch``) and prompts
  pad to a power-of-two length, exactly as the reference does, so shapes
  and therefore numerics match it. (The reference counts jit traces per
  bucket; eager PyTorch has none to count.)
* **Two prompt paths** (``prefill_mode``) — all-attention archs ingest
  the whole prompt in one batched forward
  (``repro_torch.serve.decode.paged_prefill``): ``"oneshot"``; SSM and
  hybrid archs feed the prompt through the decode step one token a step,
  in the same batch as the other requests' generated tokens:
  ``"stepwise"``.

The engine runs on the card unless asked for the CPU: ``device=None``
means ``cuda`` and raises when there is none.

Sampling is greedy (argmax). :meth:`submit` returns a
:class:`RequestHandle` whose ``tokens()`` generator streams ids;
:meth:`start` runs the step loop in a background thread, or call
:meth:`drain` inline.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.parallel_adapters import (
    gather_adapters,
    init_adapter_cache,
    stack_adapters,
)
from repro_torch.core.quantization import tree_leaves, tree_map
from repro_torch.serve import paging
from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class RequestHandle:
    """Streaming view of one request."""

    def __init__(self, rid: int, prompt: Sequence[int]):
        self.rid = rid
        self.prompt = list(prompt)
        self._queue = queue.Queue()
        self._done = threading.Event()
        self._generated: List[int] = []

    def _emit(self, tok: int) -> None:
        self._generated.append(tok)
        self._queue.put(tok)

    def _finish(self) -> None:
        self._done.set()
        self._queue.put(None)

    def tokens(self):
        """Yield generated token ids as they arrive (blocks; ends when
        the request completes)."""
        while True:
            t = self._queue.get()
            if t is None:
                return
            yield t

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until completion; returns all generated token ids."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still running")
        return list(self._generated)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "adapter_idx", "handle", "last_token",
                 "n_generated", "n_consumed", "finished")

    def __init__(self, rid, prompt, max_new, adapter_idx, n_consumed):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = max_new
        self.adapter_idx = adapter_idx
        self.handle = RequestHandle(rid, prompt)
        self.last_token = self.prompt[-1]
        self.n_generated = 0
        self.n_consumed = n_consumed  # prompt tokens already in the cache
        self.finished = False

    def next_input(self) -> int:
        if self.n_consumed < len(self.prompt):
            return self.prompt[self.n_consumed]
        return self.last_token

    def advance(self) -> bool:
        """Account one step. True while the step only consumed a prompt
        token (stepwise prefill: nothing to emit yet)."""
        if self.n_consumed < len(self.prompt):
            self.n_consumed += 1
            return self.n_consumed < len(self.prompt)
        return False


class ServeEngine:
    """Multi-tenant paged-KV serving engine (see module docstring).

    ``backbone_params`` may be the quantized frozen tree (with
    ``kernel_impl="cuda"`` the projections run on still-quantized
    weights); its tensors must live on the engine's device. ``adapters``
    maps user name → adapter tree, stacked once into a resident bank and
    gathered per request row at each step. ``kv_policy``: "int8", "bf16"
    or "f32". ``n_pages`` defaults to enough for ``max_batch``
    full-length requests (+ the null page). ``prefill_mode`` is
    ``"oneshot"`` for an all-attention pattern, else ``"stepwise"``.

    Timing counters (host clock; each step ends by reading its tokens
    back, which waits for the device): ``prefill_seconds``,
    ``decode_seconds``, ``decode_steps``, ``decode_tokens`` (rows run by
    the decode steps), ``stepwise_prompt_tokens`` (of those, the prompt
    tokens a stepwise step consumed without emitting).
    """

    def __init__(
        self,
        backbone_params,
        cfg,
        adapters: Optional[Dict[str, dict]] = None,
        *,
        r: int = 8,
        kernel_impl: str = "cuda",
        kv_policy: str = "int8",
        page_size: int = 8,
        max_len: int = 128,
        max_batch: int = 8,
        n_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        for leaf in tree_leaves(backbone_params):
            t = getattr(leaf, "q", leaf)
            if isinstance(t, torch.Tensor) and t.device != self.device:
                raise ValueError(f"backbone tensor on {t.device}, engine on {self.device}")
        self.backbone = backbone_params
        self.cfg = cfg
        self.r = r
        self.kernel_impl = kernel_impl
        self.kv_policy = kv_policy
        self.page = page_size
        self.max_len = max_len
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.max_pages = -(-max_len // page_size)
        if n_pages is None:
            n_pages = max_batch * self.max_pages + 1
        self.pools = paging.init_pools(cfg, n_pages, page_size, kv_policy, self.device,
                                       n_slots=max_batch)
        self._paged = [s.kind == "attn" for s in cfg.pattern]
        self.prefill_mode = "oneshot" if all(self._paged) else "stepwise"
        self.allocator = paging.PageAllocator(n_pages)
        self.table = paging.PageTable(self.allocator, page_size, self.max_pages)
        if adapters:
            self.adapter_names = list(adapters)
            self._adapter_idx = {n: i for i, n in enumerate(self.adapter_names)}
            self.bank = tree_map(lambda t: t.to(self.device),
                                 stack_adapters([adapters[n] for n in self.adapter_names]))
            self.acache = init_adapter_cache(cfg, max_batch, max_len, r, device=self.device)
        else:
            self.adapter_names, self._adapter_idx = [], {}
            self.bank, self.acache = None, None
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._active: List[_Request] = []
        self._next_rid = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.stepwise_prompt_tokens = 0

    # -- submission -----------------------------------------------------

    def submit(self, prompt: Sequence[int], adapter: Optional[str] = None,
               max_new_tokens: int = 16) -> RequestHandle:
        """Queue a request; returns its streaming handle (thread-safe)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {self.max_len}")
        if self.bank is not None:
            name = adapter if adapter is not None else self.adapter_names[0]
            if name not in self._adapter_idx:
                raise KeyError(f"unknown adapter {name!r}; have {self.adapter_names}")
            adapter_idx = self._adapter_idx[name]
        else:
            if adapter is not None:
                raise ValueError("engine was built without adapters")
            adapter_idx = 0
        with self._lock:
            n_consumed = len(prompt) if self.prefill_mode == "oneshot" else 0
            req = _Request(self._next_rid, prompt, max_new_tokens, adapter_idx, n_consumed)
            self._next_rid += 1
            self._pending.append(req)
        return req.handle

    def _pop_pending(self) -> Optional[_Request]:
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def _push_front(self, req: _Request) -> None:
        with self._lock:
            self._pending.appendleft(req)

    def _has_pending(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- row-state bookkeeping (adapter cache + SSM states) -------------

    def _row_leaves(self) -> list:
        """Every per-slot leaf, (n_p, max_batch, ...): the adapter cache's
        and the SSM state rows'."""
        rows = [e for e, paged in zip(self.pools, self._paged) if not paged]
        if self.acache is not None:
            rows.append(self.acache)
        return tree_leaves(rows)

    def _move_row(self, src: int, dst: int) -> None:
        for t in self._row_leaves():
            t[:, dst] = t[:, src]

    def _zero_row(self, row: int) -> None:
        """A fresh slot for a stepwise request: zeros, as the reference
        writes them (an sLSTM's stabiliser m too), so that no state of the
        slot's last request is inherited."""
        for t in self._row_leaves():
            t[:, row] = 0

    # -- admission ------------------------------------------------------

    def _admit(self) -> None:
        new_reqs: List[_Request] = []
        row0 = len(self._active)
        while len(self._active) < self.max_batch:
            req = self._pop_pending()
            if req is None:
                break
            if self.prefill_mode == "oneshot":
                need = -(-len(req.prompt) // self.page)
                if need > self.allocator.free_pages:
                    self._push_front(req)  # not enough pages yet
                    break
                self.table.open(req.rid, len(req.prompt))
            else:
                if self.allocator.free_pages < 1:
                    self._push_front(req)
                    break
                self.table.open(req.rid, 0)
                self._zero_row(len(self._active))
            self._active.append(req)
            new_reqs.append(req)
        if new_reqs and self.prefill_mode == "oneshot":
            self._run_prefill(new_reqs, row0)

    def _run_prefill(self, reqs: List[_Request], row0: int) -> None:
        t0 = time.perf_counter()
        n = len(reqs)
        bucket = _bucket(n, self.max_batch)
        s_pad = _bucket(max(len(r.prompt) for r in reqs), 1 << 30)
        tokens = np.zeros((bucket, s_pad), np.int32)
        user_idx = np.zeros(bucket, np.int32)
        for i, req in enumerate(reqs):
            tokens[i, : len(req.prompt)] = req.prompt
            user_idx[i] = req.adapter_idx
        bt, lengths = self.table.dense([r.rid for r in reqs], rows=bucket)
        ab = gather_adapters(self.bank, self._tensor(user_idx)) if self.bank is not None else None
        logits, self.pools, acaches = paged_prefill(
            self.backbone, ab, self._tensor(tokens), self._tensor(lengths), self.pools,
            self._tensor(bt), cfg=self.cfg, max_len=self.max_len, r=self.r,
            kernel_impl=self.kernel_impl)
        if acaches is not None:  # padding lanes are dropped
            for full, new in zip(tree_leaves(self.acache), tree_leaves(acaches)):
                full[:, row0:row0 + n] = new[:, :n]
        toks = logits[:, 0].argmax(dim=-1).cpu().numpy()
        self.prefill_seconds += time.perf_counter() - t0
        for i, req in enumerate(reqs):
            self._accept_token(req, int(toks[i]))

    # -- the step loop --------------------------------------------------

    def _accept_token(self, req: _Request, tok: int) -> None:
        req.last_token = tok
        req.n_generated += 1
        req.handle._emit(tok)
        if req.n_generated >= req.max_new or tok == self.eos_id:
            req.finished = True

    def _retire_finished(self) -> None:
        for idx in range(len(self._active) - 1, -1, -1):
            req = self._active[idx]
            if not req.finished:
                continue
            last = len(self._active) - 1
            if idx != last:  # swap-remove keeps rows a compact prefix
                self._move_row(last, idx)
                self._active[idx] = self._active[last]
            self._active.pop()
            self.table.close(req.rid)
            req.handle._finish()

    def step(self) -> bool:
        """Admit pending requests and run one decode step for the whole
        active batch. Returns True while any work remains."""
        self._admit()
        self._retire_finished()  # prefill alone may complete a request
        if not self._active:
            return self._has_pending()
        t0 = time.perf_counter()
        n = len(self._active)
        bucket = _bucket(n, self.max_batch)
        rids = []
        for req in self._active:
            # page for the incoming token, before the dense export
            self.table.extend_to(req.rid, self.table.length(req.rid) + 1)
            rids.append(req.rid)
        bt, lengths = self.table.dense(rids, rows=bucket)
        tokens = np.zeros((bucket, 1), np.int32)
        user_idx = np.zeros(bucket, np.int32)
        for i, req in enumerate(self._active):
            tokens[i, 0] = req.next_input()
            user_idx[i] = req.adapter_idx
        def first(tree):  # the per-slot rows' first ``bucket`` slots, as views
            return tree_map(lambda t: t[:, :bucket], tree)

        if self.bank is not None:
            ab = gather_adapters(self.bank, self._tensor(user_idx))
            ac_b = first(self.acache)
        else:
            ab, ac_b = None, None
        pools_b = [e if paged else first(e) for e, paged in zip(self.pools, self._paged)]
        logits, _, _ = paged_pac_decode_step(
            self.backbone, ab, self._tensor(tokens), pools_b, self._tensor(bt),
            self._tensor(lengths), ac_b, cfg=self.cfg, r=self.r, kernel_impl=self.kernel_impl)
        toks = logits[:, 0].argmax(dim=-1).cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        self.decode_tokens += n
        for i, req in enumerate(self._active):
            self.table.append_token(req.rid)
            if req.advance():  # stepwise prefill: a prompt token consumed
                self.stepwise_prompt_tokens += 1
                continue
            self._accept_token(req, int(toks[i]))
        for req in self._active:  # out of cache room → forced completion
            if not req.finished and self.table.length(req.rid) >= self.max_len:
                req.finished = True
        self._retire_finished()
        return bool(self._active) or self._has_pending()

    def drain(self) -> None:
        """Step until every submitted request has completed."""
        while self.step():
            pass

    # -- background serving ---------------------------------------------

    def start(self) -> None:
        """Run the step loop in a daemon thread (idles when empty)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(0.005)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
