"""Activation cache for Parallel Adapters (paper §IV-B, §V-B).

Counterpart of ``repro.core.activation_cache``. The backbone is frozen,
so the taps ``b_0..b_L`` and the final hidden state ``b_final`` of a
sequence never change: epoch 1 captures them, and from epoch 2 on the
adapter trains straight from the cache with no backbone forward.

* **Compressed entries** — the ``compress`` policy (``"f32"``,
  ``"bf16"``, ``"int8"``) applies at put time; ``int8`` is the block
  absmax scheme of the backbone weights (~3.9× smaller than f32 with
  its scales). The byte budget and every eviction and spill count
  compressed bytes.
* **Storage-form handoff** — ``get``/``get_batch`` with
  ``compressed=True`` hand each part over in its storage form (int8 as
  a :class:`~repro_torch.core.quantization.QTensor`, bf16 as bf16), so
  the host→device copy and the kernels read it at storage width.
* **Spill** — entries evicted from RAM go to ``act_<key>.npz`` shards in
  ``spill_dir``, in the reference's format (bf16 as uint16, one JSON
  ``meta`` record), so either package reads the other's shards.

* **Persistence** — :meth:`ActivationCache.save_manifest` flushes every
  entry to ``spill_dir`` and writes ``manifest.json`` (the reference's
  JSON format); :func:`open_persistent` reopens such a directory warm
  when the manifest's identity record (:func:`manifest_for`: backbone
  and corpus fingerprints, shapes, policy) matches, and otherwise
  invalidates it loudly and removes the stale entries. The port's
  fingerprints never equal the reference's, so a directory the other
  package wrote is re-captured, never misread.

* **Prefetch** — :class:`CachePrefetcher` reads a cached epoch's
  batches (``DataPipeline.epoch_order``) on a daemon thread, so batch
  *k+1* is read (off disk too), stacked and on its way to the card
  while step *k* runs. On the card its worker stacks each part into a
  ring of pinned host buffers and copies it with ``non_blocking`` on a
  side stream; the consumer's stream waits on the copy's event.

Host storage is torch CPU tensors. Entries taken from the card are
compressed there and copied to the host at storage width, into
reusable pinned buffers on a side stream (:class:`_PinnedStaging`); the
cache fill still ends inside the step.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.quantization import QTensor, dequantize, quantize, stack

COMPRESS_POLICIES = ("f32", "bf16", "int8")
_INT8_BLOCK = 128
MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 2
#: the batch axis of each part as a batch stacks it: b0 (B,S,d),
#: taps (n_p,B,S,d), b_final (B,S,d)
_STACK_DIMS = (0, 1, 0)


def cache_bytes_per_sequence(cfg, seq_len: int, dtype_bytes: float = 4,
                             with_final: bool = False) -> int:
    """Paper §V-B storage analysis: s·h·(l+1) values per sequence, or
    s·h·(l+2) ``with_final`` (the ``b_final`` plane entries fold in);
    pass :func:`policy_bytes_per_value` as ``dtype_bytes`` for
    compressed entries."""
    planes = cfg.n_periods + (2 if with_final else 1)
    return int(planes * seq_len * cfg.d_model * dtype_bytes)


def policy_bytes_per_value(policy: str, block: int = _INT8_BLOCK) -> float:
    """Stored bytes per cached value (int8 includes its f32 scale
    amortised over the block)."""
    return {"f32": 4.0, "bf16": 2.0, "int8": 1.0 + 4.0 / block}[policy]


# ---------------------------------------------------------------------------
# Compressed tensors / cache entries
# ---------------------------------------------------------------------------


@dataclass
class _CTensor:
    """One compressed host tensor and what it takes to invert it.

    f32: data float32, scale None; bf16: data bfloat16; int8: data the
    int8 payload, scale the f32 per-block absmax/127 (exactly
    ``quantize(bits=8, block=_INT8_BLOCK)``)."""

    policy: str
    data: torch.Tensor
    scale: Optional[torch.Tensor]
    orig_last: int
    block: int = 0

    @property
    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        return n + (0 if self.scale is None else self.scale.numel() * 4)


def _compress(x, policy: str, orig_last: Optional[int] = None) -> _CTensor:
    """``x`` may already BE storage form: an int8 :class:`QTensor` as the
    ``cuda`` OpSet emits it at the tap site. It is adopted as it is (no
    recompression, no f32 round trip), provided the policy is int8;
    ``orig_last`` names the unpadded feature width. The result stays on
    ``x``'s device: :meth:`ActivationCache._host` moves it."""
    if isinstance(x, QTensor):
        if policy != "int8":
            raise ValueError(f"a storage-form (int8) tap requires the int8 policy, got {policy!r}")
        last = x.q.shape[-1] if orig_last is None else orig_last
        return _CTensor("int8", x.q.detach(), x.scale.detach(), last, x.block)
    x = torch.as_tensor(x)
    if policy in ("f32", "bf16"):
        dtype = torch.float32 if policy == "f32" else torch.bfloat16
        return _CTensor(policy, x.detach().to(dtype), None, x.shape[-1])
    if policy == "int8":
        qt = quantize(x.detach().float(), bits=8, block=_INT8_BLOCK)
        return _CTensor("int8", qt.q, qt.scale, qt.orig_last, qt.block)
    raise ValueError(f"compress must be one of {COMPRESS_POLICIES}, got {policy!r}")


class _PinnedStaging:
    """The epoch-1 cache fill's device→host copies: each tensor lands in
    a pinned host buffer kept for the next call (one per position in the
    call, replaced when its shape changes), copied with ``non_blocking``
    on a side stream that first waits for the producer's stream.
    :meth:`host` returns once the copies' event has completed; the next
    call overwrites the buffers, so the caller copies out what it keeps."""

    def __init__(self):
        self._bufs: Dict[int, torch.Tensor] = {}
        self._side: Optional[torch.cuda.Stream] = None

    def host(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (all from one step, so on one device) on the host,
        contiguous; host tensors stay where they are."""
        dev = tensors[0].device
        if dev.type != "cuda":
            return [t.contiguous() for t in tensors]
        if self._side is None or self._side.device != dev:
            self._side = torch.cuda.Stream(device=dev)
        self._side.wait_stream(torch.cuda.current_stream(dev))
        out = []
        with torch.cuda.stream(self._side):
            for i, t in enumerate(tensors):
                buf = self._bufs.get(i)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = self._bufs[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                out.append(buf)
            copied = torch.cuda.Event()
            copied.record(self._side)
        copied.synchronize()
        return out


def _ct_index(ct: _CTensor, idx) -> _CTensor:
    """One sequence out of a batch-compressed tensor, with its own bytes
    (compression runs along the last axis, so slicing leading axes is
    exact)."""
    return _CTensor(ct.policy, ct.data[idx].clone(),
                    None if ct.scale is None else ct.scale[idx].clone(), ct.orig_last, ct.block)


def _decompress(ct: _CTensor, dtype=torch.float32) -> torch.Tensor:
    """``dtype=None`` keeps a float payload in its storage dtype (bf16
    entries go to the device compressed; the step upcasts). int8 entries
    dequantize here; read with ``compressed=True`` to keep them int8."""
    if ct.policy in ("f32", "bf16"):
        return ct.data if dtype is None else ct.data.to(dtype)
    out = dequantize(QTensor(ct.data, ct.scale, 8, ct.block, ct.orig_last))
    return out if dtype is None else out.to(dtype)


def _raw_part(ct: _CTensor):
    """Storage form for the step: the payload, or a QTensor for int8."""
    if ct.policy == "int8":
        return QTensor(ct.data, ct.scale, 8, ct.block, ct.orig_last)
    return ct.data


@dataclass
class CacheEntry:
    """One sequence's cached activations: (b0, taps[, b_final])."""

    b0: _CTensor
    taps: _CTensor
    b_final: Optional[_CTensor] = None

    @property
    def nbytes(self) -> int:
        n = self.b0.nbytes + self.taps.nbytes
        return n + (0 if self.b_final is None else self.b_final.nbytes)

    def parts(self) -> Iterable[Tuple[str, _CTensor]]:
        yield "b0", self.b0
        yield "taps", self.taps
        if self.b_final is not None:
            yield "bf", self.b_final


def _entry_to_npz(entry: CacheEntry) -> Dict[str, np.ndarray]:
    meta = {}
    arrays: Dict[str, np.ndarray] = {}
    for name, ct in entry.parts():
        meta[name] = {"policy": ct.policy, "orig_last": ct.orig_last, "block": ct.block}
        data = ct.data.view(torch.uint16) if ct.policy == "bf16" else ct.data
        arrays[name] = data.numpy()
        if ct.scale is not None:
            arrays[name + "_scale"] = ct.scale.numpy()
    arrays["meta"] = np.array(json.dumps(meta))
    return arrays


def _entry_from_npz(z) -> CacheEntry:
    meta = json.loads(str(z["meta"]))

    def part(name: str) -> _CTensor:
        m = meta[name]
        data = torch.from_numpy(np.array(z[name]))
        if m["policy"] == "bf16":
            data = data.view(torch.bfloat16)
        scale = torch.from_numpy(np.array(z[name + "_scale"])) if name + "_scale" in z.files else None
        return _CTensor(m["policy"], data, scale, m["orig_last"], m["block"])

    return CacheEntry(part("b0"), part("taps"), part("bf") if "bf" in meta else None)


# ---------------------------------------------------------------------------
# The cache manager
# ---------------------------------------------------------------------------


@dataclass
class ActivationCache:
    """Keyed store of backbone taps.

    Keys are sequence ids. Values are (b0, taps[, b_final]) of shapes
    (S, d), (n_periods, S, d) and (S, d), stored per sequence so epochs
    can re-batch freely. Entries are compressed per ``compress`` at put
    time and the byte budget counts compressed bytes. Mutating paths
    hold a lock, so a reader thread may share the cache."""

    budget_bytes: int = 2 << 30
    spill_dir: Optional[str] = None
    compress: str = "f32"
    _ram: Dict[int, CacheEntry] = field(default_factory=dict)
    _disk: Dict[int, str] = field(default_factory=dict)
    _final_absent: Set[int] = field(default_factory=set)
    _ram_bytes: int = 0
    hits: int = 0
    misses: int = 0
    _lock: threading.RLock = field(default_factory=threading.RLock, repr=False)
    _staging: _PinnedStaging = field(default_factory=_PinnedStaging, repr=False, compare=False)

    def __post_init__(self):
        if self.compress not in COMPRESS_POLICIES:
            raise ValueError(f"compress must be one of {COMPRESS_POLICIES}, got {self.compress!r}")

    def __contains__(self, key: int) -> bool:
        return key in self._ram or key in self._disk

    def __len__(self) -> int:
        # a promoted entry keeps its (clean) disk copy: count keys once
        return len(self._ram.keys() | self._disk.keys())

    @property
    def nbytes(self) -> int:
        return self._ram_bytes

    def covers(self, keys, with_final: bool = False) -> bool:
        """True when every key is resident (RAM or disk)."""
        with self._lock:
            return all(int(k) in self and not (with_final and int(k) in self._final_absent)
                       for k in keys)

    # -- writes ------------------------------------------------------------

    def put(self, key: int, b0, taps, b_final=None) -> None:
        # _ct_index(..., ...) copies: an entry must own its bytes, not view
        # the caller's array or a staging buffer (the budget would then not
        # bound real memory)
        parts = self._host([None if x is None else _compress(x, self.compress)
                            for x in (b0, taps, b_final)])
        entry = CacheEntry(*(None if ct is None else _ct_index(ct, ...) for ct in parts))
        with self._lock:
            self._put_entry(int(key), entry)

    def _host(self, parts: List[Optional[_CTensor]]) -> List[Optional[_CTensor]]:
        """Compressed parts with their payloads and scales on the host:
        from the card through the pinned staging buffers, which the next
        fill overwrites (callers slice entries out with copies)."""
        leaves = [t for ct in parts if ct is not None
                  for t in (ct.data, ct.scale) if t is not None]
        host = iter(self._staging.host(leaves))
        return [None if ct is None else
                _CTensor(ct.policy, next(host), None if ct.scale is None else next(host),
                         ct.orig_last, ct.block)
                for ct in parts]

    def _put_entry(self, key: int, entry: CacheEntry) -> None:
        size = entry.nbytes
        if entry.b_final is None:
            self._final_absent.add(key)
        else:
            self._final_absent.discard(key)
        # re-putting a key replaces it: retire the old bytes first, or the
        # budget check double-counts
        if key in self._ram:
            self._ram_bytes -= self._ram.pop(key).nbytes
        if size > self.budget_bytes:
            # alone larger than the whole budget: disk is its home (or it
            # is dropped) rather than flushing the hot working set
            if self.spill_dir:
                self._spill(key, entry)
            return
        # LRU: the oldest RAM entries move to disk, the new one stays
        self._evict_until(self.budget_bytes - size)
        if key in self._disk:  # new data for the key: the spill is stale
            path = self._disk.pop(key)
            try:
                os.remove(path)
            except OSError:
                pass
        self._ram[key] = entry
        self._ram_bytes += size

    def _evict_until(self, target_bytes: int) -> None:
        """Evict the oldest RAM entries until ``_ram_bytes <= target``: one
        with a clean disk copy is dropped for free, others are spilled (or
        dropped without a spill_dir)."""
        while self._ram and self._ram_bytes > target_bytes:
            k, entry = next(iter(self._ram.items()))
            self._ram_bytes -= entry.nbytes
            del self._ram[k]
            if self.spill_dir and k not in self._disk:
                self._spill(k, entry)

    def _spill(self, key: int, entry: CacheEntry) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"act_{key}.npz")
        np.savez(path, **_entry_to_npz(entry))
        self._disk[key] = path

    def flush(self) -> None:
        """Write every RAM entry without a clean disk copy to spill_dir —
        the persistence barrier before :meth:`save_manifest`."""
        if not self.spill_dir:
            raise ValueError("flush() requires a spill_dir")
        with self._lock:
            for k, entry in self._ram.items():
                if k not in self._disk:
                    self._spill(k, entry)

    # -- reads -------------------------------------------------------------

    def _get_entry(self, key: int, need_final: bool) -> Optional[CacheEntry]:
        with self._lock:
            if need_final and key in self._final_absent:
                self.misses += 1
                return None
            if key in self._ram:
                self.hits += 1
                entry = self._ram.pop(key)  # refresh recency
                self._ram[key] = entry
                return entry
            if key in self._disk:
                self.hits += 1
                with np.load(self._disk[key]) as z:
                    entry = _entry_from_npz(z)
                # promote into RAM, keeping the npz as a clean copy, so a
                # later eviction of it costs no write
                size = entry.nbytes
                if size <= self.budget_bytes:
                    self._evict_until(self.budget_bytes - size)
                    self._ram[key] = entry
                    self._ram_bytes += size
                return entry
            self.misses += 1
            return None

    def get(self, key: int, with_final: bool = False, dtype=torch.float32,
            compressed: bool = False):
        """Decompressed (b0, taps[, b_final]), or None on a miss (also for
        an entry without b_final when it is asked for). ``dtype=None``
        keeps bf16 payloads bf16; ``compressed=True`` returns every part
        in its storage form (int8 as a QTensor)."""
        entry = self._get_entry(int(key), need_final=with_final)
        if entry is None:
            return None
        parts = [entry.b0, entry.taps] + ([entry.b_final] if with_final else [])
        if compressed:
            return tuple(_raw_part(ct) for ct in parts)
        return tuple(_decompress(ct, dtype) for ct in parts)

    def put_batch(self, keys, b0, taps, b_final=None, orig_last: Optional[int] = None) -> None:
        """b0 (B,S,d); taps (n_p,B,S,d); b_final (B,S,d) — tensors from
        epoch 1, on the card or not, or already in storage form (an int8
        QTensor from the ``cuda`` OpSet's tap site, adopted as it is;
        ``orig_last`` = d). Compression runs once on the whole batch and
        per-sequence entries are sliced out (with copies): block-wise
        along the last axis, so the payloads equal per-sequence
        compression bit for bit. Parts on the card reach the host in one
        side-stream copy into pinned buffers (:class:`_PinnedStaging`)."""
        cb0, ctaps, cbf = self._host([None if x is None else _compress(x, self.compress, orig_last)
                                      for x in (b0, taps, b_final)])
        for i, k in enumerate(keys):
            entry = CacheEntry(_ct_index(cb0, i), _ct_index(ctaps, (slice(None), i)),
                               None if cbf is None else _ct_index(cbf, i))
            with self._lock:
                self._put_entry(int(k), entry)

    def get_batch(self, keys, with_final: bool = False, dtype=torch.float32,
                  compressed: bool = False):
        """A training batch from cached sequences: b0 (B,S,d), taps
        (n_p,B,S,d)[, b_final (B,S,d)], or None if any key misses. With
        ``compressed=True`` int8 parts are QTensors of (B,S,·) payloads
        and scales."""
        items = [self.get(int(k), with_final=with_final, dtype=dtype, compressed=compressed)
                 for k in keys]
        if any(it is None for it in items):
            return None
        return tuple(stack(parts, dim) for parts, dim in zip(zip(*items), _STACK_DIMS))

    def clear(self) -> None:
        with self._lock:
            for path in self._disk.values():
                try:
                    os.remove(path)
                except OSError:
                    pass
            self._ram.clear()
            self._disk.clear()
            self._final_absent.clear()
            self._ram_bytes = 0

    # -- cross-run persistence ---------------------------------------------

    def save_manifest(self, meta: dict) -> str:
        """Flush all entries to spill_dir and write the manifest that lets
        a later run resume warm (:func:`open_persistent`). ``meta`` is the
        caller's identity record (:func:`manifest_for`), compared
        verbatim on reopen. Written atomically."""
        self.flush()
        with self._lock:
            entries = {
                str(k): {"file": os.path.basename(self._disk[k]),
                         "has_final": k not in self._final_absent}
                for k in sorted(self._ram.keys() | self._disk.keys())
            }
            manifest = {"version": MANIFEST_VERSION, "compress": self.compress, "meta": meta,
                        "entries": entries}
            path = os.path.join(self.spill_dir, MANIFEST_NAME)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return path


def manifest_for(cfg, *, reduced, seq_len, quant_bits, backbone, corpus_tokens) -> dict:
    """The cache-manifest identity record. Any change to the backbone's
    weights (seed, quantization), the corpus, or the shapes changes a
    field here and invalidates the cache on reopen."""
    from repro_torch.checkpoint import tree_fingerprint

    return {
        "arch": cfg.name,
        "reduced": bool(reduced),
        "seq": int(seq_len),
        "quant": int(quant_bits or 0),
        "backbone": tree_fingerprint(backbone),
        "corpus": tree_fingerprint(corpus_tokens),
    }


def _invalidate(cache_dir: str, reason: str) -> None:
    print(f"ACTIVATION CACHE INVALIDATED at {cache_dir}: {reason} — discarding cached "
          f"entries; epoch 1 will re-run the backbone forward", file=sys.stderr)
    for name in os.listdir(cache_dir):
        if name == MANIFEST_NAME or (name.startswith("act_") and name.endswith(".npz")):
            try:
                os.remove(os.path.join(cache_dir, name))
            except OSError:
                pass


def open_persistent(cache_dir: str, meta: dict, *, budget_bytes: int = 2 << 30,
                    compress: str = "f32") -> Tuple[ActivationCache, bool]:
    """Open (or create) a persistent cache at ``cache_dir``.

    Returns ``(cache, warm)``. ``warm`` is True iff a manifest exists and
    validates against ``meta`` and ``compress`` with every entry file
    present: the cache's disk index is then filled from it, and an epoch
    over its keys runs no backbone forward. Any mismatch invalidates
    loudly (stderr) and removes the stale entries."""
    cache = ActivationCache(budget_bytes=budget_bytes, spill_dir=cache_dir, compress=compress)
    path = os.path.join(cache_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return cache, False
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _invalidate(cache_dir, f"unreadable manifest ({e})")
        return cache, False
    if m.get("version") != MANIFEST_VERSION:
        _invalidate(cache_dir, f"manifest version {m.get('version')} != {MANIFEST_VERSION}")
        return cache, False
    if m.get("compress") != compress:
        _invalidate(cache_dir, f"compression policy changed ({m.get('compress')} -> {compress})")
        return cache, False
    old = m.get("meta", {})
    if old != meta:
        changed = sorted(k for k in set(old) | set(meta) if old.get(k) != meta.get(k))
        _invalidate(cache_dir, f"meta mismatch on {changed}")
        return cache, False
    entries = m.get("entries", {})
    files = {k: os.path.join(cache_dir, v["file"]) for k, v in entries.items()}
    missing = [k for k, p in files.items() if not os.path.exists(p)]
    if missing:
        _invalidate(cache_dir, f"{len(missing)} entry file(s) missing")
        return cache, False
    for k, v in entries.items():
        cache._disk[int(k)] = files[k]
        if not v.get("has_final", False):
            cache._final_absent.add(int(k))
    return cache, True


# ---------------------------------------------------------------------------
# Async prefetch
# ---------------------------------------------------------------------------

def _leaves(part) -> tuple:
    """The tensors of one part: a QTensor's payload and scales, or the part."""
    return (part.q, part.scale) if isinstance(part, QTensor) else (part,)


def _like(part, leaves):
    """``part`` rebuilt over other tensors (see :func:`_leaves`)."""
    if isinstance(part, QTensor):
        return QTensor(leaves[0], leaves[1], part.bits, part.block, part.orig_last)
    return leaves[0]


def _stacked_specs(items) -> list:
    """(shape, dtype) of every stacked leaf of a batch of ``items`` (the
    per-sequence tuples :meth:`ActivationCache.get` returns), in part order."""
    specs = []
    for j, part in enumerate(items[0]):
        for leaf in _leaves(part):
            shape = list(leaf.shape)
            shape.insert(_STACK_DIMS[j], len(items))
            specs.append((tuple(shape), leaf.dtype))
    return specs


def _stack_into(items, bufs) -> tuple:
    """``get_batch``'s stacking of ``items`` written into ``bufs`` (one
    per leaf, shaped as :func:`_stacked_specs` says); the parts over them."""
    bufs = iter(bufs)
    out = []
    for j, part in enumerate(items[0]):
        stacked = []
        for i in range(len(_leaves(part))):
            buf = next(bufs)
            torch.stack([_leaves(it[j])[i] for it in items], _STACK_DIMS[j], out=buf)
            stacked.append(buf)
        out.append(_like(part, stacked))
    return tuple(out)


class CachePrefetcher:
    """Background loader for cached epochs (paper Fig. 11's pure-DP phase).

    Iterates the epoch's known batch order (``DataPipeline.epoch_order``)
    on a daemon thread, so reading (off disk too), stacking and the
    host→device copy of batch *k+1* overlap train step *k*; the bounded
    queue (``depth``, default 2) double-buffers, and the thread blocks
    rather than loading the whole epoch ahead.

    Yields one ``(b0, taps[, b_final])`` tuple per key-batch, in order —
    or ``None`` for a batch with a missing key (the consumer falls back
    to the forward path). With ``compressed=True`` each part comes in its
    storage form (int8 entries as :class:`QTensor`), so the copy to the
    card stays at integer width and the kernels dequantize. While a
    prefetcher is draining, the owning thread must not mutate the cache
    except via ``put`` (both sides take the cache lock).

    ``to_device`` names where the batches go: ``True`` the card (as
    :func:`~repro_torch.core.device.resolve_device` reads ``None``), a
    device that device, ``False`` the host. On the card the worker
    stacks each part into a pinned host buffer from a ring of ``depth +
    2`` slots (allocated once, from the first batch's shapes; a slot is
    restacked only after the copy that last read it is done), copies it
    with ``non_blocking`` on a side stream and queues the device
    tensors with the copy's event; :meth:`__next__` makes the caller's
    stream wait on that event and records the tensors on it, so the
    caching allocator does not hand their memory out while the step
    still reads it. A CPU target leaves the batches on the host, as
    stacked.

    A prefetcher is a context manager: ``with CachePrefetcher(...) as
    pf:`` guarantees deterministic shutdown on exit — including an
    exception mid-epoch — via :meth:`close` (signal the worker to stop,
    drain the queue so a blocked ``put`` unblocks, join the thread). A
    leaked worker would otherwise keep device batches alive through its
    queue until process exit.
    """

    _DONE = object()

    def __init__(self, cache: ActivationCache, key_batches: Sequence[np.ndarray], *,
                 with_final: bool = True, depth: int = 2, to_device=True,
                 dtype=torch.float32, compressed: bool = False):
        self._cache = cache
        self._key_batches = list(key_batches)
        self._with_final = with_final
        self._dtype = dtype
        self._compressed = compressed
        self._device = None if to_device is False else resolve_device(
            None if to_device is True else to_device)
        card = self._device is not None and self._device.type == "cuda"
        self._side = torch.cuda.Stream(device=self._device) if card else None
        self._slots = max(1, depth) + 2
        self._ring = None      # pinned slots, allocated by the worker
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False    # consumer saw the _DONE sentinel
        self._closed = False  # close() ran — iteration must fail fast
        self._thread = threading.Thread(target=self._worker, name="activation-cache-prefetch",
                                        daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            with contextlib.ExitStack() as on_card:
                if self._side is not None:
                    # the current device and stream are per thread
                    on_card.enter_context(torch.cuda.device(self._device))
                    on_card.enter_context(torch.cuda.stream(self._side))
                for keys in self._key_batches:
                    if self._stop.is_set():
                        break
                    self._q.put(self._load(keys))
        except Exception as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def _load(self, keys):
        """(parts or None, the copy's event or None) for one key batch."""
        kw = dict(with_final=self._with_final, dtype=self._dtype, compressed=self._compressed)
        if self._side is None:
            return self._cache.get_batch(keys, **kw), None
        items = [self._cache.get(int(k), **kw) for k in keys]
        if any(it is None for it in items):
            return None, None
        slot = self._slot(_stacked_specs(items))
        host = _stack_into(items, self._ring[slot][0])
        parts = tuple(_like(p, [t.to(self._device, non_blocking=True) for t in _leaves(p)])
                      for p in host)
        copied = torch.cuda.Event()
        copied.record(self._side)
        self._ring[slot][1] = copied
        return parts, copied

    def _slot(self, specs) -> int:
        """The next ring slot, free to restack (the ring allocated anew
        if this batch's shapes differ from the ring's)."""
        if self._ring is None or self._specs != specs:
            self._side.synchronize()
            self._specs = specs
            self._ring = [[[torch.empty(shape, dtype=dtype, pin_memory=True)
                            for shape, dtype in specs], None] for _ in range(self._slots)]
            self._next = 0
        slot, self._next = self._next, (self._next + 1) % self._slots
        copied = self._ring[slot][1]
        if copied is not None:
            copied.synchronize()
        return slot

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            # after close() the queue is drained and the worker is gone —
            # a blocking get() here would hang forever. Elastic resharding
            # closes mid-epoch and re-opens over the remaining order; a
            # stale iterator must fail loudly instead.
            raise RuntimeError(
                "CachePrefetcher iterated after close(); open a new "
                "prefetcher over the remaining key batches")
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        parts, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for part in parts:
                for t in _leaves(part):
                    t.record_stream(stream)
        return parts

    def __enter__(self) -> "CachePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        """Deterministic shutdown: signal the worker to stop, drain the
        queue until its ``_DONE`` sentinel (unblocking a worker stuck on
        a full queue), join the thread, and free the pinned ring once
        the side stream's copies are done. Idempotent; safe mid-epoch
        (early exit / exception) and after normal exhaustion. Unlike
        iteration, a worker error is swallowed here — close() is for
        unwinding, not for results."""
        self._closed = True
        self._stop.set()
        while not self._done:
            try:
                item = self._q.get(timeout=60)
            except queue.Empty:  # worker wedged — join below, best effort
                break
            if item is self._DONE:
                self._done = True
        self._thread.join(timeout=30)
        if self._side is not None and not self._thread.is_alive():
            self._side.synchronize()
            self._ring = None
