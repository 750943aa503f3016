"""The port's cached-epoch input path: ``CachePrefetcher`` against the
JAX reference's contract and output, and ``EdgeSession.epoch_scope``.

* The reference's prefetcher tests (``tests/test_activation_cache.py``,
  ``tests/test_cached_step.py``) run against the port's cache: order,
  disk reads, the bounded queue, missing keys, deterministic close,
  close-then-iterate, the storage-form handoff; with a CPU target the
  parts stay CPU tensors.
* Both packages' prefetchers over caches filled with the same entries
  (f32, bf16, int8; some spilled) yield the same bytes.
* The card path's stacking into preallocated buffers equals
  ``get_batch``.
* A session's epochs through ``EpochRunner`` (which arms the
  prefetcher) give the losses of ``step`` called with no epoch scope,
  bit for bit; an exception mid-epoch, or ``close()``, leaves no worker.

Every wait is bounded: consumers run in daemon threads joined with a
timeout, so a wedged worker fails a test instead of hanging the suite.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import activation_cache as jac
from repro_torch.core import activation_cache as tac
from repro_torch.core import steps
from repro_torch.core.activation_cache import ActivationCache, CachePrefetcher
from repro_torch.core.quantization import QTensor
from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunHooks, RunSpec

WORKER = "activation-cache-prefetch"
WAIT_S = 60


def _bounded(fn, timeout=WAIT_S):
    """``fn()`` on a daemon thread, joined with a timeout; its result, or
    its exception raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still waiting after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _joined(pf):
    pf._thread.join(WAIT_S)
    return not pf._thread.is_alive()


def _workers():
    return [t for t in threading.enumerate() if t.name == WORKER and t.is_alive()]


def _entry_f(seed, S=8, d=256, n_p=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(S, d).astype(np.float32), rng.randn(n_p, S, d).astype(np.float32),
            rng.randn(S, d).astype(np.float32))


def _filled_cache(n=8, spill_dir=None, budget=1 << 24, compress="f32", d=32):
    cache = ActivationCache(budget_bytes=budget, spill_dir=spill_dir, compress=compress)
    for k in range(n):
        cache.put(k, *(torch.from_numpy(x) for x in _entry_f(k, d=d)))
    return cache


def _leaves(batch):
    return [t for part in batch for t in ((part.q, part.scale) if isinstance(part, QTensor)
                                          else (part,))]


def _assert_batches_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is None:
            continue
        for a, b in zip(_leaves(w), _leaves(g), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's prefetcher tests, against the port's cache
# ---------------------------------------------------------------------------


def test_prefetcher_matches_sync_reads(tmp_path):
    """The prefetcher yields exactly what synchronous get_batch returns,
    in batch order — including entries that must come off disk."""
    one = sum(a.nbytes for a in _entry_f(0, d=32))
    cache = _filled_cache(8, spill_dir=str(tmp_path), budget=3 * one)
    assert cache._disk  # some entries live on disk only
    order = [np.array([0, 5]), np.array([2, 7]), np.array([4, 1]), np.array([6, 3])]
    want = [cache.get_batch(keys, with_final=True) for keys in order]
    got = _bounded(lambda: list(CachePrefetcher(cache, order, to_device=False)))
    _assert_batches_equal(want, got)


@pytest.mark.parametrize("compressed", [False, True])
def test_prefetcher_cpu_target_yields_cpu_tensors(compressed):
    """With a CPU target (``to_device`` names the CPU) the parts stay CPU
    tensors of the policy's dtypes: f32 decompressed, or int8 QTensors
    with f32 scales in storage form."""
    cache = _filled_cache(4, compress="int8")
    order = [np.array([0, 1]), np.array([2, 3])]
    got = _bounded(lambda: list(CachePrefetcher(cache, order, to_device="cpu", dtype=None,
                                                compressed=compressed)))
    assert len(got) == 2
    for batch in got:
        assert len(batch) == 3
        for part in batch:
            if compressed:
                assert isinstance(part, QTensor)
                assert part.q.dtype == torch.int8 and part.scale.dtype == torch.float32
            else:
                assert isinstance(part, torch.Tensor) and part.dtype == torch.float32
            assert all(t.device.type == "cpu" for t in _leaves([part]))
        assert batch[1].shape == (2, 2, 8, 32)  # taps (n_p, B, S, d)


def test_prefetcher_to_the_card_without_one_refuses(monkeypatch):
    """``to_device=True`` means the card: with none it raises rather than
    quietly leaving the batches on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CachePrefetcher(_filled_cache(2), [np.array([0, 1])])


def test_prefetcher_bounded_queue_blocks_ahead():
    """depth=1 must not race through the whole epoch before consumption —
    the worker blocks on the bounded queue (double-buffering, not
    load-everything)."""
    cache = _filled_cache(8)
    order = [np.array([k]) for k in range(8)]
    pf = CachePrefetcher(cache, order, to_device=False, depth=1)
    deadline = time.time() + 5
    while pf._q.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)  # give the worker a chance to (wrongly) run ahead
    # at most depth items buffered + one blocked in-flight inside put()
    assert pf._q.qsize() <= 2
    assert len(_bounded(lambda: list(pf))) == 8  # and draining still yields everything


def test_prefetcher_yields_none_on_missing_key():
    cache = _filled_cache(2)
    order = [np.array([0]), np.array([99]), np.array([1])]
    got = _bounded(lambda: list(CachePrefetcher(cache, order, to_device=False)))
    assert got[1] is None
    assert got[0] is not None and got[2] is not None


def test_prefetcher_worker_error_surfaces_at_next():
    """A failure on the worker's thread is raised at the consumer's
    ``next()``, not swallowed into a short epoch."""
    cache = _filled_cache(2)

    def broken(*a, **k):
        raise OSError("spill shard unreadable")

    cache.get_batch = broken
    pf = CachePrefetcher(cache, [np.array([0]), np.array([1])], to_device=False)
    with pytest.raises(OSError, match="spill shard unreadable"):
        _bounded(lambda: next(pf))
    assert _joined(pf)
    _bounded(pf.close)


def test_prefetcher_context_manager_joins_worker_on_early_exit():
    """Abandoning an epoch mid-stream (exception, early break) must not
    leak the worker: `with` closes the prefetcher — stop flag, queue
    drain (so a blocked put() unblocks), thread join."""
    cache = _filled_cache(8)
    order = [np.array([k]) for k in range(8)]

    opened = []

    def epoch():
        with CachePrefetcher(cache, order, to_device=False, depth=1) as pf:
            opened.append(pf)
            assert next(pf) is not None  # consume one of eight
            raise RuntimeError("train step blew up")

    with pytest.raises(RuntimeError, match="blew up"):
        _bounded(epoch)
    assert not opened[0]._thread.is_alive()
    assert opened[0]._q.qsize() == 0


def test_prefetcher_close_is_idempotent_and_safe_after_drain():
    cache = _filled_cache(4)
    order = [np.array([k]) for k in range(4)]

    def drained():
        with CachePrefetcher(cache, order, to_device=False) as pf:
            assert len(list(pf)) == 4  # fully drained: sentinel consumed
        return pf

    pf = _bounded(drained)
    assert _joined(pf)
    _bounded(pf.close)  # second close is a no-op
    # plain (non-`with`) use still works and can be closed manually
    pf2 = CachePrefetcher(cache, order, to_device=False)
    assert len(_bounded(lambda: list(pf2))) == 4
    _bounded(pf2.close)
    assert _joined(pf2)


def test_prefetcher_next_after_close_raises():
    """A stale iterator after close() must fail loudly — a next() on the
    drained queue would otherwise block forever (elastic resharding
    closes mid-epoch)."""
    cache = _filled_cache(4)
    order = [np.array([k]) for k in range(4)]
    pf = CachePrefetcher(cache, order, to_device=False)
    assert _bounded(lambda: next(pf)) is not None
    _bounded(pf.close)
    with pytest.raises(RuntimeError, match="after close"):
        next(pf)


def test_prefetcher_reshard_close_reopen_mid_epoch():
    """The elastic-reshard lifecycle: consume part of an epoch, close,
    re-open a fresh prefetcher over the remaining order. No deadlock, no
    leaked worker thread, and the stitched stream equals direct reads."""
    cache = _filled_cache(8)
    order = [np.array([k, k + 1]) for k in range(0, 8, 2)]
    base = len(_workers())

    pf = CachePrefetcher(cache, order, to_device=False, depth=1)
    got = _bounded(lambda: [next(pf), next(pf)])
    _bounded(pf.close)                           # reshard point, mid-epoch
    assert _joined(pf) and len(_workers()) == base  # worker joined, not leaked

    pf2 = CachePrefetcher(cache, order[2:], to_device=False, depth=1)
    got.extend(_bounded(lambda: list(pf2)))
    assert _joined(pf2) and len(_workers()) == base

    want = [cache.get_batch(keys, with_final=True) for keys in order]
    _assert_batches_equal(want, got)


KW = dict(reduced=True, steps_per_epoch=2, batch=2, seq=16, quant=8, cache_compress="int8")


def test_prefetcher_compressed_handoff():
    """The prefetcher's compressed mode yields storage-form batches in
    epoch order — int8 payloads stay int8 all the way to the step, which
    consumes the prefetched batch directly."""
    s = EdgeSession(RunSpec(**KW, epochs=1, kernels="cuda"), device="cpu").open()
    batch = next(iter(s.pipe.epoch(0)))
    s.step(batch)  # a miss: the epoch-1 step fills the cache
    pf = CachePrefetcher(s.cache, [batch["seq_ids"]], to_device=s.device, dtype=None,
                         compressed=True)
    got = _bounded(lambda: next(pf))
    _bounded(pf.close)
    assert got is not None
    cb0, ct, cbf = got
    assert isinstance(ct, QTensor) and ct.q.dtype == torch.int8
    assert ct.q.shape[:2] == (s.cfg.n_periods, KW["batch"])
    cached = {"b0": cb0, "taps": ct, "b_final": cbf,
              "labels": torch.from_numpy(batch["labels"])}
    loss, _, _ = steps.pac_cached_train_step(s.backbone, s.adapter, s.opt, cached, cfg=s.cfg,
                                             r=s.spec.r, lr=s.spec.lr, kernel_impl="cuda")
    assert np.isfinite(float(loss))
    s.close()


# ---------------------------------------------------------------------------
# the same bytes as the reference's prefetcher
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).view(np.uint8)


def _ref_leaves(batch):
    return [t for part in batch for t in ((part["q"], part["scale"]) if isinstance(part, dict)
                                          else (part,))]


@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_prefetcher_matches_the_reference_prefetcher(policy, tmp_path):
    """Caches of both packages filled with the same seeded entries (the
    budget spills some to disk) give, through each package's prefetcher
    with ``compressed=True``, bit-equal payloads and scales, and None at
    the same places (a missing key)."""
    entries = [_entry_f(k, d=300) for k in range(8)]  # d not a multiple of 128
    budget = 3 * sum(a.nbytes for a in entries[0]) // {"f32": 1, "bf16": 2, "int8": 4}[policy]
    j = jac.ActivationCache(budget_bytes=budget, spill_dir=str(tmp_path / "jax"),
                            compress=policy)
    t = tac.ActivationCache(budget_bytes=budget, spill_dir=str(tmp_path / "torch"),
                            compress=policy)
    for k, e in enumerate(entries):
        j.put(k, *e)
        t.put(k, *(torch.from_numpy(x) for x in e))
    assert j._disk and sorted(t._disk) == sorted(j._disk)
    order = [np.array([0, 5]), np.array([2, 99]), np.array([4, 1, 7]), np.array([6, 3])]
    want = _bounded(lambda: list(jac.CachePrefetcher(j, order, to_device=False, dtype=None,
                                                     compressed=True)))
    got = _bounded(lambda: list(tac.CachePrefetcher(t, order, to_device=False, dtype=None,
                                                    compressed=True)))
    assert [w is None for w in want] == [g is None for g in got] == [False, True, False, False]
    for w, g in zip(want, got):
        if w is None:
            continue
        wl, gl = _ref_leaves(w), _leaves(g)
        assert len(wl) == len(gl) == (6 if policy == "int8" else 3)
        for a, b in zip(wl, gl):
            assert tuple(np.shape(a)) == tuple(b.shape)
            np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("policy", ["f32", "bf16", "int8"])
def test_stacking_into_buffers_equals_get_batch(policy, compressed):
    """On the card the worker stacks each part into a ring slot's
    buffers (pinned there, plain here): the same bytes, shapes and
    dtypes as ``get_batch``, and the buffers themselves are filled."""
    cache = _filled_cache(6, compress=policy, d=300)
    keys = np.array([4, 0, 5])
    kw = dict(with_final=True, dtype=None, compressed=compressed)
    items = [cache.get(int(k), **kw) for k in keys]
    bufs = [torch.empty(shape, dtype=dtype) for shape, dtype in tac._stacked_specs(items)]
    got = tac._stack_into(items, bufs)
    want = cache.get_batch(keys, **kw)
    _assert_batches_equal([want], [got])
    assert [t.data_ptr() for t in _leaves(got)] == [b.data_ptr() for b in bufs]


# ---------------------------------------------------------------------------
# the session's epoch scope
# ---------------------------------------------------------------------------


class _Prefetched(RunHooks):
    """Whether each step took its batch from a live prefetcher."""

    def __init__(self):
        self.seen = []

    def on_step(self, session, event):
        self.seen.append((event.epoch, session._prefetch is not None))


def _runner_losses(spec, hooks=()):
    s = EdgeSession(spec, device="cpu").open()
    events = _bounded(lambda: list(EpochRunner(s, hooks=hooks).events()), timeout=300)
    s.close()
    return s, [e for e in events if not isinstance(e, EpochReport)]


def _sync_losses(spec):
    s = EdgeSession(spec, device="cpu").open()
    losses = []
    for epoch in range(spec.epochs):
        for i, batch in enumerate(s.pipe.epoch(epoch)):
            losses.append(s.step(batch, epoch=epoch, index=i).loss)
            assert s._prefetch is None
    s.close()
    return losses


@pytest.mark.parametrize("compress,kernels", [("int8", "cuda"), ("bf16", "cuda"),
                                              ("f32", "ref")])
def test_epochs_through_the_prefetcher_equal_synchronous_steps(compress, kernels):
    """A 3-epoch ``EpochRunner`` run (epochs 1-2 through the prefetcher)
    gives the per-step losses of ``step`` called with no epoch scope
    (every hit read on the caller's thread), bit for bit."""
    spec = RunSpec(**{**KW, "cache_compress": compress}, epochs=3, kernels=kernels)
    seen = _Prefetched()
    _, events = _runner_losses(spec, [seen])
    assert seen.seen == [(0, False)] * 2 + [(1, True)] * 2 + [(2, True)] * 2
    assert [e.mode for e in events] == ["full"] * 2 + ["cached"] * 4
    assert [e.loss for e in events] == _sync_losses(spec)
    assert not _workers()


def test_exception_mid_cached_epoch_joins_the_worker():
    """A hook that raises in the middle of a cached epoch unwinds the
    epoch scope: no prefetch worker is left, the session holds none."""

    class Boom(RunHooks):
        def on_step(self, session, event):
            if event.epoch == 1:
                raise RuntimeError("hook failed mid-epoch")

    s = EdgeSession(RunSpec(**{**KW, "steps_per_epoch": 4}, epochs=2), device="cpu").open()
    with pytest.raises(RuntimeError, match="mid-epoch"):
        _bounded(lambda: list(EpochRunner(s, hooks=[Boom()]).events()), timeout=300)
    assert s._prefetch is None and not _workers()
    s.close()


def test_close_joins_a_live_prefetcher():
    """``close()`` joins a prefetcher whose epoch scope is still open."""
    s = EdgeSession(RunSpec(**KW, epochs=2), device="cpu").open()
    for i, batch in enumerate(s.pipe.epoch(0)):
        s.step(batch, index=i)
    scope = s.epoch_scope(1)
    assert scope.__enter__() is True
    pf = s._prefetch
    assert pf is not None and pf._thread.is_alive()
    _bounded(s.close)
    assert s._prefetch is None and _joined(pf)
    with pytest.raises(RuntimeError, match="after close"):
        next(pf)


def test_epoch_scope_arms_only_a_covered_epoch():
    """No prefetcher for an epoch the cache does not cover, nor without
    the cache."""
    s = EdgeSession(RunSpec(**KW, epochs=1), device="cpu").open()
    with s.epoch_scope(0) as armed:
        assert armed is False and s._prefetch is None
    s.close()
    s = EdgeSession(RunSpec(**KW, epochs=1, use_cache=False), device="cpu").open()
    for i, batch in enumerate(s.pipe.epoch(0)):
        s.step(batch, index=i)
    with s.epoch_scope(1) as armed:
        assert armed is False
    s.close()


def test_warm_cache_dir_through_the_prefetcher(tmp_path):
    """A warm persistent cache's entries are on disk only: the worker
    reads them there, and the warm run gives the cold run's losses
    (within the reference's cached-step tolerance, 2e-5)."""
    spec = RunSpec(**KW, epochs=2, cache_dir=str(tmp_path / "act"))
    cold = EdgeSession(spec, device="cpu")
    cold_reports = _bounded(cold.run, timeout=300)
    seen = _Prefetched()
    warm = EdgeSession(spec, device="cpu")
    warm_reports = _bounded(lambda: warm.run(hooks=[seen]), timeout=300)
    assert warm.warm and [r.mode for r in warm_reports] == ["cached", "cached"]
    assert seen.seen == [(0, True)] * 2 + [(1, True)] * 2
    np.testing.assert_allclose([r.losses for r in warm_reports][0],
                               [r.losses for r in cold_reports][0], rtol=0, atol=2e-5)
    assert not _workers()
