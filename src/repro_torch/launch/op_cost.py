"""Op-level FLOP and byte pricer (twin of ``repro.launch.hlo_cost``).

The reference parses XLA's optimized per-device HLO and prices it. The
port has no HLO: it runs eager aten ops. So :class:`OpPricer` is a
``TorchDispatchMode`` that runs a callable on ``meta`` tensors (shapes
only: nothing is computed or allocated) and charges each aten op as it
dispatches:

* **products** (mm, bmm, addmm, baddbmm, convolution, SDPA): the FLOPs
  of the formulas ``torch.utils.flop_counter`` registers, the ones
  ``FlopCounterMode`` counts. They also go to ``Cost.product_flops``;
* **other computing ops**: 1 FLOP per output element, the reference's
  per-instruction rule inside fusions (``hlo_cost.py:258-266``);
* **views and metadata ops**: nothing, the twin of ``_SKIP_BYTES``
  (``hlo_cost.py:152``);
* **bytes**: each op's inputs plus its outputs (an input broadcast by a
  zero stride is counted once), with the reference's two fidelity rules.
  An indexing gather (embedding lookup, ``index_select``, advanced
  indexing, ``gather``) is charged 2x its result, not the table
  (``hlo_cost.py:301``). An in-place write into part of a larger buffer
  (a KV append through ``index_put_``, a scatter) is charged 2x the
  update, not the buffer (the dynamic-update-slice rule,
  ``hlo_cost.py:271-285``); a ``copy_`` into a slice is charged the
  slice it writes and the source it reads, which is the same 2x.

**Kernel units.** The program priced is the ``cuda`` OpSet's, the one the
card runs. On meta tensors each kernel wrapper takes its plain version
through ``kernels._build.run_plain``, which hands the call to
:meth:`OpPricer.kernel_unit`. The call is one unit: it is charged the
product FLOPs counted inside it (2·M·K·N for ``quant_matmul``, not the
dequantization's elementwise work) and the bytes the kernel moves at its
boundary, its arguments and results as passed (int8 codes and scales,
activations in and out), never the plain version's dequantized
intermediates. Paged attention reads only the pages its block tables
name, so its pools are charged ``block_tables.numel()`` pages: every
slot of the tables, since the lengths that cut a row short live on the
device. Flash attention's unit counts the plain version's products, the
whole (Sq, Sk) square, where the kernel skips the tiles outside the
causal band. A unit's backward (``mix_dw``, ``ce_bwd``) is a unit of its
own, called from its autograd Function's backward.

**No trip counts.** The reference multiplies a ``while`` body's cost by
its trip count, because XLA's ``cost_analysis`` counts a scan body once.
Eager code runs every iteration of its Python loops (periods, chunks,
time steps), so each is charged as it runs, and there is nothing to
multiply.

**Collectives** are not aten ops here. :mod:`repro_torch.launch.dryrun`
adds the bytes of the port's own mesh protocol to ``Cost.collectives``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core.quantization import QTensor

COLLECTIVES = ("all-reduce", "p2p")  # the kinds the port's mesh moves


@dataclass
class Cost:
    """FLOPs, bytes moved and collective bytes by kind, of one priced run."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    collective_count: int = 0
    product_flops: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        c = {k: self.collectives.get(k, 0) + o.collectives.get(k, 0)
             for k in set(self.collectives) | set(o.collectives)}
        return Cost(self.flops + o.flops, self.bytes + o.bytes, c,
                    self.collective_count + o.collective_count,
                    self.product_flops + o.product_flops)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k,
                    {n: v * k for n, v in self.collectives.items()},
                    int(self.collective_count * k), self.product_flops * k)

    @property
    def collective_bytes(self) -> float:
        """Ring-weighted total (all-reduce x2)."""
        return sum(v * (2.0 if k == "all-reduce" else 1.0) for k, v in self.collectives.items())


# aten ops by their overload packet's name
_FREE = {
    "detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "_reshape_alias", "view", "as_strided", "set_",
    "resize_", "split", "split_with_sizes", "unbind", "chunk", "unsafe_split",
    "tensor_split", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "record_stream",
}
_GATHERS = {"index", "index_select", "embedding", "gather", "take"}
#: in-place writes into part of a buffer: the argument that holds the update
_UPDATE_ARG = {
    "index_put_": 2, "index_put": 2, "_index_put_impl_": 2, "index_copy_": 3, "index_copy": 3,
    "scatter_": 3, "scatter": 3, "scatter_add_": 3, "scatter_add": 3, "slice_scatter": 1,
    "select_scatter": 1,
}
#: ops that write their output without reading a tensor
_WRITE_ONLY = {
    "zero_", "fill_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a zero-stride (broadcast)
    axis counts once."""
    if t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def tree_tensors(x):
    """The tensors of an argument tree: tensors, QTensors' codes and
    scales, lists, tuples and dicts of those."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, QTensor):
        yield x.q
        yield x.scale
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tree_tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from tree_tensors(y)


def _gathered_bytes(pool: torch.Tensor, pages: int) -> int:
    """``pages`` pages of a (n_pages, ...) pool, read once."""
    return pages * tensor_bytes(pool[0]) if pool.shape[0] else 0


def unit_bytes(name: str, args: tuple, kwargs: dict, out) -> int:
    """The bytes kernel ``name`` moves at its boundary: its arguments read
    once and its results written once; paged attention's pools only at
    the pages its block tables name."""
    if name == "paged_attention":
        q, k_pages, v_pages, block_tables, lengths = args
        pages = block_tables.numel()
        pools = [k_pages, v_pages] + [kwargs[k] for k in ("k_scale", "v_scale")
                                      if kwargs.get(k) is not None]
        small = [q, block_tables, lengths, out]
        return (sum(_gathered_bytes(p, pages) for p in pools)
                + sum(tensor_bytes(t) for t in small))
    return sum(tensor_bytes(t) for t in tree_tensors((args, kwargs, out)))


def _functional(func) -> bool:
    """An op that neither mutates nor aliases its arguments: its output
    depends on the arguments' shapes alone (on meta), so it may be
    memoized."""
    schema = func._schema
    return not schema.is_mutable and not any(r.alias_info for r in schema.returns)


def _arg_key(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_arg_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _arg_key(v)) for k, v in x.items())
    return x


def _key(func, args, kwargs):
    """A hashable key of the op and its arguments' metadata, or None."""
    key = (func, _arg_key(args), _arg_key(kwargs))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _spec(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), [_spec(o) for o in out])
    return ("V", out)


def _build(spec):
    """A fresh meta output of ``spec`` (from :func:`_spec`)."""
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device="meta")
    if spec[0] == "V":
        return spec[1]
    return spec[0](_build(s) for s in spec[1])


class OpPricer(TorchDispatchMode):
    """Charges every aten op run under it (see the module docstring).
    ``cost`` is the total; ``units`` the kernel units' share by kernel
    name and ``unit_calls`` their calls. Run the priced callable on meta
    tensors: the pricer computes nothing itself."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.units: Dict[str, Cost] = {}
        self.unit_calls: Dict[str, int] = {}
        self._unit = None  # the Cost of the kernel unit being run, if any
        self._kinds: Dict[object, str] = {}
        self._memo: Dict[tuple, tuple] = {}  # op and argument shapes -> (output spec, charge)

    def _kind(self, func) -> str:
        kind = self._kinds.get(func)
        if kind is None:
            packet = func._overloadpacket
            name = packet.__name__
            if name in _FREE or func.is_view:
                kind = "free"
            elif packet in flop_registry:
                kind = "product"
            elif name in _GATHERS:
                kind = "gather"
            elif name in _UPDATE_ARG:
                kind = "update"
            elif name == "copy_":
                kind = "copy"
            elif name in _WRITE_ONLY:
                kind = "write"
            else:
                kind = "compute"
            self._kinds[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kind(func)
        if kind == "free":
            return func(*args, **kwargs)
        key = _key(func, args, kwargs) if kind != "update" and _functional(func) else None
        hit = self._memo.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            charge = self._charge(func, kind, args, kwargs, out)
            if key is not None:
                self._memo[key] = (_spec(out), charge)
        else:  # the same op on the same shapes: its output rebuilt, its charge reused
            out, charge = _build(hit[0]), hit[1]
        flops, product, nbytes = charge
        if self._unit is not None:  # inside a kernel unit: its products only
            self._unit.flops += product
            self._unit.product_flops += product
            return out
        self.cost.flops += flops
        self.cost.product_flops += product
        self.cost.bytes += nbytes
        return out

    @staticmethod
    def _charge(func, kind, args, kwargs, out) -> tuple:
        """(FLOPs, product FLOPs, bytes) of one op by the rules of the
        module docstring."""
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        if kind == "product":
            flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            return flops, flops, float(sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs)))
        if kind == "gather":
            return 0.0, 0.0, 2.0 * sum(map(tensor_bytes, outs))
        if kind == "update":
            upd = args[_UPDATE_ARG[func._overloadpacket.__name__]]
            if isinstance(upd, torch.Tensor):
                n, nbytes = upd.numel(), tensor_bytes(upd)
            else:  # a scalar value: the index's extent of the buffer's dtype
                n = args[2].numel()
                nbytes = n * args[0].element_size()
            return float(n), 0.0, 2.0 * nbytes
        ins = [t for t in _leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if kind == "copy":  # reads the source, writes the destination
            ins = ins[1:]
        elif kind == "write":
            ins = []
        return (float(sum(t.numel() for t in outs)), 0.0,
                float(sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))))

    def kernel_unit(self, name: str, fn: Callable, args: tuple, kwargs: dict):
        """Run ``fn``, the plain version of kernel ``name``, as one unit:
        its products' FLOPs and the kernel's boundary bytes
        (:func:`unit_bytes`). A unit inside a unit is part of it."""
        if self._unit is not None:
            return fn(*args, **kwargs)
        unit = self._unit = Cost()
        try:
            out = fn(*args, **kwargs)
        finally:
            self._unit = None
        unit.bytes = float(unit_bytes(name, args, kwargs, out))
        self.cost = self.cost + unit
        self.units[name] = self.units.get(name, Cost()) + unit
        self.unit_calls[name] = self.unit_calls.get(name, 0) + 1
        return out


def price(fn: Callable, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`Cost`, the pricer): run on
    meta tensors under an :class:`OpPricer`."""
    with OpPricer() as pricer:
        out = fn(*args, **kwargs)
    return out, pricer.cost, pricer
