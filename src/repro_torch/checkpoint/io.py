"""Checkpointing: parameter trees <-> disk in the reference's msgpack
framing (counterpart of ``repro.checkpoint.io``).

The file format is the reference's, so each package reads the other's
files bit for bit:

* an array leaf is ``{"__array__": True, "dtype": numpy dtype string,
  "shape": [...], "data": bin}``;
* a :class:`~repro_torch.core.quantization.QTensor` is
  ``{"__qtensor__": True, "q", "scale", "bits", "block", "orig_last"}``
  (the reference's ``QTensor`` fields), the quantized backbone thus
  checkpointing at its storage width;
* lists and tuples are ``{"__list__": [...], "__tuple__": bool}``,
  Python scalars and ``None`` are ``{"__scalar__": value}``, dicts stay
  maps.

The card's machine has no ``msgpack`` package, so this module packs and
unpacks the subset of msgpack that framing uses itself (maps, arrays,
str, bin, int, float64, bool, nil), choosing the smallest encoding of
each value as ``msgpack.packb(use_bin_type=True)`` does: the bytes
equal the reference's.

A bfloat16 leaf is refused: numpy has no bfloat16 dtype string (the
reference writes ``|V2`` and then cannot read its own file back), so no
file either package could not read is ever written.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.quantization import QTensor

_SENTINEL_Q = "__qtensor__"
_SENTINEL_A = "__array__"


class CheckpointError(ValueError):
    """A tree this format cannot hold, or a file it cannot read."""


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def _pack_len(n: int, fix: int, fix_max: int, codes, write) -> None:
    """Header of a sized value: ``fix | n`` when ``n < fix_max`` (fix
    None: no fix form), else the first of ``codes`` (8-, 16-, 32-bit
    length) that holds ``n``."""
    if fix is not None and n < fix_max:
        write(bytes((fix | n,)))
    elif codes[0] is not None and n < 1 << 8:
        write(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        write(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        write(struct.pack(">BI", codes[2], n))
    else:
        raise CheckpointError(f"msgpack cannot hold a length of {n}")


def _pack_int(n: int, write) -> None:
    if 0 <= n < 0x80:
        write(struct.pack("B", n))
    elif -0x20 <= n < 0:
        write(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        write(struct.pack(">BB", 0xCC, n))
    elif -0x80 <= n < 0:
        write(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        write(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        write(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        write(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        write(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        write(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        write(struct.pack(">Bq", 0xD3, n))
    else:
        raise CheckpointError(f"integer {n} does not fit 64 bits")


def _pack(obj, write: Callable[[bytes], Any]) -> None:
    """Write ``obj`` (nested dict/list of str, bytes-like, int, float,
    bool, None) to ``write`` as msgpack. Bytes-like values are written
    as they are, without a copy."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, write)
    elif isinstance(obj, float):
        write(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), write)
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_len(memoryview(obj).nbytes, None, 0, (0xC4, 0xC5, 0xC6), write)
        write(obj)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), write)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise CheckpointError(f"map keys must be str, got {k!r}")
            _pack(k, write)
            _pack(v, write)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), write)
        for v in obj:
            _pack(v, write)
    else:
        raise CheckpointError(f"msgpack subset cannot hold {type(obj)}")


class _Reader:
    """msgpack decoder over one buffer; ``bin`` values are zero-copy
    memoryview slices of it."""

    _FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
              0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
    _LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack_fmt(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self._take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.read() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self._take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in self._FIXED:
            return self._unpack_fmt(self._FIXED[code])
        if code in self._LEN:
            n = self._unpack_fmt(self._LEN[code])
            if code <= 0xC6:
                return self._take(n)
            if code <= 0xDB:
                return str(self._take(n), "utf-8")
            if code <= 0xDD:
                return [self.read() for _ in range(n)]
            return self._map(n)
        raise CheckpointError(f"msgpack type 0x{code:02x} is not part of the checkpoint format")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    parts = []
    _pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)


def unpackb(data):
    """Inverse of :func:`packb` (bin values come back as memoryviews)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise CheckpointError("trailing bytes after the msgpack value")
    return out


# ---------------------------------------------------------------------------
# Tree framing
# ---------------------------------------------------------------------------


def _array(x, path: str) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise CheckpointError(
                f"bfloat16 leaf at {path or '<root>'}: numpy has no bfloat16 dtype string, so "
                "neither package could read the file back; cast the leaf to float32 first")
        x = x.detach().cpu().numpy()
    return np.require(x, requirements="C")  # keeps 0-d arrays 0-d


def _encode(tree, path: str = ""):
    if isinstance(tree, QTensor):
        return {_SENTINEL_Q: True, "q": _encode(tree.q, path + ".q"),
                "scale": _encode(tree.scale, path + ".scale"), "bits": int(tree.bits),
                "block": int(tree.block), "orig_last": int(tree.orig_last)}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        arr = _array(tree, path)
        if arr.dtype.kind == "V":
            raise CheckpointError(f"leaf at {path or '<root>'} has dtype {arr.dtype.str}, "
                                  "which neither package reads back")
        return {_SENTINEL_A: True, "dtype": arr.dtype.str, "shape": list(arr.shape),
                "data": memoryview(arr.reshape(-1)).cast("B")}
    if isinstance(tree, dict):
        return {k: _encode(v, f"{path}.{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [_encode(v, f"{path}[{i}]") for i, v in enumerate(tree)],
                "__tuple__": isinstance(tree, tuple)}
    if isinstance(tree, (int, float, str, bool)) or tree is None:
        return {"__scalar__": tree}
    raise CheckpointError(f"cannot checkpoint leaf of type {type(tree)} at {path or '<root>'}")


def _decode(obj, device):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL_Q):
            return QTensor(_decode(obj["q"], device), _decode(obj["scale"], device),
                           obj["bits"], obj["block"], obj["orig_last"])
        if obj.get(_SENTINEL_A):
            dtype = np.dtype(obj["dtype"])
            if dtype.kind == "V":
                raise CheckpointError(
                    f"array of dtype {obj['dtype']} (a bfloat16 leaf written by the JAX "
                    "package?) has no numpy or torch type to read it as")
            arr = np.frombuffer(obj["data"], dtype=dtype).reshape(obj["shape"])
            return torch.from_numpy(arr.copy()).to(device)
        if "__list__" in obj:
            items = [_decode(v, device) for v in obj["__list__"]]
            return tuple(items) if obj.get("__tuple__") else items
        if "__scalar__" in obj:
            return obj["__scalar__"]
        return {k: _decode(v, device) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, tree: Any) -> int:
    """Write ``tree`` to ``path`` atomically (a temporary file, then a
    rename); returns the bytes written. Tensors on the card are copied
    to the host leaf by leaf as they are encoded."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    encoded = _encode(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack(encoded, f.write)
        n = f.tell()
    os.replace(tmp, path)
    return n


def load_checkpoint(path: str, device=None) -> Any:
    """Read a checkpoint written by either package; array leaves become
    tensors on ``device``, quantized leaves :class:`QTensor`. ``None``
    means the card; with no card, only ``device="cpu"`` runs."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        data = f.read()
    return _decode(unpackb(data), device)


def _structure(tree) -> str:
    """The tree's containers with every leaf as ``*`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_structure(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_fingerprint(tree: Any) -> str:
    """Stable 16-hex digest of a tree's exact contents: its structure,
    then every leaf in its checkpoint encoding. Any bit flip in any
    leaf, or any change of structure, changes it; the activation cache's
    manifest uses it to detect a changed backbone or corpus.

    Hashing is streamed leaf by leaf (one leaf on the host at a time),
    so no buffer the size of the model is ever built.

    The digest is the port's own and never equals the reference's: the
    reference hashes ``repr`` of JAX's tree definition, which the port
    cannot produce. A cache directory written by one package therefore
    fails the other's manifest check and is re-captured.
    """
    h = hashlib.sha256()
    h.update(_structure(tree).encode())
    for leaf in _leaves(tree):
        _pack(_encode(leaf), h.update)
    return h.hexdigest()[:16]
