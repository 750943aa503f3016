"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``; every
pointer and the stream cross as ``c_void_p``. Libraries are built at
first use into ``build/repro_torch_kernels/`` at the repository root
(ignored by git), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. :func:`build`
starts one ``nvcc`` per source, all at once.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.

:func:`plain_path` and :func:`run_plain` are the wrappers' one seam
between a kernel and its plain version: CPU tensors and meta tensors
(shapes only) take the plain version, and a tensor on the card never
does. Under the op-level pricer (:class:`repro_torch.launch.op_cost.OpPricer`,
a dispatch mode with a ``kernel_unit`` method) the plain version's call
is priced as one unit, as the kernel would move and compute it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("quant_matmul", "flash_attention", "paged_attention", "cached_mix", "lmhead_ce",
           "adapter_fuse")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A CUDA kernel failed to build or to launch."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code any source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 for a library that was already there)."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    seconds = {n: 0.0 for n in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build (``-Xptxas=-v`` register
    and shared-memory report), or "" when the library came prebuilt."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _libs:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`KernelError` for a non-zero ``cudaError_t``."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise KernelError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """The current stream of ``t``'s device, as the int ``c_void_p``
    takes; refuses a tensor on another card than the current one (the
    C entries launch on the current device)."""
    if t.device.index != torch.cuda.current_device():
        raise KernelError(
            f"tensor on {t.device}, current device is cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def plain_path(t: torch.Tensor) -> bool:
    """True where a wrapper takes its plain version: ``t`` on the CPU, or
    on the meta device (the pricer's shapes). False on the card."""
    return t.device.type in ("cpu", "meta")


def run_plain(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the plain version of kernel ``name``, on
    tensors :func:`plain_path` admits. When a dispatch mode of this thread
    has a ``kernel_unit`` method (the op-level pricer), the call goes
    through it, so that it is charged as one unit of kernel ``name``."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        unit = getattr(mode, "kernel_unit", None)
        if unit is not None:
            return unit(name, fn, args, kwargs)
    return fn(*args, **kwargs)


def require(cond: bool, msg: str) -> None:
    """Validate a wrapper argument (raises ``ValueError``)."""
    if not cond:
        raise ValueError(msg)
