"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Every ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), all
``nvcc`` processes started together.  The libraries land in
``build/repro_torch/<hash>/`` at the repository root (or under
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and the flags,
so an edited kernel rebuilds and an unchanged one loads at once.  Each
build writes ``<name>.log`` beside the library with ``-Xptxas -v``'s report
of registers, shared memory and spills.

Each C entry point takes ``c_void_p`` pointers, ``c_int`` sizes and tiles,
and the stream, and returns the ``cudaGetLastError()`` code of its launch;
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0  # wall time of this process's build (0 when cached)


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if root:
        return Path(root)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_all() -> Dict[str, Path]:
    """Compile every source not yet built, in parallel; paths by name."""
    global build_seconds
    out = build_dir() / _digest()
    out.mkdir(parents=True, exist_ok=True)
    targets = {name: out / f"{name}.so" for name in sources()}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if not todo:
        return targets
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (exit {rc}):\n{(out / f'{name}.log').read_text()}")
            continue
        os.replace(tmp, todo[name])  # atomic: a torn build is never loaded
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for lib_name, path in _build_all().items():
                _LIBS[lib_name] = ctypes.CDLL(str(path))
            lib = _LIBS[name]
        return lib


_FUNCS: Dict[str, Any] = {}


def function(lib_name: str, name: str, argtypes, restype=ctypes.c_int):
    """C entry point ``name`` of library ``lib_name``, typed once."""
    key = f"{lib_name}.{name}"
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(lib_name), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch's ``cudaGetLastError()`` code is not success."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


_BOUND = threading.local()  # the device whose context this thread made current


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a C pointer.

    On a thread's first call for a device it also makes that device's
    context current on the thread (``cudaStreamQuery`` through PyTorch's
    runtime does).  The wgmma kernels encode their TMA maps through the
    driver before their first runtime call, and a thread that has made no
    runtime call yet (a fleet worker whose output tensors came from the
    allocator's cache) has no current context: the encode then fails and
    the launch returns ``cudaErrorInvalidValue``.
    """
    import torch

    stream = torch.cuda.current_stream(t.device)
    if getattr(_BOUND, "device", None) != t.device:
        stream.query()
        _BOUND.device = t.device
    return ctypes.c_void_p(stream.cuda_stream)


class Counter:
    """How often a wrapper launched its kernel, and how often it ran the
    plain version instead (CPU tensors).  A run resets both, drives a path,
    and reads them to show which route the path took.

    ``launches`` and ``plain_calls`` count every thread; :meth:`on_thread`
    gives one thread's share, so a serving thread's launches read apart
    from a background tuner's trials.  The wrappers add through
    :meth:`launched` and :meth:`ran_plain`, under a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self._threads: Dict[int, list] = {}

    def _add(self, i: int) -> None:
        with self._lock:
            if i:
                self.plain_calls += 1
            else:
                self.launches += 1
            self._threads.setdefault(threading.get_ident(), [0, 0])[i] += 1

    def launched(self) -> None:
        """One launch of the kernel, on the calling thread."""
        self._add(0)

    def ran_plain(self) -> None:
        """One call of the plain version, on the calling thread."""
        self._add(1)

    def on_thread(self, ident: int) -> tuple:
        """(launches, plain calls) made on thread ``ident`` since the last
        reset."""
        with self._lock:
            return tuple(self._threads.get(ident, (0, 0)))


def route(tensors, what: str) -> str:
    """``"cuda"`` when every tensor lies on one CUDA device, ``"cpu"`` when
    all lie on the CPU; raises on a mix (nothing is moved behind the
    caller's back)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on several devices {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device type {kind!r}")
    return kind
