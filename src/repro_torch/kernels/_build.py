"""Build and load the CUDA kernels under ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface; it compiles with ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root, named by the content hash of the source and the
shared headers (``csrc/*.cuh``) so an edited source never loads a stale
library, and is loaded with ``ctypes``.  Nothing
is built or loaded at import: the first launch builds, and
``build_all()`` builds every source in parallel (one ``nvcc`` each, all
started together).  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("fused_expand", "coverage", "lt_select_expand",
           "flash_attention", "fused_expand_q", "flash_prefill_wgmma",
           "flash_decode", "flash_attention_bwd", "flash_bwd_wgmma",
           "flash_prefill_tf32x3", "flash_bwd_tf32x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launchers: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels build only where the toolkit is")
    return nvcc


def library_path(name: str) -> Path:
    """The library of ``<name>.cu``, named by the hash of the source and of
    every shared header in ``csrc`` it may include."""
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _tmp(lib: Path) -> Path:
    return lib.parent / f"{lib.name}.{os.getpid()}.tmp"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns the
    process (or None) and the library path."""
    lib = library_path(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(lib)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _finish(name: str, proc, lib: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(_tmp(lib), lib)


def build_all(names=SOURCES) -> None:
    """Compile every kernel source concurrently (no-op for built ones)."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        for name, proc, lib in started:
            _finish(name, proc, lib)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas=-v``: registers, shared memory, spills)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check_arg(kernel: str, name: str, t, dtype, dim: int, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dim``-D ``dtype`` tensor on
    ``dev`` — what a wrapper checks before it hands a pointer to C."""
    if t.device != dev or t.dtype != dtype or t.dim() != dim \
            or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous "
                         f"{dim}-D {dtype} tensor on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def data_ptr(t):
    """``t``'s device address for a ``c_void_p`` argument; None (a null
    pointer) for an absent optional tensor."""
    return None if t is None else t.data_ptr()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def launcher(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of `load`'s library of ``csrc/<name>.cu``, returning an
    int (a cudaError_t); its argument types are set on first use, not on
    every launch."""
    fn = _launchers.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _launchers[symbol] = fn
    return fn
