"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) on first use into ``kernels/build/`` (listed
in ``.gitignore``).  The library's file name carries a digest of the sources
and flags, so an edited source is rebuilt and a stale build is never loaded.
``build()`` starts one ``nvcc`` per source, all at once, and waits for all of
them; a failure raises with ``nvcc``'s stderr.  Importing this module needs
neither ``nvcc`` nor a GPU: nothing is built until a kernel is launched (or
``build()`` is called).

Calling convention of every C entry point: pointers and the stream are
``c_void_p`` (a Python int from ``tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``); it returns the launch's
``cudaGetLastError()``, and ``check()`` raises when that is not 0.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's conventional install prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compiles the named sources (all of ``SOURCES`` by default) that have no
    up-to-date library, one ``nvcc`` each, all started together."""
    names = names or SOURCES
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return todo


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas`` printed for the current build of ``name``
    (registers, shared memory and spills per kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, prefix: str, err: int) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {err}: {fn(err).decode()}")
