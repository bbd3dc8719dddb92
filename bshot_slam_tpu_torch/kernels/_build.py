"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each `csrc/*.cu` source compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into a shared library with a plain C interface, loaded with `ctypes`.
Libraries are keyed by a hash of the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads at once.  Nothing builds at
import time: `library(name)` builds on the first CUDA launch, and
`build_all()` builds every source at once, one nvcc process each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("neighborhood", "mapops")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process or None, target, tmp)."""
    target = _target(name)
    if target.exists():
        return None, target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, target, tmp


def _finish(name: str, proc, target: pathlib.Path, tmp) -> None:
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu:\n{out.decode(errors='replace')}"
            )
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _LIBS[name] = lib


def build_all() -> float:
    """Build (or load) every kernel library in parallel; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS]
        started = [(n, *_start(n)) for n in todo]
        for name, proc, target, tmp in started:
            _finish(name, proc, target, tmp)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            if name not in _LIBS:
                _finish(name, *_start(name))
            lib = _LIBS[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


_FUNCS: dict[tuple[str, str], object] = {}


def bind(name: str, fn: str, argtypes) -> object:
    """The C entry point `fn` of csrc/<name>.cu with its argument types set
    (every entry point returns the CUDA status as an int).  The library is
    built and the function bound on the first call only."""
    f = _FUNCS.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[(name, fn)] = f
    return f
