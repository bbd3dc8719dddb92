"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each `csrc/*.cu` source compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into a shared library with a plain C interface, loaded with `ctypes`.
Libraries are keyed by a hash of the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads at once.  Nothing builds at
import time: `library(name)` builds on the first CUDA launch, and
`build_all()` builds every source at once, one nvcc process each, all
started together.  `start_build` / `finish_build` also build the host C++
library of `io/native_decoder.py` with g++.
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
SOURCES = ("neighborhood", "mapops", "preprocess", "eig3")
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


def _target(source: pathlib.Path, deps, flags, build_dir: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [source, *deps]:
        h.update(path.read_bytes())
    return build_dir / f"{source.stem}-{h.hexdigest()[:16]}.so"


def start_build(compiler, source: pathlib.Path, deps, flags,
                build_dir: pathlib.Path, libs=()):
    """Start compiling `source` (plus the headers `deps`) into
    build_dir/<stem>-<hash of flags and sources>.so; returns (process or
    None when the library is already built, target, temporary name).
    `compiler()` names the compiler; it is asked only when a build starts.
    Each process writes its own temporary file and renames it into place,
    so processes building the same library at once do not collide."""
    target = _target(source, deps, flags, build_dir)
    if target.exists():
        return None, target, None
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *flags, "-o", str(tmp), str(source), *libs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, target, tmp


def finish_build(what: str, proc, target: pathlib.Path, tmp) -> ctypes.CDLL:
    """Wait for a build from `start_build` and load its library; raises with
    the compiler's output when the build failed."""
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {what} failed:\n{out.decode(errors='replace')}"
            )
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))


def _start(name: str):
    return start_build(_nvcc, CSRC / f"{name}.cu", sorted(CSRC.glob("*.cuh")),
                       NVCC_FLAGS, BUILD_DIR)


def _finish(name: str, proc, target: pathlib.Path, tmp) -> None:
    _LIBS[name] = finish_build(f"csrc/{name}.cu with nvcc", proc, target, tmp)


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
