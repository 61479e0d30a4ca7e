"""Build and bind the hand-written CUDA kernels (csrc/*.cu) and the native
host library (csrc/host/*.cpp).

Both are compiled at first use into build/psi_tpu_torch/ at the
repository root: every source by its own compiler process, all started
together, then one link into a shared library with a plain C interface.
Each build is keyed by a hash of its sources and flags, so an edited
source rebuilds and an unchanged one loads as it is; a file lock keeps
concurrent processes from building the same library twice.

  libkernels.so   nvcc for sm_90a. Each C entry point launches on the
                  stream it is given and returns cudaGetLastError();
                  `launch` raises when that is not 0.
  libpsi_host.so  g++ from PATH, else c++, with the flags of psi_tpu's
                  native/Makefile (-O3 -march=native -std=c++17; so
                  __builtin_popcount is the host's POPCNT instruction),
                  -fopenmp where the compiler accepts it; `native.py`
                  binds it.

A failed build or launch raises: nothing here falls back to the plain
versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
HOST_SRC = CSRC / "host"
BUILD_DIR = _PKG.parent / "build" / "psi_tpu_torch"
#: CUDA toolkit roots searched for bin/nvcc after PATH and $CUDA_HOME
NVCC_ROOTS = ("/usr/local/cuda",)
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC")
#: host compilers tried in order
CXX_NAMES = ("g++", "c++")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_bound: dict = {}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def source_hash() -> str:
    return _digest(NVCC_FLAGS, sorted(CSRC.glob("*.cu*")))


def _run_all(tool: str, cmds: list[list[str]]) -> None:
    """Run the commands side by side, one process each; raise with the
    compiler's output if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{tool} failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _build_library(stem: str, tool: str, digest: str, sources, compile_cmd,
                   link_cmd) -> pathlib.Path:
    """Compile `sources` in parallel and link them into BUILD_DIR/stem.so,
    unless the library on disk was built from the same digest."""
    lib = BUILD_DIR / f"{stem}.so"
    stamp = BUILD_DIR / f"{stem}.sha256"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
            _run_all(tool, [compile_cmd(str(src), obj)
                            for src, obj in zip(sources, objs)])
            out = os.path.join(tmp, f"{stem}.so")
            _run_all(tool, [link_cmd(objs, out)])
            os.replace(out, lib)
        stamp.write_text(digest)
    return lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *NVCC_ROOTS):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the library on disk matches the sources."""
    digest = source_hash()
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    return _build_library(
        "libkernels", "nvcc", digest, _sources(),
        lambda src, obj: [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
        lambda objs, out: [nvcc, *NVCC_ARCH, "-shared", "-o", out, *objs],
    )


def _cxx() -> str:
    for name in CXX_NAMES:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        f"no C++ compiler on PATH ({', '.join(CXX_NAMES)}): the native "
        "host library cannot be built"
    )


def _accepts_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as fh:
            fh.write("#include <omp.h>\nint f() { return omp_get_max_threads(); }\n")
        proc = subprocess.run(
            [cxx, "-fopenmp", "-fPIC", "-shared", "-o",
             os.path.join(tmp, "omp.so"), src],
            capture_output=True,
        )
        return proc.returncode == 0


def build_host() -> tuple[pathlib.Path, str]:
    """Compile csrc/host/*.cpp into libpsi_host.so; returns the library
    and the compiler command line it was built with."""
    cxx = _cxx()
    flags = CXX_FLAGS + (("-fopenmp",) if _accepts_openmp(cxx) else ())
    # the compiler's version and what -march=native resolves to on this
    # host: a library built for another CPU is rebuilt, not loaded
    target = subprocess.run(
        [cxx, *flags, "-E", "-v", "-x", "c++", os.devnull, "-o", os.devnull],
        capture_output=True, text=True).stderr
    sources = sorted(HOST_SRC.glob("*.cpp"))
    lib = _build_library(
        "libpsi_host", cxx, _digest((cxx, target, *flags), sources), sources,
        lambda src, obj: [cxx, *flags, "-c", "-o", obj, src],
        lambda objs, out: [cxx, *flags, "-shared", "-o", out, *objs],
    )
    return lib, " ".join((cxx, *flags))


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.psi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.psi_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def call(name: str, argtypes: list, restype, *args):
    """Call C entry `name` of the kernel library, declared with
    `argtypes` and `restype` at its first call, and return its result."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _bound[name] = fn
    return fn(*args)


def launch(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call C entry `name` (declared with `argtypes`) with `device` the
    current CUDA device, so that the launch, the stream the caller passes
    (`stream_ptr(device)`) and the tensors' pointers all belong to it
    whichever device was current before; raise on a non-zero
    cudaError_t."""
    with torch.cuda.device(device):
        rc = call(name, argtypes, ctypes.c_int, *args)
    if rc != 0:
        msg = load().psi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_int32(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous int32 tensor on `device`."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} is {t.dtype}, not torch.int32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
