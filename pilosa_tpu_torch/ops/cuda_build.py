"""Build the CUDA count kernels (K1-K4) with nvcc and load them with ctypes.

Each source under csrc/ becomes its own shared library with a plain C
interface, compiled for sm_90a at first use into csrc/_build/ (or
$PILOSA_TORCH_BUILD_DIR), named by a hash of the sources so an edit
rebuilds and an unchanged tree reuses the library. All missing
libraries build at once, one nvcc process per source.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _B = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
_PP, _PLL = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)

# C entry point and argument types per source (csrc/<name>.cu).
ENTRIES = {
    "coarse_count": ("pilosa_coarse_count",
                     [_PP, _PLL, _I, _P, _I, _I, _I, _B, _I, _P, _P]),
    "coarse_count_shared": ("pilosa_coarse_count_shared",
                            [_PP, _PLL, _I, _P, _I, _I, _B, _I, _I, _B, _I,
                             _P, _P]),
    "tree_count": ("pilosa_tree_count",
                   [_PP, _PLL, _I, _P, _P, _I, _I, _B, _I, _P, _P]),
    "sparse_pair_count": ("pilosa_sparse_pair_count",
                          [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                           _I, _I, _P, _P]),
}

_MU = threading.Lock()
_FNS: dict = {}
BUILD_SECONDS: dict = {}


def build_dir() -> Path:
    return Path(os.environ.get("PILOSA_TORCH_BUILD_DIR", CSRC / "_build"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in (CSRC / "fold.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Build every missing library, all nvcc processes at once. Returns
    {name: library path}; raises with the compiler's output on failure.
    The ptxas report (registers, spills) is kept beside each library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in ENTRIES}
    t0 = time.monotonic()
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[name])
        BUILD_SECONDS[name] = time.monotonic() - t0
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


def kernel_fn(name: str):
    """The ctypes function of csrc/<name>.cu, built on first use."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    with _MU:
        if name not in _FNS:
            paths = build_all()
            for lib_name, (sym, argtypes) in ENTRIES.items():
                f = getattr(ctypes.CDLL(str(paths[lib_name])), sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _FNS[lib_name] = f
    return _FNS[name]
