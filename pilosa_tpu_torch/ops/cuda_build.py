"""Build the CUDA kernels (K0-K7, and the sector probe) with nvcc and
load them with ctypes.

Each source under csrc/ becomes its own shared library with a plain C
interface, compiled for sm_90a at first use into csrc/_build/ (or
$PILOSA_TORCH_BUILD_DIR), named by a hash of the sources so an edit
rebuilds and an unchanged tree reuses the library. All missing
libraries build at once, one nvcc process per source. The hash covers
every header under csrc/, so a header edit rebuilds every library.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.c_longlong
_PP, _PLL = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_PROG = ctypes.POINTER(ctypes.c_uint16)
_STEPS = ctypes.POINTER(ctypes.c_uint32)

# Wrapper name -> (source csrc/<source>.cu, C entry point, argument types).
ENTRIES = {
    "coarse_count": ("coarse_count", "pilosa_coarse_count",
                     [_PP, _PLL, _I, _P, _I, _I, _I, _I, _STEPS, _I, _P,
                      _P]),
    "coarse_count_shared": ("coarse_count_shared",
                            "pilosa_coarse_count_shared",
                            [_PP, _PLL, _I, _P, _I, _PROG, _I, _I, _P,
                             _P]),
    "tree_count": ("tree_count", "pilosa_tree_count",
                   [_PP, _PLL, _I, _PP, _I, _I, _I, _STEPS, _I, _P, _P]),
    "sparse_pair_count": ("sparse_pair_count", "pilosa_sparse_pair_count",
                          [_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P,
                           _I, _I, _P, _P]),
    "pair_count": ("pair_count", "pilosa_pair_count",
                   [_P, _P, _LL, _I, _P, _P]),
    "pair_count_rows": ("pair_count", "pilosa_pair_count_rows",
                        [_P, _LL, _P, _I, _I, _P, _LL, _P, _P, _I, _P, _P]),
    "probe_ok": ("probe_ok", "pilosa_probe_ok", [_P, _I, _P]),
    "coarse_count_blocked": ("coarse_count_blocked",
                             "pilosa_coarse_count_blocked",
                             [_PP, _PLL, _I, _P, _I, _I, _I, _STEPS, _I,
                              _P, _P]),
    "stream_popcount": ("coarse_count_blocked", "pilosa_stream_popcount",
                        [_P, _LL, _P, _I, _P, _P]),
    "apply_writes": ("apply_writes", "pilosa_apply_writes",
                     [_P, _I, _I, _P, _P, _P, _P, _I, _P]),
    "sector_probe": ("sector_probe", "pilosa_sector_probe",
                     [_P, _P, _LL, ctypes.c_uint32, _P]),
}
# One shared library per source.
SOURCES = tuple(sorted({src for src, _, _ in ENTRIES.values()}))

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
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Build every missing library, all nvcc processes at once. Returns
    {name: library path}; raises with the compiler's output on failure.
    The ptxas report (registers, spills) is kept beside each library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
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
    """The ctypes function of entry `name` (ENTRIES), every library
    built on first use."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    with _MU:
        if name not in _FNS:
            paths = build_all()
            libs = {src: ctypes.CDLL(str(path)) for src, path in paths.items()}
            for entry, (src, sym, argtypes) in ENTRIES.items():
                f = getattr(libs[src], sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _FNS[entry] = f
    return _FNS[name]
