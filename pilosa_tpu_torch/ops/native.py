"""The host fold's C++ kernels (csrc/pilosa_native.cpp), built with g++
and loaded with ctypes, with the JAX package's numpy cut-overs.

The library builds at the first kernel call, never at import, into
csrc/_build/ (or $PILOSA_TORCH_BUILD_DIR), named by a hash of the
source, the flags, the compiler and this host's CPU: a `-march=native`
library built on one host never loads on another. The compiler is `g++`
or $CXX. A failed build raises RuntimeError with the compiler's stderr
at the first call of the process, and at every call after it: nothing
turns to numpy quietly, and no failure is remembered on disk.

Every function asks for the library first, as the JAX loader does, so
any call builds it. The numpy versions run below the size cut-overs
(POPCNT_NATIVE_MIN, SORTED_NATIVE_MIN: numpy is faster on small
inputs), for inputs the kernels do not take (a dtype or layout), and
everywhere when PILOSA_TORCH_NO_NATIVE is set, which is read at every
call: `has_native()` says which path is live. The library is loaded with
ctypes' default RTLD_LOCAL: the JAX package's library exports the same
`pilosa_*` names, and both may sit in one process.

Nothing here imports torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .cuda_build import CSRC, build_dir

SOURCE = CSRC / "pilosa_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_MU = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[RuntimeError] = None

# Sizes below which numpy beats the ctypes call (the JAX package's,
# measured there: numpy wins at 1024-word containers, the kernels from
# 8K words on).
POPCNT_NATIVE_MIN = 8192      # uint64 words
SORTED_NATIVE_MIN = 2048      # combined array elements


def _cxx() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def _cpu_id() -> str:
    """This host's CPU model name and feature flags (what -march=native
    compiles for)."""
    found: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    found.setdefault(key, line)
    except OSError:
        pass
    return ("".join(found[k] for k in sorted(found))
            or platform.processor() or platform.machine())


def _compiler_id(cxx: list) -> str:
    """The compiler command and its --version banner (empty when it
    does not answer)."""
    try:
        r = subprocess.run([*cxx, "--version"], capture_output=True,
                           text=True, timeout=30)
        banner = r.stdout if r.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        banner = ""
    return " ".join(cxx) + "\n" + banner


def lib_path(cxx: Optional[list] = None) -> Path:
    """Where the library of this source, these flags, this compiler and
    this CPU lives."""
    cxx = cxx or _cxx()
    h = hashlib.sha1()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_compiler_id(cxx).encode())
    h.update(_cpu_id().encode())
    return build_dir() / f"pilosa_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library if it is missing; returns its path. Raises
    RuntimeError with the compiler's stderr when the build fails."""
    cxx = _cxx()
    path = lib_path(cxx)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(
            f"building {SOURCE.name} with {' '.join(cxx)} failed: "
            f"{err}") from err
    if r.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {SOURCE.name} with {' '.join(cxx)} failed "
            f"(exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build wins or loses whole
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pilosa_popcnt_slice.restype = ctypes.c_uint64
    lib.pilosa_popcnt_slice.argtypes = [_U64P, ctypes.c_size_t]
    for name in ("and", "or", "xor", "andnot"):
        fn = getattr(lib, f"pilosa_popcnt_{name}_slice")
        fn.restype = ctypes.c_uint64
        fn.argtypes = [_U64P, _U64P, ctypes.c_size_t]
    two = [_U32P, ctypes.c_size_t, _U32P, ctypes.c_size_t]
    for name, args in (("intersect_sorted_u32", two + [_U32P]),
                       ("intersection_count_sorted_u32", two),
                       ("union_sorted_u32", two + [_U32P]),
                       ("difference_sorted_u32", two + [_U32P]),
                       ("xor_sorted_u32", two + [_U32P]),
                       ("bitmap_to_values_u32",
                        [_U64P, ctypes.c_size_t, _U32P])):
        fn = getattr(lib, f"pilosa_{name}")
        fn.restype = ctypes.c_size_t
        fn.argtypes = args
    lib.pilosa_bitmap_contains_u32.restype = None
    lib.pilosa_bitmap_contains_u32.argtypes = [_U64P, _U32P,
                                               ctypes.c_size_t, _U8P]
    lib.pilosa_popcnt_blocks.restype = None
    lib.pilosa_popcnt_blocks.argtypes = [_U64P, ctypes.c_size_t,
                                         ctypes.c_size_t, _U64P]
    lib.pilosa_fold_blocks.restype = None
    lib.pilosa_fold_blocks.argtypes = [ctypes.POINTER(_U64P),
                                       ctypes.c_size_t, ctypes.c_int,
                                       ctypes.c_size_t, ctypes.c_size_t,
                                       _U64P, _U64P]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when PILOSA_TORCH_NO_NATIVE asks for
    numpy. The first call builds and loads it; a failed build raises,
    then and at every later call."""
    if os.environ.get("PILOSA_TORCH_NO_NATIVE"):
        return None
    lib = _lib
    if lib is not None:
        return lib
    return _load()


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _MU:
        if _lib is None:
            if _error is not None:
                raise _error
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError, AttributeError) as err:
                _error = err if isinstance(err, RuntimeError) else \
                    RuntimeError(f"loading {SOURCE.name}'s library "
                                 f"failed: {err}")
                raise _error from None
        return _lib


def has_native() -> bool:
    """True when the kernels are live (the library built and loaded),
    False when PILOSA_TORCH_NO_NATIVE asks for numpy; a failed build
    raises."""
    return _get_lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


# -- popcounts of word runs ----------------------------------------------------


def popcnt_slice(s: np.ndarray) -> int:
    lib = _get_lib()
    if (lib is not None and len(s) >= POPCNT_NATIVE_MIN
            and s.dtype == np.uint64 and s.flags.c_contiguous):
        return int(lib.pilosa_popcnt_slice(_p64(s), len(s)))
    return int(np.bitwise_count(s).sum())


def popcnt_blocks(s: np.ndarray, block_words: int = 1024) -> np.ndarray:
    """Per-block popcounts, (len(s) / block_words,) uint64, in one pass:
    one count per container."""
    nblocks = len(s) // block_words
    lib = _get_lib()
    if (lib is not None and len(s) >= POPCNT_NATIVE_MIN
            and s.dtype == np.uint64 and s.flags.c_contiguous):
        out = np.empty(nblocks, dtype=np.uint64)
        lib.pilosa_popcnt_blocks(_p64(s), nblocks, block_words, _p64(out))
        return out
    return np.bitwise_count(s).reshape(nblocks, block_words) \
        .sum(axis=1, dtype=np.uint64)


_FOLD_OPS = {"and": 0, "or": 1, "andnot": 2}


def fold_blocks(leaves, op: str, block_words: int = 1024):
    """The fused flat fold with per-block popcounts: (out, counts) for
    out = leaves[0] op leaves[1] op ... (a left fold), or None when the
    kernels are off or the inputs do not qualify (fewer than 2 leaves,
    not all uint64, C-contiguous and of one shape, a size under
    POPCNT_NATIVE_MIN or no multiple of block_words): the caller then
    folds with numpy and counts with popcnt_blocks."""
    lib = _get_lib()
    code = _FOLD_OPS.get(op)
    if (lib is None or code is None or len(leaves) < 2
            or any(a.dtype != np.uint64 or not a.flags.c_contiguous
                   or a.shape != leaves[0].shape for a in leaves)):
        return None
    n = leaves[0].size
    if n % block_words or n < POPCNT_NATIVE_MIN:
        return None
    nblocks = n // block_words
    out = np.empty(n, dtype=np.uint64)
    counts = np.empty(nblocks, dtype=np.uint64)
    ptrs = (_U64P * len(leaves))(*[_p64(a) for a in leaves])
    lib.pilosa_fold_blocks(ptrs, len(leaves), code, nblocks, block_words,
                           _p64(out), _p64(counts))
    return out, counts


def fold_count(blocks, tree) -> int:
    """Total popcount of a numbered op tree (plan._tree_signature)
    folded over numpy uint64 blocks. A flat tree (one op over leaves in
    index order: the common Intersect / Union) runs through the fused
    fold + per-block popcount in one pass; a nested or unqualified one
    folds with numpy (one intermediate per op level) and then counts."""
    from .bitops import flat_fold_op, fold_tree  # torch, never its CUDA state

    op = flat_fold_op(tree)
    if op is not None:
        r = fold_blocks(list(blocks), op)
        if r is not None:
            return int(r[1].sum())
    acc = fold_tree(tree, lambda i: blocks[i])
    return popcnt_slice(np.ascontiguousarray(acc))


def _popcnt_pair(name: str, np_op, s: np.ndarray, m: np.ndarray) -> int:
    lib = _get_lib()
    if (lib is not None and len(s) >= POPCNT_NATIVE_MIN
            and len(s) == len(m) and s.dtype == np.uint64
            and m.dtype == np.uint64 and s.flags.c_contiguous
            and m.flags.c_contiguous):
        return int(getattr(lib, f"pilosa_popcnt_{name}_slice")(
            _p64(s), _p64(m), len(s)))
    return int(np.bitwise_count(np_op(s, m)).sum())


def popcnt_and_slice(s, m) -> int:
    return _popcnt_pair("and", np.bitwise_and, s, m)


def popcnt_or_slice(s, m) -> int:
    return _popcnt_pair("or", np.bitwise_or, s, m)


def popcnt_xor_slice(s, m) -> int:
    return _popcnt_pair("xor", np.bitwise_xor, s, m)


def popcnt_andnot_slice(s, m) -> int:
    return _popcnt_pair("andnot", lambda a, b: a & ~b, s, m)


# -- sorted-array containers ---------------------------------------------------


def _sorted_lib(a: np.ndarray, b: np.ndarray):
    lib = _get_lib()
    return lib if len(a) + len(b) >= SORTED_NATIVE_MIN else None


def _u32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _sorted_lib(a, b)
    if lib is not None:
        a, b = _u32(a), _u32(b)
        out = np.empty(min(len(a), len(b)), dtype=np.uint32)
        k = lib.pilosa_intersect_sorted_u32(_p32(a), len(a), _p32(b),
                                             len(b), _p32(out))
        return out[:k]
    return np.intersect1d(a, b, assume_unique=True).astype(np.uint32)


def intersection_count_sorted(a: np.ndarray, b: np.ndarray) -> int:
    lib = _sorted_lib(a, b)
    if lib is not None:
        a, b = _u32(a), _u32(b)
        return int(lib.pilosa_intersection_count_sorted_u32(
            _p32(a), len(a), _p32(b), len(b)))
    return len(np.intersect1d(a, b, assume_unique=True))


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _sorted_lib(a, b)
    if lib is not None:
        a, b = _u32(a), _u32(b)
        out = np.empty(len(a) + len(b), dtype=np.uint32)
        k = lib.pilosa_union_sorted_u32(_p32(a), len(a), _p32(b), len(b),
                                         _p32(out))
        return out[:k]
    return np.union1d(a, b).astype(np.uint32)


def difference_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _sorted_lib(a, b)
    if lib is not None:
        a, b = _u32(a), _u32(b)
        out = np.empty(len(a), dtype=np.uint32)
        k = lib.pilosa_difference_sorted_u32(_p32(a), len(a), _p32(b),
                                              len(b), _p32(out))
        return out[:k]
    return np.setdiff1d(a, b, assume_unique=True).astype(np.uint32)


def xor_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _sorted_lib(a, b)
    if lib is not None:
        a, b = _u32(a), _u32(b)
        out = np.empty(len(a) + len(b), dtype=np.uint32)
        k = lib.pilosa_xor_sorted_u32(_p32(a), len(a), _p32(b), len(b),
                                       _p32(out))
        return out[:k]
    return np.setxor1d(a, b, assume_unique=True).astype(np.uint32)


def bitmap_to_values(words: np.ndarray) -> np.ndarray:
    """Bitmap words -> their set bit positions, sorted uint32 (a
    trailing-zero scan). The kernel takes C-contiguous uint64 words of
    at most 2^26 words; anything else unpacks with numpy."""
    lib = _get_lib()
    if (lib is not None and words.dtype == np.uint64
            and words.flags.c_contiguous and len(words) <= (1 << 26)):
        out = np.empty(len(words) << 6, dtype=np.uint32)
        k = lib.pilosa_bitmap_to_values_u32(_p64(words), len(words),
                                            _p32(out))
        return out[:k].copy()
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint32)


def bitmap_contains(words: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Membership mask of the sorted values `a` in bitmap `words`. A
    value past the words raises IndexError on both paths (the kernel
    runs only when a's last value is inside them)."""
    lib = _get_lib()
    if (lib is not None and len(a) >= SORTED_NATIVE_MIN
            and words.dtype == np.uint64 and words.flags.c_contiguous
            and int(a[-1]) >> 6 < len(words)):
        a = _u32(a)
        mask = np.empty(len(a), dtype=np.uint8)
        lib.pilosa_bitmap_contains_u32(_p64(words), _p32(a), len(a),
                                        mask.ctypes.data_as(_U8P))
        return mask.astype(bool)
    return ((words[a >> np.uint32(6)] >> (a.astype(np.uint64)
                                          & np.uint64(63)))
            & np.uint64(1)).astype(bool)
