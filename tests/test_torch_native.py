"""The port's host kernels (pilosa_tpu_torch.ops.native, its own
csrc/pilosa_native.cpp built with g++) against the JAX package's
pilosa_tpu.ops.native and numpy, on seeded inputs.

Every public function, at sizes on both sides of its cut-over to numpy
(POPCNT_NATIVE_MIN words, SORTED_NATIVE_MIN elements): fold_blocks for
and, or and andnot over 2 and 5 leaves, bitmap_contains at the edge of
its domain, fold_count over flat and nested trees. Then the numpy path
under PILOSA_TORCH_NO_NATIVE=1, the two libraries side by side in one
process, the library's name, and a build with CXX=false, which raises
RuntimeError at every call and never answers from numpy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pilosa_tpu.ops import native as jn
from pilosa_tpu_torch.ops import native as tn

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
POP = tn.POPCNT_NATIVE_MIN
SRT = tn.SORTED_NATIVE_MIN


def words(seed: int, n: int, density: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) << np.uint64(1)
    w |= rng.integers(0, 2, size=n, dtype=np.uint64)
    if density < 0.5:
        w &= rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return w


def sorted_vals(seed: int, n: int, hi: int = 1 << 20) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(hi, size=n, replace=False)).astype(np.uint32)


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("PILOSA_TORCH_NO_NATIVE", raising=False)
    monkeypatch.delenv("PILOSA_TPU_NO_NATIVE", raising=False)
    yield


def test_both_libraries_are_live_in_one_process():
    assert tn.has_native()
    assert jn.has_native()
    assert tn.lib_path().parent == tn.build_dir()
    assert tn.lib_path().exists()
    # RTLD_LOCAL: each package calls its own library's symbols.
    assert tn._lib._name != str(REPO / "native" / "build"
                                / "libpilosa_native.so")


def test_the_source_is_the_jax_packages_kernels():
    """The same 14 extern "C" entry points, in the same order."""
    import re

    pat = re.compile(r"^(?:uint64_t|size_t|void) (pilosa_\w+)\(", re.M)
    port = pat.findall((REPO / "pilosa_tpu_torch" / "csrc"
                        / "pilosa_native.cpp").read_text())
    jax = pat.findall((REPO / "native" / "pilosa_native.cpp").read_text())
    assert port == jax and len(port) == 14


@pytest.mark.parametrize("n", [64, 1024, POP - 1024, POP, POP + 1024,
                               4 * POP])
def test_popcounts(n):
    s, m = words(n, n), words(n + 1, n, density=0.2)
    assert tn.popcnt_slice(s) == jn.popcnt_slice(s) \
        == int(np.bitwise_count(s).sum())
    for name, op in (("and", np.bitwise_and), ("or", np.bitwise_or),
                     ("xor", np.bitwise_xor),
                     ("andnot", lambda a, b: a & ~b)):
        want = int(np.bitwise_count(op(s, m)).sum())
        assert getattr(tn, f"popcnt_{name}_slice")(s, m) == want
        assert getattr(jn, f"popcnt_{name}_slice")(s, m) == want


@pytest.mark.parametrize("n", [1024, 4096, POP, 16 * POP])
def test_popcnt_blocks(n):
    s = words(7 + n, n)
    want = np.bitwise_count(s).reshape(-1, 1024).sum(axis=1,
                                                     dtype=np.uint64)
    got = tn.popcnt_blocks(s)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jn.popcnt_blocks(s))


@pytest.mark.parametrize("op", ["and", "or", "andnot"])
@pytest.mark.parametrize("nleaves", [2, 5])
@pytest.mark.parametrize("n", [POP, 3 * POP, 16 * 1024 * 4])
def test_fold_blocks(op, nleaves, n):
    leaves = [words(100 * nleaves + i, n, density=0.2 + 0.1 * (i % 3))
              for i in range(nleaves)]
    acc = leaves[0]
    for w in leaves[1:]:
        acc = {"and": acc & w, "or": acc | w, "andnot": acc & ~w}[op]
    out, counts = tn.fold_blocks(leaves, op)
    jout, jcounts = jn.fold_blocks(leaves, op)
    np.testing.assert_array_equal(out, acc)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        counts, np.bitwise_count(acc).reshape(-1, 1024).sum(axis=1))
    np.testing.assert_array_equal(counts, jcounts)


@pytest.mark.parametrize("case", ["small", "ragged", "one leaf", "xor op",
                                  "int64", "shape"])
def test_fold_blocks_declines_what_it_does_not_take(case):
    a, b = words(1, POP), words(2, POP)
    args = {"small": ([a[:1024], b[:1024]], "and"),
            "ragged": ([a[:POP - 7], b[:POP - 7]], "and"),
            "one leaf": ([a], "and"),
            "xor op": ([a, b], "xor"),
            "int64": ([a.view(np.int64), b.view(np.int64)], "or"),
            "shape": ([a, b[:-1024]], "or")}[case]
    assert tn.fold_blocks(*args) is None
    assert jn.fold_blocks(*args) is None


TREES = [
    ["and", ["leaf", 0], ["leaf", 1]],
    ["or", ["leaf", 0], ["leaf", 1], ["leaf", 2], ["leaf", 3], ["leaf", 4]],
    ["andnot", ["leaf", 0], ["leaf", 1], ["leaf", 2]],
    ["and", ["leaf", 1], ["leaf", 0]],                       # reordered
    ["or", ["and", ["leaf", 0], ["leaf", 1]],
     ["andnot", ["leaf", 2], ["leaf", 3]]],                   # nested
    ["and", ["or", ["leaf", 0], ["leaf", 1], ["leaf", 2]],
     ["andnot", ["leaf", 3], ["or", ["leaf", 4], ["leaf", 0]]]],
    ["leaf", 2],
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
@pytest.mark.parametrize("n", [1024, 16 * 1024])
def test_fold_count(tree, n):
    from pilosa_tpu_torch.ops.bitops import flat_fold_op, fold_tree

    def top(t):
        return t[1] if t[0] == "leaf" else max(top(c) for c in t[1:])

    # One block a leaf: the fused path folds every block it is given.
    blocks = [words(40 + i, n, density=0.3) for i in range(top(tree) + 1)]
    want = int(np.bitwise_count(fold_tree(tree, lambda i: blocks[i])).sum())
    assert tn.fold_count(blocks, tree) == want
    assert jn.fold_count(blocks, tree) == want
    from pilosa_tpu.ops.bitops import flat_fold_op as j_flat

    assert flat_fold_op(tree) == j_flat(tree)


@pytest.mark.parametrize("na,nb", [(10, 20), (SRT // 2 - 1, SRT // 2),
                                   (SRT // 2, SRT // 2), (3000, 5000),
                                   (0, 4000), (4000, 0), (1, SRT)])
def test_sorted_array_kernels(na, nb):
    a = sorted_vals(na * 7 + 1, na, hi=1 << 14)
    b = sorted_vals(nb * 11 + 2, nb, hi=1 << 14)
    for name, np_fn in (
            ("intersect_sorted",
             lambda x, y: np.intersect1d(x, y, assume_unique=True)),
            ("union_sorted", np.union1d),
            ("difference_sorted",
             lambda x, y: np.setdiff1d(x, y, assume_unique=True)),
            ("xor_sorted",
             lambda x, y: np.setxor1d(x, y, assume_unique=True))):
        got = getattr(tn, name)(a, b)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, np_fn(a, b))
        np.testing.assert_array_equal(got, getattr(jn, name)(a, b))
    n = len(np.intersect1d(a, b))
    assert tn.intersection_count_sorted(a, b) == n \
        == jn.intersection_count_sorted(a, b)


@pytest.mark.parametrize("n", [0, 1, 1024, 1 << 14])
@pytest.mark.parametrize("density", [0.01, 0.5])
def test_bitmap_to_values(n, density):
    w = words(n + 3, n, density=density)
    if density < 0.5:
        w &= words(n + 4, n, density=density)
    want = np.flatnonzero(np.unpackbits(w.view(np.uint8),
                                        bitorder="little")).astype(np.uint32)
    got = tn.bitmap_to_values(w)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jn.bitmap_to_values(w))
    # A strided view takes the numpy path, with the same answer.
    if n:
        np.testing.assert_array_equal(tn.bitmap_to_values(w[::2]),
                                      jn.bitmap_to_values(w[::2]))


@pytest.mark.parametrize("na", [5, SRT - 1, SRT, 3 * SRT])
def test_bitmap_contains(na):
    w = words(na, 1024)
    a = sorted_vals(na + 9, na, hi=1 << 16)
    want = ((w[a >> 6] >> (a.astype(np.uint64) & np.uint64(63)))
            & np.uint64(1)).astype(bool)
    got = tn.bitmap_contains(w, a)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jn.bitmap_contains(w, a))


@pytest.mark.parametrize("na", [5, SRT, 3 * SRT])
def test_bitmap_contains_at_the_edge_of_its_domain(na):
    """The last word's top bit is inside the domain; one value past the
    words raises IndexError on both sides of the cut-over, as numpy's
    indexing does, instead of reading out of bounds."""
    w = np.zeros(1024, dtype=np.uint64)
    w[-1] = np.uint64(1) << np.uint64(63)
    top = (1 << 16) - 1
    a = np.concatenate([sorted_vals(na, na - 1, hi=top),
                        [top]]).astype(np.uint32)
    got = tn.bitmap_contains(w, a)
    assert bool(got[-1]) and not got[:-1].any()
    np.testing.assert_array_equal(got, jn.bitmap_contains(w, a))
    past = a.copy()
    past[-1] = 1 << 16
    with pytest.raises(IndexError):
        tn.bitmap_contains(w, past)
    with pytest.raises(IndexError):
        jn.bitmap_contains(w, past)


def test_no_native_path(monkeypatch):
    """PILOSA_TORCH_NO_NATIVE=1 (read at every call): has_native() says
    False and every function answers from numpy, equal to the kernels."""
    s, m = words(1, 4 * POP), words(2, 4 * POP)
    a, b = sorted_vals(1, 3000), sorted_vals(2, 3000)
    tree = TREES[4]
    blocks = [words(70 + i, 16 * 1024) for i in range(4)]
    pair = blocks[:2]
    live = (tn.popcnt_slice(s), tn.popcnt_and_slice(s, m),
            tn.popcnt_blocks(s).tolist(), tn.intersect_sorted(a, b).tolist(),
            tn.bitmap_to_values(s[:1024]).tolist(),
            tn.fold_count(blocks, tree), tn.fold_count(pair, TREES[0]))
    monkeypatch.setenv("PILOSA_TORCH_NO_NATIVE", "1")
    assert not tn.has_native()
    assert tn.fold_blocks([s, m], "and") is None
    calls = []
    monkeypatch.setattr(tn, "_load", lambda: calls.append(1))
    numpy_side = (tn.popcnt_slice(s), tn.popcnt_and_slice(s, m),
                  tn.popcnt_blocks(s).tolist(),
                  tn.intersect_sorted(a, b).tolist(),
                  tn.bitmap_to_values(s[:1024]).tolist(),
                  tn.fold_count(blocks, tree), tn.fold_count(pair, TREES[0]))
    assert numpy_side == live and not calls
    monkeypatch.delenv("PILOSA_TORCH_NO_NATIVE")
    assert tn.has_native()


def test_the_library_is_named_by_source_flags_compiler_and_cpu(monkeypatch):
    base = tn.lib_path()
    assert base.name.startswith("pilosa_native-") and base.suffix == ".so"
    monkeypatch.setattr(tn, "_cpu_id", lambda: "another host's CPU")
    assert tn.lib_path() != base
    monkeypatch.undo()
    assert tn.lib_path(["clang++"]) != base
    monkeypatch.setattr(tn, "CXX_FLAGS", tn.CXX_FLAGS + ("-g",))
    assert tn.lib_path() != base


FAILED_BUILD = r"""
import sys
import numpy as np
from pilosa_tpu_torch.ops import native
seen = []
for call in (native.has_native,
             lambda: native.popcnt_slice(np.ones(8192, dtype=np.uint64)),
             lambda: native.popcnt_slice(np.ones(8, dtype=np.uint64)),
             lambda: native.bitmap_to_values(np.ones(4, dtype=np.uint64))):
    try:
        print("ANSWERED", call())
    except RuntimeError as err:
        seen.append(str(err))
print("RAISED", len(seen))
print("STDERR_IN_MESSAGE", all("failed" in s for s in seen))
print("NO_STAMP", not any(p.name.endswith((".failed", ".build_failed"))
                          for p in native.build_dir().glob("*")))
"""


@pytest.mark.parametrize("cxx", ["false", "g++ -DNOT_A_FLAG -fno-such-flag"])
def test_a_failed_build_raises_and_never_answers_from_numpy(tmp_path, cxx):
    """CXX=false (no compiler output) and a compiler that rejects a flag
    (its stderr in the message): every call raises RuntimeError, small
    inputs included, in a fresh process with an empty build directory;
    nothing is stamped on disk."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PILOSA_TORCH_NO_NATIVE", "PYTHONPATH")}
    env.update(CXX=cxx, PILOSA_TORCH_BUILD_DIR=str(tmp_path),
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", FAILED_BUILD], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert not any(line.startswith("ANSWERED") for line in lines), lines
    assert "RAISED 4" in lines and "STDERR_IN_MESSAGE True" in lines
    assert "NO_STAMP True" in lines
    assert not list(tmp_path.glob("*.so"))
    if "no-such-flag" in cxx:
        # The compiler's own complaint reaches the caller.
        err = subprocess.run(
            [sys.executable, "-c",
             "from pilosa_tpu_torch.ops import native\n"
             "try:\n    native.has_native()\n"
             "except RuntimeError as e:\n    print(e)"],
            env=env, capture_output=True, text=True, timeout=300,
            cwd=str(REPO)).stdout
        assert "no-such-flag" in err
