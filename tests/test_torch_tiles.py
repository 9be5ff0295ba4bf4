"""The tiling and the leaf steps of K1 coarse_count and K6
coarse_count_blocked (csrc/coarse_tiles.cuh), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py). What they
read from the host is checked here: the chunk count of the tile planner
(ops.kernels.coarse_tiles), with the kernel's mapping of blocks and
threads to vectors mirrored below, must cover every (query, slice,
vector) of a launch exactly once, and the leaf steps
(ops.kernels.leaf_steps), interpreted the way the kernel walks them, must
fold every tree as the JAX package's Pallas K1 does (interpret mode) and
as ops.bitops.fold_tree does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.ops.bitops import fold_tree
from pilosa_tpu_torch.parallel.plan import canonical_tree
from torch_threads import one_torch_thread  # noqa: F401

H100_SMS = 132
SLICE_COUNTS = (1, 7, 24, 96, 133, 960)


def tile_span(chunks: int, t: int, x: int, y: int) -> tuple:
    """(query, first slice, end slice, first vector, end vector) that
    block (x, y) folds, as csrc/coarse_tiles.cuh reads its block index."""
    c, g = x % chunks, x // chunks
    v0 = c * tk.RUN_VEC // chunks
    return y, g * t, (g + 1) * t, v0, v0 + tk.RUN_VEC // chunks


def thread_vectors(chunks: int, x: int, thread: int) -> list:
    """The run vectors thread `thread` of block x folds in each slice of
    its tile, in the kernel's order: step i, then its TILE_UNROLL
    positions TILE_THREADS apart."""
    _, _, _, v0, v1 = tile_span(chunks, 1, x, 0)
    return [v0 + thread + i + u * tk.TILE_THREADS
            for i in range(0, v1 - v0, tk.TILE_STEP_VEC)
            for u in range(tk.TILE_UNROLL)]


def covered_once(chunks: int, s: int, batch: int, t: int = 1) -> bool:
    """Whether the grid (s / t * chunks, batch) folds every (query,
    slice, vector) exactly once, counted query by query."""
    for y in range(batch):
        seen = np.zeros((s, tk.RUN_VEC), dtype=np.int8)
        for x in range(s // t * chunks):
            b, s0, s1, v0, v1 = tile_span(chunks, t, x, y)
            assert b == y
            seen[s0:s1, v0:v1] += 1
        if not (seen == 1).all():
            return False
    return True


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("s", SLICE_COUNTS)
def test_tiles_cover_every_vector_once(s, batch):
    chunks = tk.coarse_tiles(s, batch, H100_SMS)
    assert chunks in (1, 2, 4, 8)
    assert tk.RUN_VEC // chunks % tk.TILE_STEP_VEC == 0
    assert covered_once(chunks, s, batch)
    # The fewest chunks that give every SM TILES_PER_SM tiles.
    n = s * batch
    assert n * chunks >= tk.TILES_PER_SM * H100_SMS or chunks == tk.MAX_CHUNKS
    if chunks > 1:
        assert n * chunks // 2 < tk.TILES_PER_SM * H100_SMS


@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("s", [96, 960, 3072])
def test_blocked_tiles_cover_every_vector_once(s, t):
    assert covered_once(tk.coarse_tiles(s, 1, H100_SMS, t), s, 1, t)


def test_headline_keeps_one_chunk():
    """The headline (960 slices, a lone pair or a 16-query batch) fills
    the card with whole runs; the time path's 96 slices cut each run."""
    assert tk.coarse_tiles(960, 1, H100_SMS) == 1
    assert tk.coarse_tiles(960, 16, H100_SMS) == 1
    assert tk.coarse_tiles(96, 1, H100_SMS) == 8
    assert tk.coarse_tiles(240, 1, H100_SMS) == 4
    assert tk.coarse_tiles(960, 1, H100_SMS, 32) == 8


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_threads_of_a_tile_cover_its_span_once(chunks):
    s = tk.TILES_PER_SM * H100_SMS // chunks  # so the planner picks chunks
    assert tk.coarse_tiles(s, 1, H100_SMS) == chunks
    for x in (0, chunks - 1, s * chunks - 1):
        _, _, _, v0, v1 = tile_span(chunks, 1, x, 0)
        got = sorted(v for th in range(tk.TILE_THREADS)
                     for v in thread_vectors(chunks, x, th))
        assert got == list(range(v0, v1))


def test_tiles_reject_what_the_kernels_do_not_take():
    for s, b, t in ((0, 1, 1), (4, 0, 1), (96, 1, 5), (7, 1, 2)):
        with pytest.raises(ValueError):
            tk.coarse_tiles(s, b, H100_SMS, t)


# -- leaf steps ---------------------------------------------------------------

L = [["leaf", i] for i in range(80)]


def chain(kind: str, n: int, first: int = 0):
    return [kind] + L[first:first + n]


def right_nested(depth: int):
    """and(l0, or(l1, andnot(l2, ... ))): every level a saved value, all
    combined back after the last leaf."""
    kinds = ("and", "or", "andnot")
    tree = L[depth]
    for d in reversed(range(depth)):
        tree = [kinds[d % 3], L[d], tree]
    return tree


def time_cover(n: int):
    return canonical_tree(["or"] + [["leaf"]] * n,
                          [("f", f"standard_{d}", 1, False)
                           for d in range(n)], [])


STEP_TREES = {
    "and": chain("and", 2),
    "or": chain("or", 2),
    "andnot": chain("andnot", 2),
    "nested": ["or", ["and", L[0], L[1]], ["andnot", L[2], L[3]]],
    "pops-then-push": ["or", L[0], ["and", L[1], L[2]],
                       ["andnot", L[3], L[4]], L[5]],
    "deep8": right_nested(7),
    "repeated-leaf": ["and", L[0], ["or", L[0], L[1]]],
    "time-cover-7": time_cover(7),
    "time-cover-29": time_cover(29),
    "or-80": chain("or", 80),
    "andnot-80": ["andnot", chain("or", 40), chain("and", 40, 40)],
}


def run_steps(steps, leaf):
    """The kernel's walk over leaf steps (csrc/coarse_tiles.cuh
    apply_step), on the host."""
    acc, saved = None, []
    for w in steps:
        if w >> 10 & 1:
            saved.append(acc)
        v, kind = leaf(w & 0xFF), w >> 8 & 3
        acc = v if kind == 0 else combine(kind, acc, v)
        for p in range(w >> 11 & 15):
            acc = combine(w >> (15 + 2 * p) & 3, saved.pop(), acc)
    assert not saved
    return acc


def combine(kind: int, a, b):
    return {1: a & b, 2: a | b, 3: a & ~b}[kind]


def nleaves(tree) -> int:
    if tree[0] == "leaf":
        return tree[1] + 1
    return max(nleaves(c) for c in tree[1:])


@pytest.mark.parametrize("name", sorted(STEP_TREES))
def test_leaf_steps_fold_as_the_tree(name):
    tree = STEP_TREES[name]
    prog = tk.tree_program(tree)
    steps = tk.leaf_steps(prog)
    assert len(steps) == sum(1 for op in prog if op >> 8 < 4)
    assert steps[0] >> 8 & 7 == 0  # the first step is a plain load
    rng = np.random.default_rng(len(name))
    words = rng.integers(0, 1 << 32, size=(nleaves(tree), 64),
                         dtype=np.uint32)
    words[0, :8] = 0xFFFFFFFF
    t = torch.from_numpy(words.view(np.int32))
    assert torch.equal(run_steps(steps, lambda i: t[i]),
                       fold_tree(tree, lambda i: t[i]))


def random_tree(rng, depth: int, leaves: int):
    if depth == 1 or rng.random() < 0.3:
        return ["leaf", int(rng.integers(leaves))]
    kind = ("and", "or", "andnot")[int(rng.integers(3))]
    return [kind] + [random_tree(rng, depth - 1, leaves)
                     for _ in range(int(rng.integers(2, 5)))]


@pytest.mark.parametrize("seed", range(12))
def test_leaf_steps_of_random_trees(seed):
    rng = np.random.default_rng(seed)
    tree = random_tree(rng, int(rng.integers(2, tk.MAX_DEPTH + 1)), 12)
    if tree[0] == "leaf":
        tree = ["or", tree, L[0]]
    try:
        prog = tk.tree_program(tree)
    except ValueError:
        pytest.fail("random trees stay within the kernels' limits")
    words = rng.integers(0, 1 << 32, size=(12, 32), dtype=np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    assert torch.equal(run_steps(tk.leaf_steps(prog), lambda i: t[i]),
                       fold_tree(tree, lambda i: t[i]))


@pytest.mark.parametrize("prog", [
    (0x100,),               # a combine into nothing
    (0x000, 0x400),         # a save never used
    (0x000, 0x500),         # a combine with nothing saved
    (0x000, 0x400, 0x101),  # a nested operand that does not load first
    (0x400, 0x000),         # a save before the first load
    (0x000, 0x800),         # an unknown op
])
def test_leaf_steps_reject_programs_tree_program_never_makes(prog):
    with pytest.raises(ValueError):
        tk.leaf_steps(prog)


# -- the plain versions at the new shapes, against the Pallas K1 ---------------

W = 2048


@pytest.mark.parametrize("name", ["deep8", "time-cover-29", "or-80",
                                  "pops-then-push"])
def test_coarse_plain_matches_pallas_on_wide_trees(name):
    """coarse_count_uniform / _per_slice (CPU: coarse_plain) against the
    JAX package's Pallas K1 in interpret mode, on the trees the tiled
    kernel's steps were widened for, with absent leaves."""
    tree = STEP_TREES[name]
    n = nleaves(tree)
    s, runs = 2, 2
    rng = np.random.default_rng(n)
    pool = rng.integers(0, 1 << 32, size=(s, runs * 16, W), dtype=np.uint32)
    pools = [pool] * n
    uni = rng.integers(-1, runs, size=n).astype(np.int32)
    uni[0] = 0
    tab = rng.integers(-1, runs, size=(n, s)).astype(np.int32)
    jp = tuple(jnp.asarray(p) for p in pools)
    tp = tuple(torch.from_numpy(p.view(np.int32)) for p in pools)
    for fn, starts in (("coarse_count_uniform", uni),
                       ("coarse_count_per_slice", tab)):
        want = np.asarray(getattr(jk, fn)(jp, jnp.asarray(starts), tree,
                                          interpret=True))
        got = getattr(tk, fn)(tp, torch.from_numpy(starts), tree)
        assert np.array_equal(got.numpy().astype(np.int64),
                              want.astype(np.int64)), fn
