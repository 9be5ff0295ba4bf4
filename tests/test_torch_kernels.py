"""The port's count kernels against the JAX package's Pallas kernels.

Every wrapper of pilosa_tpu_torch.ops.kernels (on CPU tensors: its plain
PyTorch version) must equal the Pallas function of the same name run in
interpret mode, exactly: these are integer counts. Inputs are made once
with numpy from a fixed seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.ops.bitops import fold_tree
from pilosa_tpu_torch.parallel.mesh import combine_counts
from torch_threads import one_torch_thread  # noqa: F401

W = 2048
S = 3        # slices
RUNS = 3     # 16-container row runs per slice: cap = 48

L0, L1, L2, L3 = (["leaf", i] for i in range(4))
TREES = {
    "and": ["and", L0, L1],
    "or": ["or", L0, L1],
    "andnot": ["andnot", L0, L1],
    "nested": ["or", ["and", L0, L1], ["andnot", L2, L3]],
}


def nleaves(tree) -> int:
    return 1 if tree[0] == "leaf" else sum(nleaves(c) for c in tree[1:])


def make_pool(seed: int, runs: int = RUNS) -> np.ndarray:
    """(S, runs*16, W) uint32 random words with edge cases: slice 0's
    run 1 all ones, slice 1's run 2 all zero."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, size=(S, runs * 16, W), dtype=np.uint32)
    pool[0, 16:32] = 0xFFFFFFFF
    pool[1, 32:48] = 0
    return pool


def jax_pools(pools):
    return tuple(jnp.asarray(p) for p in pools)


def torch_pools(pools):
    return tuple(torch.from_numpy(p.view(np.int32)) for p in pools)


def jt(a):
    return jnp.asarray(a, dtype=jnp.int32)


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def same(jax_out, torch_out):
    want = np.asarray(jax_out).astype(np.int64)
    got = torch_out.numpy().astype(np.int64)
    assert got.shape == want.shape
    assert (got == want).all(), (got, want)


def starts_table(rng, rows: int) -> np.ndarray:
    """(rows, S) run indices with absences (-1) mixed in."""
    st = rng.integers(0, RUNS, size=(rows, S)).astype(np.int32)
    st[0, 1] = -1
    return st


@pytest.mark.parametrize("name", sorted(TREES))
def test_coarse_count_per_slice(name):
    tree = TREES[name]
    rng = np.random.default_rng(1)
    pools = [make_pool(10 + i) for i in range(nleaves(tree))]
    starts = starts_table(rng, nleaves(tree))
    same(jk.coarse_count_per_slice(jax_pools(pools), jt(starts), tree,
                                   interpret=True),
         tk.coarse_count_per_slice(torch_pools(pools), tt(starts), tree))


@pytest.mark.parametrize("name", sorted(TREES))
def test_coarse_count_identity_batch(name):
    tree = TREES[name]
    rng = np.random.default_rng(2)
    pools = [make_pool(20 + i) for i in range(nleaves(tree))]
    starts = starts_table(rng, 3 * nleaves(tree))  # B = 3
    same(jk.coarse_count_identity_batch(jax_pools(pools), jt(starts), tree,
                                        interpret=True),
         tk.coarse_count_identity_batch(torch_pools(pools), tt(starts), tree))


@pytest.mark.parametrize("name", sorted(TREES))
def test_coarse_count_uniform(name):
    tree = TREES[name]
    pool = make_pool(3)
    starts = np.array([1, 0, -1, 2][:nleaves(tree)], dtype=np.int32)
    pools = [pool] * nleaves(tree)
    same(jk.coarse_count_uniform(jax_pools(pools), jt(starts), tree,
                                 interpret=True),
         tk.coarse_count_uniform(torch_pools(pools), tt(starts), tree))


@pytest.mark.parametrize("name", sorted(TREES))
def test_coarse_count_uniform_batch(name):
    tree = TREES[name]
    rng = np.random.default_rng(4)
    pools = [make_pool(40 + i) for i in range(nleaves(tree))]
    starts = rng.integers(-1, RUNS, size=2 * nleaves(tree)).astype(np.int32)
    same(jk.coarse_count_uniform_batch(jax_pools(pools), jt(starts), tree,
                                       interpret=True),
         tk.coarse_count_uniform_batch(torch_pools(pools), tt(starts), tree))


# U = 3 unique runs, shared by B = 4 queries.
LEAF_MAPS = {
    "and": ((0, 1), (1, 2), (0, 2), (2, 2)),
    "andnot": ((0, 1), (1, 0), (2, 0), (1, 1)),
    "nested": ((0, 1, 2, 0), (2, 1, 0, 1), (1, 1, 2, 2), (0, 0, 0, 0)),
}


@pytest.mark.parametrize("name", sorted(LEAF_MAPS))
def test_coarse_count_batch_per_slice(name):
    tree, leaf_map = TREES[name], LEAF_MAPS[name]
    rng = np.random.default_rng(6)
    pools = [make_pool(60 + u) for u in range(3)]
    starts = starts_table(rng, 3)
    same(jk.coarse_count_batch_per_slice(jax_pools(pools), jt(starts), tree,
                                         leaf_map, interpret=True),
         tk.coarse_count_batch_per_slice(torch_pools(pools), tt(starts), tree,
                                         leaf_map))


@pytest.mark.parametrize("name", sorted(LEAF_MAPS))
def test_coarse_count_shared_uniform(name):
    tree, leaf_map = TREES[name], LEAF_MAPS[name]
    pool = make_pool(7)
    starts = np.array([2, -1, 1], dtype=np.int32)
    pools = [pool] * 3
    same(jk.coarse_count_shared_uniform(jax_pools(pools), jt(starts), tree,
                                        leaf_map, interpret=True),
         tk.coarse_count_shared_uniform(torch_pools(pools), tt(starts), tree,
                                        leaf_map))


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_count_pallas(name):
    tree = TREES[name]
    num_leaves = nleaves(tree)
    rng = np.random.default_rng(8)
    pool = make_pool(8)
    idx = rng.integers(0, RUNS * 16, size=(num_leaves, S, 16)).astype(np.int32)
    hit = (rng.random((num_leaves, S, 16)) < 0.7).astype(np.int32)
    hit[0, 0] = 0  # leaf 0 absent from slice 0
    want = jk.tree_count_pallas(jnp.asarray(pool), jt(idx), jt(hit), tree,
                                interpret=True)
    got = tk.tree_count_pallas(torch_pools([pool])[0], tt(idx), tt(hit), tree)
    assert int(got) == int(want)


def test_tree_count_per_slice_batch_matches_single_queries():
    tree = TREES["andnot"]
    rng = np.random.default_rng(9)
    pools = torch_pools([make_pool(90), make_pool(91)])
    idx = rng.integers(0, RUNS * 16, size=(3, 2, S, 16)).astype(np.int32)
    hit = (rng.random((3, 2, S, 16)) < 0.8).astype(np.int32)
    batched = tk.tree_count_per_slice(pools, tt(idx), tt(hit), tree)
    for b in range(3):
        one = tk.tree_count_per_slice(pools, tt(idx[b:b + 1]),
                                      tt(hit[b:b + 1]), tree)
        assert torch.equal(batched[b:b + 1], one)


def test_total_above_2_31_is_exact():
    # 4096 slices each with a full 2^20-bit row: 2^32 bits in all.
    per_bs = torch.full((2, 4096), 1 << 20, dtype=torch.int32)
    per_bs[1, :10] = 0
    mask = torch.ones(4096, dtype=torch.int64)
    assert combine_counts(per_bs, mask) == [1 << 32, (1 << 32) - 10 * (1 << 20)]


def test_tree_program_limits():
    # or(and(l0, l1), andnot(l2, l3)): load 0, and 1, save, load 2,
    # andnot 3, or the saved value back in.
    assert tk.tree_program(TREES["nested"]) == (
        0x000, 0x101, 0x400, 0x002, 0x303, 0x600)
    assert tk.tree_program(["andnot", L0, L1, L2]) == (0x000, 0x301, 0x302)
    deep = L0
    for i in range(1, 9):
        deep = ["and", ["leaf", i], deep]
    assert tk.tree_depth(deep) == 9
    with pytest.raises(ValueError):
        tk.tree_program(deep)
    wide = ["or"] + [["leaf", i] for i in range(tk.MAX_LEAVES)]
    assert len(tk.tree_program(wide)) == tk.MAX_LEAVES
    with pytest.raises(ValueError):
        tk.tree_program(wide + [["leaf", tk.MAX_LEAVES]])


def run_program(prog, leaves):
    """The kernels' fold loop (csrc/fold.cuh), in Python."""
    acc, saved = None, []
    comb = {1: np.bitwise_and, 2: np.bitwise_or, 3: lambda a, b: a & ~b}
    for op in prog:
        kind, leaf = op >> 8, op & 255
        if kind == 0:
            acc = leaves[leaf]
        elif kind < 4:
            acc = comb[kind](acc, leaves[leaf])
        elif kind == 4:
            saved.append(acc)
        else:
            acc = comb[kind - 4](saved.pop(), acc)
    return acc


def random_tree(rng, counter, depth=0):
    if depth >= 3 or rng.random() < 0.35:
        counter[0] += 1
        return ["leaf", counter[0] - 1]
    op = str(rng.choice(["and", "or", "andnot"]))
    return [op] + [random_tree(rng, counter, depth + 1)
                   for _ in range(int(rng.integers(1, 4)))]


def test_tree_program_runs_like_fold_tree():
    rng = np.random.default_rng(12)
    for _ in range(200):
        counter = [0]
        tree = random_tree(rng, counter)
        if counter[0] > tk.MAX_LEAVES or tk.tree_depth(tree) > tk.MAX_DEPTH:
            continue
        leaves = [rng.integers(0, 1 << 32, size=64, dtype=np.uint32)
                  for _ in range(counter[0])]
        want = fold_tree(tree, lambda i: leaves[i])
        assert (run_program(tk.tree_program(tree), leaves) == want).all()


def test_kernel_args_check_leaf_positions():
    # K2 folds 4 leaf positions over 3 unique pools (its programs name the
    # unique runs); K1/K3 read one pool per leaf position.
    pools = torch_pools([make_pool(1)] * 3)
    prog = tk.tree_program(TREES["nested"])
    shared = tk.shared_programs(TREES["nested"], ((0, 1, 2, 0),))[0]
    assert tk._kernel_args(pools, shared)[3] == len(prog)
    with pytest.raises(ValueError):
        tk._kernel_args(pools, prog)
    with pytest.raises(ValueError):  # a leaf position beyond the leaf map
        tk.shared_programs(TREES["nested"], ((0, 1, 2),))
    with pytest.raises(ValueError):  # a unique run beyond the pools
        tk._kernel_args(pools, tk.shared_programs(TREES["and"],
                                                  ((0, 3),))[0])


def test_shared_batch_beyond_limits_raises():
    pools = torch_pools([make_pool(1)])
    leaf_map = tuple((0, 0) for _ in range(17))
    with pytest.raises(ValueError):
        tk.coarse_count_shared_uniform(pools, tt([0]), TREES["and"], leaf_map)



SHARED_TREES = dict(TREES, wide16=["or"] + [
    ["and", ["leaf", 2 * i], ["leaf", 2 * i + 1]] for i in range(8)])


@pytest.mark.parametrize("name", sorted(SHARED_TREES))
def test_shared_programs_fold_like_shared_plain(name):
    # K2's per-query programs (unique run indices folded into the leaf
    # ops), run as the kernel runs them, against shared_plain.
    tree = SHARED_TREES[name]
    n = nleaves(tree)
    rng = np.random.default_rng(13)
    unique = [make_pool(130 + u) for u in range(3)]
    starts = starts_table(rng, 3)
    leaf_map = tuple(tuple(int(u) for u in rng.integers(0, 3, size=n))
                     for _ in range(5))
    progs = tk.shared_programs(tree, leaf_map)
    assert len(progs) == len(leaf_map)
    assert all(len(p) == len(tk.tree_program(tree)) for p in progs)
    runs = [np.stack([p[s, 16 * st:16 * st + 16] if st >= 0
                      else np.zeros((16, W), np.uint32)
                      for s, st in enumerate(starts[u])])
            for u, p in enumerate(unique)]
    got = np.stack([np.bitwise_count(run_program(p, runs)).sum(
        axis=(1, 2)) for p in progs])
    want = tk.shared_plain(torch_pools(unique), tt(starts), False, tree,
                           leaf_map)
    assert (got == want.numpy()).all()


def test_shared_programs_name_unique_runs():
    # Leaf ops carry the unique index; PUSH and combine ops stay as they
    # are.
    progs = tk.shared_programs(TREES["nested"], ((2, 0, 1, 2), (0, 0, 0, 0)))
    assert progs == ((0x002, 0x100, 0x400, 0x001, 0x302, 0x600),
                     (0x000, 0x100, 0x400, 0x000, 0x300, 0x600))
