"""The CUDA kernels (K0-K5) against their plain PyTorch versions, on a
card.

Marked `cuda`; each test skips without a card. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(the CPU tests hold the plain versions against the JAX package's Pallas
kernels, tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.ops import kernels as tk

S = 5
RUNS = 3
L0, L1, L2, L3 = (["leaf", i] for i in range(4))
TREES = [["and", L0, L1], ["or", L0, L1], ["andnot", L0, L1],
         ["or", ["and", L0, L1], ["andnot", L2, L3]]]


def nleaves(tree) -> int:
    return 1 if tree[0] == "leaf" else sum(nleaves(c) for c in tree[1:])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++")
    return torch.device("cuda")


def pools(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.integers(0, 1 << 32, size=(S, RUNS * 16, 2048),
                         dtype=np.uint32)
        p[0, 16:32] = 0xFFFFFFFF
        p[1, 32:48] = 0
        out.append(torch.from_numpy(p.view(np.int32)))
    return tuple(out)


def check(fn, cpu_pools, args, tree, card, *extra):
    want = fn(cpu_pools, *args, tree, *extra)
    got = fn(tuple(p.to(card) for p in cpu_pools),
             *(a.to(card) for a in args), tree, *extra)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(len(TREES)))
def test_coarse_kernels(card, t):
    tree = TREES[t]
    n = nleaves(tree)
    rng = np.random.default_rng(t)
    ps = pools(t, n)
    table = torch.from_numpy(
        rng.integers(-1, RUNS, size=(3 * n, S)).astype(np.int32))
    scalars = torch.from_numpy(
        rng.integers(-1, RUNS, size=3 * n).astype(np.int32))
    check(tk.coarse_count_per_slice, ps, (table[:n],), tree, card)
    check(tk.coarse_count_identity_batch, ps, (table,), tree, card)
    check(tk.coarse_count_uniform, ps, (scalars[:n],), tree, card)
    check(tk.coarse_count_uniform_batch, ps, (scalars,), tree, card)


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(len(TREES)))
def test_shared_kernels(card, t):
    tree = TREES[t]
    n = nleaves(tree)
    rng = np.random.default_rng(10 + t)
    ps = pools(10 + t, 3)
    leaf_map = tuple(tuple(int(u) for u in rng.integers(0, 3, size=n))
                     for _ in range(16))
    table = torch.from_numpy(
        rng.integers(-1, RUNS, size=(3, S)).astype(np.int32))
    check(tk.coarse_count_batch_per_slice, ps, (table,), tree, card,
          leaf_map)
    check(tk.coarse_count_shared_uniform, ps, (table[:, 0],), tree, card,
          leaf_map)


@pytest.mark.cuda
@pytest.mark.parametrize("t", range(len(TREES)))
def test_tree_count_kernel(card, t):
    tree = TREES[t]
    n = nleaves(tree)
    rng = np.random.default_rng(20 + t)
    ps = pools(20 + t, n)
    idx = torch.from_numpy(
        rng.integers(0, RUNS * 16, size=(4, n, S, 16)).astype(np.int32))
    hit = torch.from_numpy(
        (rng.random((4, n, S, 16)) < 0.7).astype(np.int32))
    check(tk.tree_count_per_slice, ps, (idx, hit), tree, card)


def sparse_pool(rng, s, c, k):
    """(S, C, K) int16 sorted-array values (u16 bits, 0xFFFF padded) and
    (S, C) int32 cards: random fills from empty to full K, with 65535
    and 0 at the edges of some containers."""
    vals = np.full((s, c, k), 0xFFFF, dtype=np.uint16)
    cards = np.zeros((s, c), dtype=np.int32)
    for i in range(s):
        for j in range(c):
            n = int(rng.integers(0, k + 1)) if j % 5 else (0, k, 1)[i % 3]
            v = np.sort(rng.choice(65536, size=n, replace=False))
            if n and j % 7 == 0:
                v[-1] = 65535
            if n > 1 and j % 3 == 0:
                v[0] = 0
            vals[i, j, :n] = np.unique(v)
            cards[i, j] = len(np.unique(v))
    return torch.from_numpy(vals.view(np.int16)), torch.from_numpy(cards)


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb", [(128, 128), (4096, 256), (8, 4096),
                                   (100, 36)])
def test_sparse_pair_kernel(card, ka, kb):
    rng = np.random.default_rng(ka + kb)
    s, r = 6, 16
    a_vals, a_cards = sparse_pool(rng, s, 24, ka)
    b_vals, b_cards = sparse_pool(rng, s, 40, kb)
    # b shares a's values in some containers, so the counts are not all 0.
    share = min(ka, kb)
    b_vals[:, :8, :share] = a_vals[:, :8, :share]
    b_cards[:, :8] = torch.minimum(a_cards[:, :8],
                                   torch.tensor(share, dtype=torch.int32))
    b_vals[:, :8, share:] = -1
    tables = [torch.from_numpy(t.astype(np.int32)) for t in (
        rng.integers(0, 24, size=(s, r)), rng.random((s, r)) < 0.8,
        rng.integers(0, 8, size=(s, r)), rng.random((s, r)) < 0.8)]
    args = (a_vals, a_cards, b_vals, b_cards, *tables)
    want = tk.sparse_pair_count(*args)
    before = tk.LAUNCHES["sparse_pair_count"]
    got = tk.sparse_pair_count(*(t.to(card) for t in args))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sparse_pair_count"] == before + 1
    assert want.sum() > 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sparse_flat_contract_kernel(card):
    edges = [[], [0], [65535], list(range(4096)), list(range(61440, 65536)),
             [0, 1, 65534, 65535], list(range(0, 65536, 16))]
    a = [x for x in edges for _ in edges]
    b = [y for _ in edges for y in edges]
    vals = np.full((2, len(a), 4096), 0xFFFF, dtype=np.int32)
    lens = np.zeros((2, len(a)), dtype=np.int32)
    for side, lists in enumerate((a, b)):
        for i, x in enumerate(lists):
            vals[side, i, :len(x)] = x
            lens[side, i] = len(x)
    args = [torch.from_numpy(t) for t in (vals[0], lens[0], vals[1],
                                          lens[1])]
    want = tk.pallas_sparse_pair_counts(*args)
    got = tk.pallas_sparse_pair_counts(*(t.to(card) for t in args))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert want.tolist() == [len(set(x) & set(y)) for x, y in zip(a, b)]


def words(rng, shape, zero_rows=()):
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    w[0, :8] = 0xFFFFFFFF
    for r in zero_rows:
        w[r] = 0
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
@pytest.mark.parametrize("m", [1, 7, 9, 64, 1001])
def test_pair_count_kernel(card, op, m):
    rng = np.random.default_rng(m)
    a, b = words(rng, (m, 2048)), words(rng, (m, 2048), zero_rows=[m - 1])
    for bb in (b, None):
        want = tk.pair_count(a, bb, op)
        before = tk.LAUNCHES["pair_count"]
        got = tk.pair_count(a.to(card), None if bb is None else bb.to(card),
                            op)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["pair_count"] == before + 1
        assert got.dtype == torch.int64 and int(got) == int(want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
@pytest.mark.parametrize("b_kind", ["none", "row", "block"])
def test_pair_count_rows_kernel(card, op, b_kind):
    rng = np.random.default_rng(len(op) + len(b_kind))
    s, cap, p = 6, 48, 5
    pool = words(rng, (s, cap, 2048))
    a_idx = rng.integers(0, cap, size=(p, s, 16)).astype(np.int32)
    a_idx[rng.random(a_idx.shape) < 0.2] = -1
    a_idx[1] = -1  # a row absent everywhere
    kw = {}
    if b_kind == "row":
        b_idx = rng.integers(-1, cap, size=(s, 16)).astype(np.int32)
        kw = {"b_pool": pool, "b_idx": torch.from_numpy(b_idx)}
    elif b_kind == "block":
        kw = {"b_block": words(rng, (s, 16, 2048))}
    args = (pool, torch.from_numpy(a_idx))
    want = tk.pair_count_rows(*args, op, **kw)
    got = tk.pair_count_rows(*(t.to(card) for t in args), op,
                             **{k: v.to(card) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert want.dtype == torch.int64 and want.sum() > 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_probe_ok_kernel(card):
    before = tk.LAUNCHES["probe_ok"]
    assert tk.probe_ok(card) is True
    assert tk.LAUNCHES["probe_ok"] == before + 1
