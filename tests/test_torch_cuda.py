"""The CUDA kernels (K0-K6) against their plain PyTorch versions, on a
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


def pools(seed: int, n: int, s: int = S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.integers(0, 1 << 32, size=(s, RUNS * 16, 2048),
                         dtype=np.uint32)
        p[0, 16:32] = 0xFFFFFFFF
        p[min(1, s - 1), 32:48] = 0
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


FLAT16 = ["and"] + [["leaf", i] for i in range(16)]
NESTED16 = ["or"] + [["andnot", ["leaf", 2 * i], ["leaf", 2 * i + 1]]
                     for i in range(8)]
# K2 cases: (tree, queries B, unique runs U, slices S). Cases 0-3 are the
# four TREES over 3 unique runs; the rest span B and U from 1 to 16
# (U picks how many positions a thread folds: 4 up to U = 4, 2 up to 8,
# 1 up to 16), 16-leaf trees flat and nested, and slice counts that
# leave the tiles of a slice split between blocks.
SHARED_CASES = {
    **{str(t): (tree, 16, 3, S) for t, tree in enumerate(TREES)},
    "b1": (TREES[0], 1, 2, S),
    "u1": (TREES[1], 16, 1, S),
    "u16-wide": (TREES[3], 16, 16, 37),
    "flat16": (FLAT16, 16, 16, 3),
    "nested16": (NESTED16, 7, 16, 3),
    "s1": (TREES[3], 16, 5, 1),
    "s37-u3": (TREES[2], 16, 3, 37),
    "s37-u8": (TREES[0], 16, 8, 37),
    "s131-u8": (TREES[3], 9, 8, 131),
}


@pytest.mark.cuda
@pytest.mark.parametrize("t", sorted(SHARED_CASES))
def test_shared_kernels(card, t):
    tree, batch, unique, s = SHARED_CASES[t]
    n = nleaves(tree)
    seed = 10 + sorted(SHARED_CASES).index(t)
    rng = np.random.default_rng(seed)
    base = pools(seed, min(unique, 3), s)
    ps = tuple(base[u % len(base)] for u in range(unique))
    leaf_map = [[int(u) for u in rng.integers(0, unique, size=n)]
                for _ in range(batch)]
    leaf_map[0][0] = unique - 1  # every unique run is read
    leaf_map = tuple(tuple(m) for m in leaf_map)
    table = torch.from_numpy(
        rng.integers(-1, RUNS, size=(unique, s)).astype(np.int32))
    if unique > 2:
        table[1] = -1  # a run absent from every slice
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


def random_pair_case(ka, kb, s=6, r=16):
    rng = np.random.default_rng(ka + kb)
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
    return (a_vals, a_cards, b_vals, b_cards, *tables), None


def crafted_pairs(case, rng):
    """(a, b) value lists of the pairs a crafted case holds."""
    def pick(n, lo=0, hi=65536):
        return sorted(rng.choice(np.arange(lo, hi), size=n, replace=False))

    def one(lst):
        return [int(lst[int(rng.integers(len(lst)))])]

    full = list(range(0, 65536, 16))
    if case == "4096-1":
        return [(full, one(full)), (full, [1]), (full, [65520]),
                (full, [0]), (full, [])]
    if case == "1-4096":
        return [(b, a) for a, b in crafted_pairs("4096-1", rng)]
    if case == "full":
        return [(full, [x + 8 * (i % 2) for i, x in enumerate(full)]),
                (full, full), (pick(4096), pick(4096))]
    if case == "identical":
        return [(v, v) for v in (pick(2000), pick(1), pick(4096), [65535])]
    if case == "disjoint":
        return [(list(range(0, 8192, 2)), list(range(1, 8192, 2))),
                (pick(300, 0, 30000), pick(300, 30000))]
    if case == "one-off":
        out = []
        for n in (2, 17, 1500, 4000):
            a = pick(n)
            held = set(a)
            b = held - {a[int(rng.integers(n))]}
            b.add(one([x for x in range(65536) if x not in held][:50])[0])
            out.append((a, sorted(b)))
        return out
    if case == "ends":
        return [([0, 7, 65535], [0, 65535]), ([0], [0]), ([65535], [65535]),
                ([65535], [0]), (list(range(65536 - 30, 65536)),
                                 [0, 65534, 65535])]
    raise KeyError(case)


def crafted_case(case, k):
    """One pool a side: slice i, container j holds pair 16 * i + j of the
    case, repeated to fill 2 slices x 16 sub-keys, at value capacity k
    (odd k: containers that are not 16-byte aligned). The "full" case
    gives its first a-container a card above k, which counts as k."""
    rng = np.random.default_rng(len(case))
    pairs = crafted_pairs(case, rng)
    s, r = 2, 16
    sides = []
    for side in (0, 1):
        vals = np.full((s, r, k), 0xFFFF, dtype=np.uint16)
        cards = np.zeros((s, r), dtype=np.int32)
        for q in range(s * r):
            v = pairs[q % len(pairs)][side]
            vals[q // r, q % r, :len(v)] = v
            cards[q // r, q % r] = len(v)
        if case == "full" and side == 0:
            cards[0, 0] = k + 904
        sides += [torch.from_numpy(vals.view(np.int16)),
                  torch.from_numpy(cards)]
    idx = torch.arange(r, dtype=torch.int32).repeat(s, 1)
    one = torch.ones((s, r), dtype=torch.int32)
    want = torch.tensor([[len(set(pairs[(i * r + j) % len(pairs)][0])
                              & set(pairs[(i * r + j) % len(pairs)][1]))
                          for j in range(r)] for i in range(s)],
                        dtype=torch.int32)
    return (*sides, idx, one, idx, one), want


# K4 cases: random pools at four capacity pairs (ids ka-kb), crafted
# pairs (lopsided, full, identical, disjoint, one value apart, 0 and 65535
# at the ends; 4095 and 37 are odd capacities, so unaligned containers,
# and their b pool starts 2 bytes past a 16-byte boundary on the card),
# and 200 x 16 pairs of 2,048-value capacity: more than one grid's worth
# of warps.
SPARSE_CASES = {
    "128-128": lambda: random_pair_case(128, 128),
    "4096-256": lambda: random_pair_case(4096, 256),
    "8-4096": lambda: random_pair_case(8, 4096),
    "100-36": lambda: random_pair_case(100, 36),
    "4096-1": lambda: crafted_case("4096-1", 4096),
    "1-4096": lambda: crafted_case("1-4096", 4096),
    "full": lambda: crafted_case("full", 4096),
    "identical": lambda: crafted_case("identical", 4096),
    "disjoint": lambda: crafted_case("disjoint", 4096),
    "one-off": lambda: crafted_case("one-off", 4096),
    "ends": lambda: crafted_case("ends", 4096),
    "one-off-odd-k": lambda: crafted_case("one-off", 4095),
    "ends-odd-k": lambda: crafted_case("ends", 37),
    "200x16": lambda: random_pair_case(2048, 2048, s=200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_pair_kernel(card, case):
    args, truth = SPARSE_CASES[case]()
    want = tk.sparse_pair_count(*args)
    if truth is None:
        assert want.sum() > 0
    else:
        assert torch.equal(want, truth)
    on_card = [t.to(card) for t in args]
    if case.endswith("odd-k"):
        b = on_card[2]
        flat = torch.empty(b.numel() + 1, dtype=b.dtype, device=card)
        flat[1:] = b.reshape(-1)
        on_card[2] = flat[1:].view(b.shape)
        assert on_card[2].data_ptr() % 16 == 2
    before = tk.LAUNCHES["sparse_pair_count"]
    got = tk.sparse_pair_count(*on_card)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["sparse_pair_count"] == before + 1
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


@pytest.mark.cuda
def test_probe_add_kernel(card):
    ramp = torch.arange(1024, dtype=torch.int32).reshape(8, 128)
    got = tk.probe_add(ramp.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ramp + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("t", tk.BLOCK_SLICES)
@pytest.mark.parametrize("tree", range(len(TREES)))
def test_coarse_count_blocked_kernel(card, t, tree):
    tree = TREES[tree]
    n = nleaves(tree)
    s = 64
    rng = np.random.default_rng(100 + t)
    ps = tuple(words(rng, (s, RUNS * 16, 2048)) for _ in range(n))
    starts = torch.from_numpy(rng.integers(-1, RUNS, size=n).astype(np.int32))
    starts[0] = 1  # at least one leaf present
    want = tk.coarse_count_blocked(ps, starts, tree, t)
    before = tk.LAUNCHES["coarse_count_blocked"]
    got = tk.coarse_count_blocked(tuple(p.to(card) for p in ps),
                                  starts.to(card), tree, t)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["coarse_count_blocked"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 4097, 3 * 2048 * 33 + 2])
def test_stream_popcount_kernel(card, n):
    rng = np.random.default_rng(n)
    pool = torch.from_numpy(rng.integers(0, 1 << 32, size=n,
                                         dtype=np.uint32).view(np.int32))
    want = tk.stream_plain(pool)
    got = tk.stream_popcount(pool.to(card))
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and int(got) == int(want)
    ones = torch.full((5, 32, 2048), -1, dtype=torch.int32, device=card)
    assert int(tk.stream_popcount(ones)) == ones.numel() * 32
