"""The CUDA kernels (K0-K7, and the sector probe) against their plain
PyTorch versions, on a card.

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


def to_card(cpu_pools, card):
    """The pools on the card, each distinct tensor copied once (leaves
    may share a pool)."""
    moved = {}
    return tuple(moved.setdefault(id(p), p.to(card)) for p in cpu_pools)


def check(fn, cpu_pools, args, tree, card, *extra):
    """fn on the card equals its plain version on the CPU exactly, and two
    launches give equal results."""
    want = fn(cpu_pools, *args, tree, *extra)
    dev_pools, dev_args = to_card(cpu_pools, card), [a.to(card) for a in args]
    got = [fn(dev_pools, *dev_args, tree, *extra) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want), fn.__name__
    assert torch.equal(got[1].cpu(), want), fn.__name__


def sms(card) -> int:
    return torch.cuda.get_device_properties(card).multi_processor_count


L = [["leaf", i] for i in range(80)]
OR29 = ["or"] + L[:29]
MIXED80 = ["andnot", ["or"] + L[:40], ["and"] + L[40:80]]
DEEP8 = ["and", L[0], ["or", L[1], ["andnot", L[2], ["and", L[3], [
    "or", L[4], ["andnot", L[5], ["and", L[6], L[7]]]]]]]]
# K1 beyond the four TREES at S = 5: (tree, slices, queries), the slices
# given against the card's SM count so that S * B lands just under or
# just over it (the tile planner's chunk count changes there), and
# trees of 29 and 80 leaves and of depth 8. Starts are drawn with
# absent leaves (-1) mixed in.
COARSE_CASES = {
    "s-under-sms": (TREES[3], lambda n: n - 1, 1),
    "s-over-sms": (TREES[0], lambda n: n + 1, 1),
    "sb-under-sms": (TREES[1], lambda n: n // 16, 16),
    "sb-over-sms": (TREES[2], lambda n: n // 16 + 1, 16),
    "29-leaves-over-sms": (OR29, lambda n: n + 1, 1),
    "80-leaves": (MIXED80, lambda n: 24, 1),
    "deep8": (DEEP8, lambda n: 7, 3),
    "headline-960": (TREES[0], lambda n: 960, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [*range(len(TREES)), *COARSE_CASES])
def test_coarse_kernels(card, t):
    if t in COARSE_CASES:
        tree, slices, batch = COARSE_CASES[t]
        s, seed = slices(sms(card)), 60 + list(COARSE_CASES).index(t)
    else:
        tree, s, batch, seed = TREES[t], S, 3, t
    n = nleaves(tree)
    rng = np.random.default_rng(seed)
    base = pools(seed, min(n, 3), s)
    ps = tuple(base[i % len(base)] for i in range(n))
    table = torch.from_numpy(
        rng.integers(-1, RUNS, size=(batch * n, s)).astype(np.int32))
    scalars = torch.from_numpy(
        rng.integers(-1, RUNS, size=batch * n).astype(np.int32))
    scalars[0] = table[0, 0] = 1  # the first leaf present
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
@pytest.mark.parametrize("slices", ["5", "sms-1", "96", "sms+1"])
@pytest.mark.parametrize("n", [7, 29])
def test_coarse_kernels_over_a_time_cover(card, n, slices):
    """K1 as a time Range of n views runs it: the OR of n optional leaves
    in the planner's canonical form, each leaf its own pool (one staged
    day view a leaf), with uniform and per-slice starts, at 5 slices, at
    the time path's 96 and just under and over the card's SM count."""
    from pilosa_tpu_torch.parallel.plan import canonical_tree

    s = {"sms-1": sms(card) - 1, "sms+1": sms(card) + 1}.get(slices)
    s = s or int(slices)
    tree = canonical_tree(["or"] + [["leaf"]] * n,
                          [("f", f"standard_{d}", 1, False)
                           for d in range(n)], [])
    rng = np.random.default_rng(40 + n + s)
    base = pools(40 + n, 3, s)
    ps = tuple(base[d % 3].clone() for d in range(n))
    scalars = torch.from_numpy(
        rng.integers(-1, RUNS, size=n).astype(np.int32))
    table = torch.from_numpy(
        rng.integers(-1, RUNS, size=(n, s)).astype(np.int32))
    check(tk.coarse_count_uniform, ps, (scalars,), tree, card)
    check(tk.coarse_count_per_slice, ps, (table,), tree, card)


# K3 cases: (tree, queries), each at every slice count of K3_SLICES (5,
# the time path's 96, the headline's 960, and just under and over the
# card's SM count, where the tile planner's chunk count changes): the
# four TREES, 29- and 80-leaf trees, one of depth 8, and a batch that
# tree_count_per_slice splits into launches of MAX_BATCH queries.
K3_TREES = {**{str(t): (tree, 4) for t, tree in enumerate(TREES)},
            "or29": (OR29, 2), "mixed80": (MIXED80, 1), "deep8": (DEEP8, 3),
            "split": (TREES[0], tk.MAX_BATCH + 4)}
K3_SLICES = ["5", "sms-1", "96", "sms+1", "960"]


def card_pools(seed: int, n: int, s: int, card):
    """n random (s, RUNS * 16, 2048) int32 pools made on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randint(-2**31, 2**31, (s, RUNS * 16, 2048),
                               dtype=torch.int32, device=card, generator=gen)
                 for _ in range(n))


@pytest.mark.cuda
@pytest.mark.parametrize("slices", K3_SLICES)
@pytest.mark.parametrize("t", sorted(K3_TREES))
def test_tree_count_kernel(card, t, slices):
    """K3 against its plain versions on the same card tensors, given a
    gathered (B, L, S, 16) idx/hit (tree_count_per_slice, which passes
    it as B x L index rows) and rows of per-leaf container index tables
    (tree_count_rows), with absent containers, leaves absent in some
    slices and absent leaves."""
    tree, batch = K3_TREES[t]
    s = {"sms-1": sms(card) - 1, "sms+1": sms(card) + 1}.get(slices)
    s = s or int(slices)
    n = nleaves(tree)
    seed = 20 + sorted(K3_TREES).index(t)
    base = card_pools(seed, min(n, 3), s, card)
    ps = tuple(base[i % len(base)] for i in range(n))
    gen = torch.Generator(device=card).manual_seed(seed + s)

    def rand(shape, hi):
        return torch.randint(0, hi, shape, dtype=torch.int32, device=card,
                             generator=gen)

    idx = rand((batch, n, s, 16), RUNS * 16)
    hit = (rand((batch, n, s, 16), 10) < 7).to(torch.int32)
    for _ in range(2):
        before = tk.LAUNCHES["tree_count"]
        got = tk.tree_count_per_slice(ps, idx, hit, tree)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["tree_count"] == before + -(-batch //
                                                       tk.MAX_BATCH)
        assert torch.equal(got, tk.tree_plain(ps, idx, hit, tree))
    batch = min(batch, tk.MAX_BATCH)
    tables = []
    for _ in range(n):
        tab = rand((3, s, 16), RUNS * 16)
        tab[rand((3, s, 16), 10) < 3] = -1
        tab[0, :, 0] = -1            # a row missing its first container
        tab[1, s // 2] = -1          # a row absent from one slice
        tables.append(tab.contiguous())
    rng = np.random.default_rng(seed)
    picks = rng.integers(-1, 3, size=(batch, n)).tolist()
    picks[0][0] = 0
    rows = [[tables[l][r] if r >= 0 else None for l, r in enumerate(req)]
            for req in picks]
    before = tk.LAUNCHES["tree_count"]
    got = tk.tree_count_rows(ps, rows, tree)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tree_count"] == before + 1
    want = tk.rows_plain(ps, rows, tree)
    assert torch.equal(got, want)
    assert (want > 0).any()


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


def day_pair_case(s=3):
    """Two day views of a time cover, as the 2-day Range pairs them: a
    pool each of 4 rows x 16 containers, every bit set with p = 1/64,
    the pair reading row 1 (containers 16-31) of both."""
    rng = np.random.default_rng(64)
    sides, bits = [], []
    for _ in range(2):
        b = rng.random((s, 64, 65536)) < 1 / 64
        cards = b.sum(axis=2).astype(np.int32)
        vals = np.full((s, 64, int(cards.max())), 0xFFFF, dtype=np.uint16)
        for i in range(s):
            for j in range(64):
                vals[i, j, :cards[i, j]] = np.flatnonzero(b[i, j])
        sides += [torch.from_numpy(vals.view(np.int16)),
                  torch.from_numpy(cards)]
        bits.append(b)
    idx = torch.arange(16, 32, dtype=torch.int32).repeat(s, 1)
    one = torch.ones((s, 16), dtype=torch.int32)
    want = (bits[0][:, 16:32] & bits[1][:, 16:32]).sum(axis=2)
    return (*sides, idx, one, idx, one), torch.from_numpy(
        want.astype(np.int32))


# K4 cases: random pools at four capacity pairs (ids ka-kb), crafted
# pairs (lopsided, full, identical, disjoint, one value apart, 0 and 65535
# at the ends; 4095 and 37 are odd capacities, so unaligned containers,
# and their b pool starts 2 bytes past a 16-byte boundary on the card),
# 200 x 16 pairs of 2,048-value capacity: more than one grid's worth
# of warps, and two day views of a time cover.
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
    "day-pair": day_pair_case,
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


BLOCKED_TREES = [*TREES, OR29, MIXED80]


@pytest.mark.cuda
@pytest.mark.parametrize("t", tk.BLOCK_SLICES)
@pytest.mark.parametrize("tree", range(len(BLOCKED_TREES)))
def test_coarse_count_blocked_kernel(card, t, tree):
    tree = BLOCKED_TREES[tree]
    n = nleaves(tree)
    s = 64
    rng = np.random.default_rng(100 + t)
    base = [words(rng, (s, RUNS * 16, 2048)) for _ in range(min(n, 4))]
    ps = tuple(base[i % len(base)] for i in range(n))
    starts = torch.from_numpy(rng.integers(-1, RUNS, size=n).astype(np.int32))
    starts[0] = 1  # at least one leaf present
    want = tk.coarse_count_blocked(ps, starts, tree, t)
    before = tk.LAUNCHES["coarse_count_blocked"]
    dev = to_card(ps, card)
    got = [tk.coarse_count_blocked(dev, starts.to(card), tree, t)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert tk.LAUNCHES["coarse_count_blocked"] == before + 2
    assert torch.equal(got[0].cpu(), want) and torch.equal(got[1].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("s", [960, 3072])
def test_coarse_count_blocked_kernel_at_the_probe_sizes(card, t, s):
    """K6 over the probe's pools (a pair over cap 32) at its two slice
    counts, against its plain version on the card: T = 1 keeps whole
    runs, T = 32 cuts them into the most chunks."""
    gen = torch.Generator(device=card).manual_seed(s + t)
    pool = torch.randint(-2**31, 2**31, (s, 32, 2048), dtype=torch.int32,
                         device=card, generator=gen)
    starts = torch.tensor([0, 1], dtype=torch.int32, device=card)
    tree = TREES[t % 3]
    want = tk.coarse_plain((pool, pool), starts, True, tree, 1)
    got = [tk.coarse_count_blocked((pool, pool), starts, tree, t)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b_kind", ["none", "row", "block"])
def test_pair_count_rows_at_the_topn_shape(card, b_kind):
    """K5 at the TopN configuration's shape: 4096 rows, one container
    per row per slice (10% absent), against its plain version."""
    rng = np.random.default_rng(4096 + len(b_kind))
    s, rows = 4, 4096
    pool = words(rng, (s, rows, 2048)).to(card)
    a_idx = np.full((rows, s, 16), -1, dtype=np.int32)
    a_idx[:, :, 0] = np.arange(rows)[:, None]
    a_idx[rng.random((rows, s)) < 0.1, 0] = -1
    a_idx = torch.from_numpy(a_idx).to(card)
    kw = {}
    if b_kind == "row":
        kw = {"b_pool": pool, "b_idx": a_idx[7]}
    elif b_kind == "block":
        kw = {"b_block": words(rng, (s, 16, 2048)).to(card)}
    before = tk.LAUNCHES["pair_count"]
    got = tk.pair_count_rows(pool, a_idx, "and", **kw)
    want = tk.pair_rows_plain(pool, a_idx, "and", kw.get("b_pool"),
                              kw.get("b_idx"), kw.get("b_block"))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["pair_count"] == before + 1
    assert torch.equal(got.cpu(), want.cpu()) and int(want.sum()) > 0


@pytest.mark.cuda
def test_row_counts_chunk_past_one_launch(card, tmp_path):
    """A view of 70,000 rows (one launch takes 65,535): two launches,
    and every row's count equals what was written (r % 5 + 1 bits)."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel import serve as tserve

    n_rows = 70_000
    rows = np.repeat(np.arange(n_rows), np.arange(n_rows) % 5 + 1)
    cols = np.concatenate([np.arange(k % 5 + 1) * 7 for k in range(n_rows)])
    h = Holder(str(tmp_path))
    h.open()
    try:
        frag = h.create_index("i").create_frame("f").create_view_if_not_exists(
            "standard").create_fragment_if_not_exists(0)
        frag.import_bits(rows, cols)
        mgr = Executor(h, device=card).mesh_manager()
        ids, counts = mgr.row_counts("i", "f", "standard", [0], 1)
        torch.cuda.synchronize()
        assert mgr.stats["kernel:pair_count_rows"] == -(
            -n_rows // tserve.MAX_ROWS_PER_LAUNCH) == 2
        assert ids.tolist() == list(range(n_rows))
        assert counts.tolist() == (np.arange(n_rows) % 5 + 1).tolist()
    finally:
        h.close()


# -- K7 apply_writes -----------------------------------------------------------

# (S, cap, B, live targets a slice): padding past `live`, a single
# slice, a full batch with no padding, and the bulk shapes of the
# headline's 960 slices (one block and four blocks a slice).
SCATTER_CASES = [(1, 16, 8, 3), (5, 48, 64, 40), (37, 16, 256, 256),
                 (3, 32, 1024, 700), (960, 16, 1024, 1000),
                 (960, 32, 4096, 4000)]


def scatter_batches(seed: int, s: int, cap: int, b: int, live: int):
    """int32 (S, B) slot / word / set / clear tensors on the CPU: `live`
    unique targets a slice, the rest padding at slot = cap; one word of
    slice 0 both set and cleared, and two entries past the word range
    and below slot 0, which drop."""
    rng = np.random.default_rng(seed)
    slot = np.full((s, b), cap, dtype=np.int32)
    word = np.zeros((s, b), dtype=np.int32)
    for si in range(s):
        flat = rng.choice(cap * 2048, size=live, replace=False)
        slot[si, :live], word[si, :live] = flat // 2048, flat % 2048
    sm = rng.integers(0, 1 << 32, size=(s, b), dtype=np.uint32)
    cm = rng.integers(0, 1 << 32, size=(s, b), dtype=np.uint32)
    sm[0, 0], cm[0, 0] = 0x0000FFFF, 0xFFFF0000
    if live + 2 <= b:
        slot[0, live], word[0, live] = 0, 2048
        slot[0, live + 1] = -1
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 for a in (slot, word, sm, cm))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_apply_writes_kernel(card, case):
    s, cap, b, live = case
    rng = np.random.default_rng(b)
    words = torch.from_numpy(rng.integers(
        0, 1 << 32, size=(s, cap, 2048), dtype=np.uint32).view(np.int32))
    batch = scatter_batches(b, s, cap, b, live)
    ref = words.clone()
    want = tk.scatter_plain(words.clone(), *batch)
    before = tk.LAUNCHES["apply_writes"]
    dev = words.to(card)
    got = tk.scatter_words(dev, *(t.to(card) for t in batch))
    torch.cuda.synchronize()
    assert got is dev and tk.LAUNCHES["apply_writes"] == before + 1
    assert torch.equal(dev.cpu(), want)
    assert not torch.equal(want, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 100_000])
def test_sector_probe_kernel(card, n):
    """The scattered read-modify-write probe against its plain version:
    unique random offsets over a (960, 16, 2048) pool."""
    gen = torch.Generator(device=card).manual_seed(n)
    words = torch.randint(-2**31, 2**31, (960, 16, 2048), dtype=torch.int32,
                          device=card, generator=gen)
    offs = torch.randperm(words.numel(), device=card, generator=gen)[:n]
    want = tk.sector_probe_plain(words.clone(), offs, 0x80000001)
    got = tk.sector_probe(words, offs, 0x80000001)
    torch.cuda.synchronize()
    assert got is words and torch.equal(words, want)


@pytest.mark.cuda
def test_scatter_is_ordered_after_queued_counts(card):
    """K2 batches queued on a pool before a scatter read the words as
    they were; one queued after reads them as written. All run on the
    one stream, with no synchronize between them."""
    tree, n = TREES[3], nleaves(TREES[3])
    ps = pools(77, 1)
    pool = ps[0].to(card)
    table = torch.zeros((1, S), dtype=torch.int32)
    leaf_map = tuple(tuple(0 for _ in range(n)) for _ in range(16))
    # Every word of run 0 (slots 0-15) of every slice: set the low half,
    # clear the high half.
    slots = torch.arange(16, dtype=torch.int32).repeat_interleave(2048)
    words = torch.arange(2048, dtype=torch.int32).repeat(16)
    batch = [slots.repeat(S, 1), words.repeat(S, 1),
             torch.full((S, slots.numel()), 0x0000FFFF, dtype=torch.int32),
             torch.full((S, slots.numel()), -65536, dtype=torch.int32)]
    want_before = tk.coarse_count_batch_per_slice(ps, table, tree, leaf_map)
    after_cpu = tk.scatter_plain(ps[0].clone(), *batch)
    want_after = tk.coarse_count_batch_per_slice((after_cpu,), table, tree,
                                                 leaf_map)
    dev_table = table.to(card)
    queued = [tk.coarse_count_batch_per_slice((pool,), dev_table, tree,
                                              leaf_map) for _ in range(8)]
    tk.scatter_words(pool, *(t.contiguous().to(card) for t in batch))
    after = tk.coarse_count_batch_per_slice((pool,), dev_table, tree,
                                            leaf_map)
    torch.cuda.synchronize()
    assert all(torch.equal(r.cpu(), want_before) for r in queued)
    assert torch.equal(after.cpu(), want_after)
    assert not torch.equal(want_before, want_after)


@pytest.mark.cuda
def test_refresh_scatters_writes_on_the_card(card, tmp_path):
    """Writes into existing containers reach the staged view as one K7
    launch a refresh; a new row restages. Counts equal the host's."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index("i").create_frame("f")
        view = f.create_view_if_not_exists("standard")
        rng = np.random.default_rng(3)
        cols = rng.choice(3 << 20, size=20000, replace=False)
        for s in range(3):  # rows 0 and 1 hold the same columns
            c = cols[(cols >> 20) == s]
            view.create_fragment_if_not_exists(s).import_bits(
                np.repeat([0, 1], c.size), np.tile(c, 2))
        # Threshold 0: dense, the image a scatter serves (sorted-array
        # views restage).
        ex = Executor(h, device=card, sparse_density_threshold=0)
        pql = parse_string("Count(Intersect(Bitmap(rowID=0, frame=f), "
                           "Bitmap(rowID=1, frame=f)))")
        assert ex.execute("i", pql)[0] == 20000
        mgr = ex.mesh_manager()
        before = tk.LAUNCHES["apply_writes"]
        for c in cols[:50]:
            f.clear_bit(1, int(c))
        assert ex.execute("i", pql)[0] == 19950
        assert tk.LAUNCHES["apply_writes"] == before + 1
        assert mgr.stats["incremental"] == 1 and mgr.stats["stage"] == 1
        f.set_bit(5, 1)
        assert ex.execute("i", parse_string(
            "Count(Bitmap(rowID=5, frame=f))"))[0] == 1
        assert mgr.stats["stage"] == 2
        assert tk.LAUNCHES["apply_writes"] == before + 1
    finally:
        h.close()


# -- the card-memory governor --------------------------------------------------


def dense_frame(holder, index: str, frame: str, rows: int, slices: int,
                seed: int) -> np.ndarray:
    """Frame `frame` of `index`: `rows` random rows in all 16 containers
    of every slice, injected as whole storage images. Returns the words
    (S, rows, 16, 1024) uint64."""
    from pilosa_tpu_torch.roaring import Bitmap, Container

    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**64, size=(slices, rows, 16, 1024),
                         dtype=np.uint64)
    view = holder.create_index_if_not_exists(index) \
        .create_frame_if_not_exists(frame).create_view_if_not_exists(
            "standard")
    for s in range(slices):
        bm = Bitmap()
        for r in range(rows):
            for b in range(16):
                bm.keys.append(r * 16 + b)
                bm.containers.append(Container(bitmap=words[s, r, b]))
        view.create_fragment_if_not_exists(s).replace(bm)
    return words


def pair_pql(frame: str) -> str:
    return (f"Count(Intersect(Bitmap(rowID=0, frame={frame}), "
            f"Bitmap(rowID=1, frame={frame})))")


def pair_truth(words: np.ndarray) -> int:
    return int(np.bitwise_count(words[:, 0] & words[:, 1]).sum())


@pytest.mark.cuda
def test_real_oom_recovered_then_answered_on_the_host(card, tmp_path):
    """A genuine torch.cuda.OutOfMemoryError while staging: with frames a
    and b resident and a ballast leaving less free memory than frame g
    needs but enough once they go, the ladder evicts them and stages g
    on its retry; with only a resident and too little free even without
    it, the ladder evicts it, fails again, and the host answers. Both
    answers equal numpy; no fault is injected."""
    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    ballast = []
    try:
        words = {f: dense_frame(h, "i", f, rows, 64, seed) for f, rows, seed
                 in (("a", 4, 1), ("b", 4, 2), ("g", 8, 3))}
        ex = Executor(h, device=card, mesh_config={"hbm_budget_bytes": -1})
        mgr = ex.mesh_manager()

        def count(f):
            return ex.execute("i", parse_string(pair_pql(f)))[0]

        fired0 = dict(fault.STATS)
        torch.cuda.empty_cache()
        assert count("a") == pair_truth(words["a"])
        assert count("b") == pair_truth(words["b"])
        need = 64 * 8 * 16 * 2048 * 4  # g's pool: 64 slices x 128 slots
        resident = mgr.stats["staged_bytes"]
        ballast += fault.fill_cache(card)
        free = torch.cuda.mem_get_info(card)[0]
        ballast.append(torch.empty(free - need // 2, dtype=torch.uint8,
                                   device=card))
        assert torch.cuda.mem_get_info(card)[0] < need <= (
            torch.cuda.mem_get_info(card)[0] + resident)
        assert count("g") == pair_truth(words["g"])
        assert mgr.stats["oom_retries"] == 1 and mgr.stats["evicted_oom"] == 2
        assert mgr.stats["fallback_oom"] == 0 and mgr.stats["count"] == 3
        ballast.clear()
        ex.invalidate_device_index()
        torch.cuda.empty_cache()
        assert count("a") == pair_truth(words["a"])
        resident = mgr.stats["staged_bytes"]
        ballast += fault.fill_cache(card)
        free = torch.cuda.mem_get_info(card)[0]
        ballast.append(torch.empty(free - (need - resident) // 2,
                                   dtype=torch.uint8, device=card))
        assert count("g") == pair_truth(words["g"])
        assert mgr.stats["oom_retries"] == 2 and mgr.stats["evicted_oom"] == 3
        assert mgr.stats["fallback_oom"] == 1 and mgr.stats["count"] == 4
        assert ex.stats["count_host"] == 1
        assert dict(fault.STATS) == fired0
    finally:
        ballast.clear()
        h.close()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_delete_frees_view_memory_on_the_card(card, tmp_path):
    """DELETE /index/d/frame/f answers 200 {}, and memory_allocated drops
    by the view's bytes within 1 MB while /debug/vars counts one view
    fewer."""
    from pilosa_tpu_torch.api.handler import Handler
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor

    h = Holder(str(tmp_path))
    h.open()
    try:
        words = dense_frame(h, "d", "f", 4, 64, 5)
        dense_frame(h, "e", "f", 2, 8, 6)
        handler = Handler(h, Executor(h, device=card))
        for index, want in (("e", None), ("d", pair_truth(words))):
            resp = handler.handle("POST", f"/index/{index}/query", {}, {},
                                  pair_pql("f").encode())
            assert resp.status == 200
            if want is not None:
                assert resp.json()["results"] == [want]
        mgr = handler.executor.mesh_manager()
        vb = mgr._view_bytes(mgr._views[("d", "f", "standard")])
        views0 = handler.handle("GET", "/debug/vars").json()["mesh"]["hbm"][
            "views"]
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(card)
        resp = handler.handle("DELETE", "/index/d/frame/f")
        assert (resp.status, resp.json()) == (200, {})
        torch.cuda.synchronize()
        assert abs(m0 - torch.cuda.memory_allocated(card) - vb) <= 1 << 20
        assert handler.handle("GET", "/debug/vars").json()["mesh"]["hbm"][
            "views"] == views0 - 1 == 1
    finally:
        h.close()


# -- durability and integrity on the card ----------------------------------------


@pytest.mark.cuda
def test_shadow_verification_on_the_card(card, tmp_path):
    """At 1 in 1, the card's Count (K1), TopN (K5) and Sum answers are
    each held against the host fold with no mismatch; a delta= fault at
    the result seam is served as the host value and quarantines the
    Count's plan."""
    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import SHADOW_STATS, Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    fault.reset()
    try:
        words = dense_frame(h, "i", "f", 4, 3, seed=11)
        ex = Executor(h, device=card, sparse_density_threshold=0,
                      shadow_sample=1)
        q = lambda s: ex.execute("i", parse_string(s))[0]  # noqa: E731
        c0 = SHADOW_STATS.get("checks:mesh", 0)
        m0 = SHADOW_STATS.get("mismatch:mesh", 0)
        assert q(pair_pql("f")) == pair_truth(words)
        top = q("TopN(frame=f, n=2)")
        full = np.bitwise_count(words).sum(axis=(0, 2, 3))
        assert [n for _, n in top] == sorted(full.tolist())[::-1][:2]
        assert SHADOW_STATS.get("checks:mesh", 0) - c0 == 2
        assert SHADOW_STATS.get("mismatch:mesh", 0) == m0
        fault.arm("device.exec", delta=5, kind="count-result")
        assert q(pair_pql("f")) == pair_truth(words)
        assert SHADOW_STATS.get("mismatch:mesh", 0) == m0 + 1
        assert len(ex.mesh_manager().quarantined_plans()) == 1
        assert q(pair_pql("f")) == pair_truth(words)  # on the host now
        assert ex.stats["count_host"] == 1
    finally:
        fault.reset()
        h.close()


@pytest.mark.cuda
def test_background_snapshots_keep_the_staged_image(card, tmp_path):
    """Writes past max_op_n snapshot in the background; no snapshot
    makes the staged view restage (each round is a K7 scatter unless the
    cost gate picks a restage), and the Count equals numpy with the
    writes applied."""
    from pilosa_tpu_torch.core import Holder, WalConfig
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path), wal=WalConfig("group", max_op_n=50))
    h.open()
    try:
        words = dense_frame(h, "i", "f", 2, 2, seed=12)
        ex = Executor(h, device=card, sparse_density_threshold=0)
        pql = parse_string(pair_pql("f"))
        assert ex.execute("i", pql)[0] == pair_truth(words)
        mgr = ex.mesh_manager()
        frag = h.fragment("i", "f", "standard", 0)
        rng = np.random.default_rng(4)
        for _ in range(6):
            for col in rng.choice(1 << 16, 40, replace=False):
                frag.clear_bit(1, int(col))
                words[0, 1, 0, col >> 6] &= ~np.uint64(1 << (col & 63))
            assert ex.execute("i", pql)[0] == pair_truth(words)
        assert frag.wait_snapshot(timeout=30)
        assert frag._snap_gen >= 2
        # Every restage after the first is one the cost gate picked.
        assert mgr.stats["stage"] - 1 == mgr.stats.get(
            "refresh_pick_restage", 0)
        assert mgr.stats["incremental"] + mgr.stats.get(
            "refresh_pick_restage", 0) == 6
    finally:
        h.close()


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_import_then_count_on_the_card(card, tmp_path, threshold):
    """Frame.import_bits of seeded rows (two of sorted-array density, two
    dense), then Counts and a TopN on the card equal the same executor
    on the CPU; a second import into the staged view restages it (its
    mutation log reset) and the answers stay equal."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    try:
        rng = np.random.default_rng(21)
        f = h.create_index("i").create_frame("f")

        def bits(seed):
            r = np.random.default_rng(seed)
            rows, cols = [], []
            for row, n, span in ((0, 2000, SLICE_WIDTH),
                                 (1, 2000, SLICE_WIDTH),
                                 (2, 60000, 1 << 17), (3, 60000, 1 << 17)):
                for s in range(3):
                    c = r.choice(span, n, replace=False) + s * SLICE_WIDTH
                    rows.append(np.full(n, row))
                    cols.append(c)
            return np.concatenate(rows), np.concatenate(cols)

        f.import_bits(*bits(rng.integers(1 << 30)))
        queries = [f"Count(Intersect(Bitmap(rowID={a}, frame=f), "
                   f"Bitmap(rowID={b}, frame=f)))"
                   for a, b in ((0, 1), (2, 3), (0, 2), (3, 1))]
        queries.append("TopN(frame=f, n=4)")
        dev = Executor(h, device=card, sparse_density_threshold=threshold)
        cpu = Executor(h, device="cpu", sparse_density_threshold=threshold)

        def answers(ex):
            return [ex.execute("i", parse_string(q))[0] for q in queries]

        before = sum(tk.LAUNCHES.values())
        assert answers(dev) == answers(cpu)
        assert sum(tk.LAUNCHES.values()) > before
        stage = dev.mesh_manager().stats["stage"]
        f.import_bits(*bits(rng.integers(1 << 30)))
        assert answers(dev) == answers(cpu)
        assert dev.mesh_manager().stats["stage"] > stage
        assert dev.mesh_manager().stats.get("incremental", 0) == 0
    finally:
        h.close()


@pytest.mark.cuda
def test_server_from_a_config_counts_on_the_card(card, tmp_path):
    """A Server built from a Config (use-device auto: the card) answers
    Counts and a Sum equal to the same data under a CPU executor, its
    K0 canary and count kernels launch, and its /metrics shows
    pilosa_hbm_resident_bytes equal to the staged bytes in /debug/vars
    and the configured budget."""
    import re

    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.pql import parse_string
    from pilosa_tpu_torch.server import Server

    cfg = Config.from_toml(
        f'data-dir = "{tmp_path}"\nhost = "127.0.0.1:0"\n'
        "[mesh]\nhbm-budget-bytes = 987654321\n"
        "[integrity]\nshadow-sample-1-in = 1\n"
        '[[schema.indexes]]\nname = "i"\n[[schema.indexes.frames]]\n'
        'name = "f"\n[[schema.indexes.frames.fields]]\nname = "val"\n'
        "min = -100\nmax = 100\n", is_text=True)
    assert cfg.device() == "cuda"
    before = dict(tk.LAUNCHES)
    from pilosa_tpu_torch.executor import SHADOW_STATS

    # SHADOW_STATS is process-wide: a mismatch an earlier test forced
    # (test_shadow_verification_on_the_card) is not this server's.
    mismatch0 = sum(v for k, v in SHADOW_STATS.copy().items()
                    if k.startswith("mismatch:"))
    srv = Server(cfg)
    srv.open(port=0)
    try:
        rng = np.random.default_rng(13)
        h = srv.handler
        body = "".join(
            f"SetBit(rowID={r}, frame=f, columnID={c})"
            for r, c in zip(rng.integers(0, 3, 3000),
                            rng.integers(0, 3 * SLICE_WIDTH, 3000)))
        body += "".join(f"SetValue(frame=f, columnID={c}, val={v})"
                        for c, v in zip(range(0, 3 * SLICE_WIDTH, 9973),
                                        rng.integers(-100, 101, 400)))
        assert h.handle("POST", "/index/i/query",
                        body=body.encode()).status == 200
        queries = ["Count(Intersect(Bitmap(rowID=0, frame=f), "
                   "Bitmap(rowID=1, frame=f)))",
                   "Count(Union(Bitmap(rowID=2, frame=f), "
                   "Bitmap(rowID=1, frame=f)))",
                   'Sum(frame=f, field="val")']
        got = [h.handle("POST", "/index/i/query", body=q.encode()).json()[
            "results"][0] for q in queries]
        cpu = Executor(srv.holder, device="cpu")
        want = [cpu.execute("i", parse_string(q))[0] for q in queries]
        assert got == want
        launched = {k for k, n in tk.LAUNCHES.items() if n > before.get(k, 0)}
        assert {"probe_ok", "pair_count"} <= launched
        text = h.handle("GET", "/metrics").body.decode()
        dv = h.handle("GET", "/debug/vars").json()

        def total(name):
            return sum(float(v) for v in re.findall(
                rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M))

        assert total("pilosa_hbm_resident_bytes") == dv["mesh"][
            "staged_bytes"] > 0
        assert total("pilosa_hbm_budget_bytes") == 987654321
        assert total("pilosa_shadow_mismatch_total") == mismatch0
        assert total("pilosa_shadow_checks_total") >= 3
    finally:
        srv.close()


# -- admission and the query's own record on the card ---------------------------


def _profiled(fn):
    from pilosa_tpu_torch.obs import profile

    prof = profile.QueryProfile(backend="cuda")
    tok = profile.activate(prof)
    try:
        out = fn()
    finally:
        profile.deactivate(tok)
    prof.finish()
    return out, prof


@pytest.mark.cuda
def test_profiled_lone_count_device_exec_on_the_card(card, tmp_path):
    """A profiled lone pair Count's device_exec (the launch to a
    synchronize) lies between K1's own CUDA-event time and the event
    time of K1 plus the readback (with 1 ms for the launch's host side);
    its bytes are the K1 pair's: 2 runs of 16 containers a slice."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel.mesh import combine_counts
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    try:
        s = 96
        words = dense_frame(h, "i", "f", 2, s, seed=21)
        ex = Executor(h, device=card, sparse_density_threshold=0)
        q = parse_string(pair_pql("f"))
        assert ex.execute("i", q)[0] == pair_truth(words)  # stages
        n, prof = _profiled(lambda: ex.execute("i", q)[0])
        assert n == pair_truth(words)
        dev_ms = prof.phase_us("device_exec") / 1e3
        rb_ms = prof.phase_us("readback_d2h") / 1e3
        assert prof.to_dict()["bytes"]["bytes_touched_hbm"] == \
            2 * s * 16 * 2048 * 4
        sv = ex.mesh_manager()._views[("i", "f", "standard")]
        pool = sv.sharded.words
        starts = torch.tensor([sv.layout(0).uniform, sv.layout(1).uniform],
                              dtype=torch.int32, device=card)
        mask = torch.ones(s, dtype=torch.int64, device=card)
        tree = ["and", ["leaf", 0], ["leaf", 1]]
        kern, whole = [], []
        for _ in range(20):
            a, b, c = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            a.record()
            per = tk.coarse_count_uniform((pool, pool), starts, tree)
            b.record()
            combine_counts(per, mask)
            c.record()
            c.synchronize()
            kern.append(a.elapsed_time(b))
            whole.append(a.elapsed_time(c))
        assert 0.8 * min(kern) <= dev_ms, (dev_ms, kern)
        assert dev_ms <= float(np.median(whole)) + 1.0, (dev_ms, whole)
        assert rb_ms > 0
        rf = prof.roofline()
        assert rf["engine"] == "device"
        if rf["fraction_of_peak"] is not None:
            assert 0 < rf["fraction_of_peak"] <= 1.0
    finally:
        h.close()


@pytest.mark.cuda
def test_unprofiled_count_adds_no_synchronize(card, tmp_path, monkeypatch):
    """Without a profile, a staged Count (lone and through the handler's
    admission, trace and cost account) calls torch.cuda.synchronize
    nowhere; with one, the launch synchronizes once."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.server import build_handler

    h = Holder(str(tmp_path))
    h.open()
    try:
        words = dense_frame(h, "i", "f", 2, 8, seed=22)
        hd = build_handler(h, card, 0)
        from pilosa_tpu_torch.sched import QueryScheduler

        hd.scheduler = QueryScheduler()
        body = pair_pql("f").encode()
        assert hd.handle("POST", "/index/i/query", body=body).json()[
            "results"] == [pair_truth(words)]
        calls = []
        real = torch.cuda.synchronize
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: (calls.append(1), real(*a, **k)))
        for _ in range(5):
            assert hd.handle("POST", "/index/i/query", body=body).status \
                == 200
        assert calls == []
        r = hd.handle("POST", "/index/i/query", {"profile": "true"}, {},
                      body)
        assert r.json()["profile"]["phases_us"]["device_exec"] > 0
        assert len(calls) == 1
        hd.scheduler.close()
    finally:
        h.close()


@pytest.mark.cuda
def test_peak_bandwidth_of_the_card(card):
    """The roofline's peak is the card's own by name: 3.35e12 B/s on an
    NVIDIA H100 80GB HBM3, none for a card the table does not hold."""
    from pilosa_tpu_torch.obs import profile

    name = torch.cuda.get_device_name()
    want = {"NVIDIA H100 80GB HBM3": 3.35e12}.get(name)
    assert profile.peak_bytes_per_s("cuda") == want
    assert profile.DEVICE_PEAK_BYTES_PER_S.get(name) == want
