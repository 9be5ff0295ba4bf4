"""The CUDA count kernels against their plain PyTorch versions, on a card.

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
