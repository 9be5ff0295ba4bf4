"""Bitwise folds and the plain popcount over int32 word tensors.

Pools hold uint32 words reinterpreted as int32: torch has no uint32
`~` or `>>`, and its int32 `>>` is arithmetic. Every function here is
exact under that reinterpretation; the CUDA kernels read the same bits
as uint32.
"""

from __future__ import annotations

import torch


def fold_tree(tree, leaf_fn):
    """Fold a numbered op-shape tree (plan._tree_signature) over
    `leaf_fn(leaf_index) -> tensor` with the n-ary left-fold semantics
    shared by every backend and by the CUDA kernels' accumulator-form
    programs (ops.kernels.tree_program, csrc/fold.cuh)."""
    if tree[0] == "leaf":
        return leaf_fn(tree[1])
    vals = [fold_tree(c, leaf_fn) for c in tree[1:]]
    acc = vals[0]
    for v in vals[1:]:
        if tree[0] == "and":
            acc = acc & v
        elif tree[0] == "or":
            acc = acc | v
        else:  # andnot
            acc = acc & ~v
    return acc


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element set-bit count of int32 words (torch has no popcount
    op). Split into 16-bit halves so no intermediate overflows int32."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)
