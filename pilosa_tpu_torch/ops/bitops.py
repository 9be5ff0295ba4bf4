"""Bitwise folds and the plain popcount over int32 word tensors, and the
plain counts over sorted-array containers.

Pools hold uint32 words reinterpreted as int32: torch has no uint32
`~` or `>>`, and its int32 `>>` is arithmetic. Every function here is
exact under that reinterpretation; the CUDA kernels read the same bits
as uint32 (and the sorted-array values as uint16).
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


# K5's op codes (csrc/pair_count.cu).
PAIR_OPS = {"and": 0, "or": 1, "xor": 2, "andnot": 3}


def pair_op(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <op> b for op in PAIR_OPS. 0 op 0 is 0 for all four."""
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "andnot":
        return a & ~b
    raise ValueError(f"unknown pair op {op!r}")


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element set-bit count of int32 words (torch has no popcount
    op). Split into 16-bit halves so no intermediate overflows int32."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


# -- sorted-array (roaring array-container) counts ----------------------------
#
# Containers staged as sorted u16 value lists (parallel/mesh.py
# build_sparse_sharded_index), the counterpart of
# pilosa_tpu/ops/bitops.py:75-161:
#   vals (..., K) sorted ascending within the first `len` entries, padded
#        with 0xFFFF; any integer dtype holding the u16 bits (the pools
#        hold them as int16, so values >= 32768 read negative there);
#   lens (...,)   real cardinality per container.
# 65535 is a legal value and also the pad: membership comes from the
# lengths, never from the pad value.


def as_u16(v: torch.Tensor) -> torch.Tensor:
    """The u16 values held in `v`'s low 16 bits, as int32 (so int16 pool
    values sort as unsigned)."""
    return v.to(torch.int32) & 0xFFFF


def u16_bits(v: torch.Tensor) -> torch.Tensor:
    """The u16 values of `v` (0..65535) as the int16 tensor holding their
    bits, the pools' value dtype."""
    v = as_u16(v)
    return (v - ((v & 0x8000) << 1)).to(torch.int16)


def sparse_pair_intersect_counts(a_vals, a_len, b_vals, b_len):
    """Per-container |a ∩ b| of batched sorted-array containers: a batched
    searchsorted of a's values into b's, a gather, and the `pos < len_b`
    and `arange < len_a` masks. Returns (...,) int32."""
    ka, kb = a_vals.shape[-1], b_vals.shape[-1]
    a = as_u16(a_vals).contiguous()
    b = as_u16(b_vals).contiguous()
    pos = torch.searchsorted(b, a)
    bm = torch.gather(b, -1, pos.clamp(max=kb - 1))
    valid_a = torch.arange(ka, device=a.device) < a_len[..., None]
    hit = (bm == a) & (pos < b_len[..., None]) & valid_a
    return hit.sum(dim=-1, dtype=torch.int32)


def sparse_probe_intersect_counts(a_vals, a_len, b_words):
    """Per-container |a ∩ b| of sorted-array containers a against
    packed-word containers b: (..., CONTAINER_WORDS) int32 words, zero
    where the container is absent. Each a value probes one word and one
    bit; padding probes land on word 2047 and are masked by the length.
    Returns (...,) int32."""
    a = as_u16(a_vals)
    w = torch.gather(b_words, -1, (a >> 5).long())
    bit = (w >> (a & 31)) & 1
    valid_a = torch.arange(a.shape[-1], device=a.device) < a_len[..., None]
    return (bit * valid_a).sum(dim=-1, dtype=torch.int32)


def sparse_op_counts(op: str, inter, na, nb):
    """Per-container set-op cardinality from |a∩b| and the operand
    cardinalities, by inclusion-exclusion. na/nb must be zero for absent
    containers, and inter is then zero too."""
    if op == "and":
        return inter
    if op == "or":
        return na + nb - inter
    if op == "andnot":
        return na - inter
    if op == "xor":
        return na + nb - 2 * inter
    raise ValueError(f"unknown sparse op: {op!r}")
