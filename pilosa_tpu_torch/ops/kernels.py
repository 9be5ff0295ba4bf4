"""The count kernels: CUDA C++ for Hopper (csrc/), each beside its plain
PyTorch version.

Three kernels serve the dense Count path, one the sorted-array pairs,
one the integer-field plane counts and one the boot canary, and the
wrappers keep the names and argument order of the Pallas functions they
replace (pilosa_tpu/ops/kernels.py):

  K0 probe_ok (csrc/probe_ok.cu): probe_ok, for pallas_probe_ok;
  K1 coarse_count (csrc/coarse_count.cu): coarse_count_per_slice,
     coarse_count_identity_batch, coarse_count_uniform,
     coarse_count_uniform_batch, on the tiled fold of
     csrc/coarse_tiles.cuh (tiles planned by coarse_tiles);
  K2 coarse_count_shared (csrc/coarse_count_shared.cu):
     coarse_count_batch_per_slice, coarse_count_shared_uniform;
  K3 tree_count (csrc/tree_count.cu): tree_count_rows, over rows of
     container index tables kept on the card, and tree_count_per_slice /
     tree_count_pallas, which pass it a gathered index, on the tiled fold
     of csrc/coarse_tiles.cuh;
  K4 sparse_pair_count (csrc/sparse_pair_count.cu): sparse_pair_count
     over two sorted-array pools, and pallas_sparse_pair_counts with the
     Pallas function's flat contract;
  K5 pair_count (csrc/pair_count.cu): pair_count, for _pallas_pair_count
     / fused_pair_count, and pair_count_rows, its serving form over row
     runs of a staged pool.
  K6 coarse_count_blocked (csrc/coarse_count_blocked.cu):
     coarse_count_blocked, for the bandwidth probe's T-blocked
     coarse_count_uniform (tools/probe_r5_bw.py:82) on K1's tiled fold,
     and stream_popcount,
     the whole-pool popcount that probe takes as its ceiling. Both serve
     the probe tools (pilosa_tpu_torch/tools/), not the serving path.
  K7 apply_writes (csrc/apply_writes.cu): scatter_words, the write
     scatter into a staged pool, for the XLA program
     compile_serve_apply_writes (pilosa_tpu/parallel/mesh.py:1997), no
     Pallas call. It updates the pool in place. sector_probe
     (csrc/sector_probe.cu) measures its ceiling, the card's scattered
     read-modify-write rate; it serves no path.

Pools are (S, cap, 2048) int32 tensors holding uint32 words, and
sorted-array pools (S, C, K) int16 tensors holding u16 values. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
its kernel or raises. The tree reaches a kernel as an accumulator-form
program (tree_program, csrc/fold.cuh) of at most MAX_LEAVES leaves and
depth MAX_DEPTH.
LAUNCHES counts kernel launches per kernel, and only launches; not those
made inside uncounted(), the start-up check's (ops.calibrate), which
compare kernels with their plain versions and serve nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from ..roaring import ARRAY_MAX_SIZE
from .bitops import (PAIR_OPS, fold_tree, pair_op, popcount,
                     sparse_pair_intersect_counts, u16_bits)
from .cuda_build import kernel_fn
from .pool import CONTAINER_WORDS, ROW_SPAN

# K1/K3 fold up to MAX_LEAVES unique leaves: the 2 + 62 rows of the
# deepest integer field (bsi.field.MAX_BIT_DEPTH) and a 16-leaf filter.
# K2 streams up to MAX_SHARED_LEAVES unique runs through shared memory,
# for queries of at most that many leaves: a program of at most 16 leaf
# ops and a push and a combine for each of at most 15 nested operands.
MAX_LEAVES = 80
MAX_SHARED_LEAVES = 16
MAX_DEPTH = 8
MAX_BATCH = 16
_MAX_PROG = 768
_MAX_SHARED_PROG = 48
_OPCODES = {"and": 1, "or": 2, "andnot": 3}
_PUSH = 4

LAUNCHES = {"coarse_count": 0, "coarse_count_shared": 0, "tree_count": 0,
            "sparse_pair_count": 0, "pair_count": 0, "probe_ok": 0,
            "coarse_count_blocked": 0, "stream_popcount": 0,
            "apply_writes": 0, "sector_probe": 0}
_LAUNCH_MU = threading.Lock()
_UNCOUNTED = threading.local()


def reset_launches() -> None:
    with _LAUNCH_MU:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


@contextlib.contextmanager
def uncounted():
    """Launches made by this thread inside the block are not counted."""
    _UNCOUNTED.on = True
    try:
        yield
    finally:
        _UNCOUNTED.on = False


def tree_depth(tree) -> int:
    """Values held at once while folding `tree` left to right (the
    accumulator plus saved values): at most MAX_DEPTH on the kernels."""
    if tree[0] == "leaf":
        return 1
    depth = tree_depth(tree[1])
    for child in tree[2:]:
        depth = max(depth, 1 + tree_depth(child))
    return depth


def tree_program(tree) -> tuple:
    """The fold program of a numbered op tree, in the accumulator form
    of csrc/fold.cuh: one 16-bit op each, the opcode in the high byte and
    a leaf in the low one. 0x00l loads leaf l; 0x1l/0x2l/0x3l (high byte
    1-3) combine leaf l into the accumulator with and/or/andnot; 0x400
    saves the accumulator before a nested right operand and 0x500/0x600/
    0x700 combine it back. Raises ValueError beyond the kernels' limits."""
    ops: list = []
    _emit(tree, ops)
    if len(ops) > _MAX_PROG or tree_depth(tree) > MAX_DEPTH:
        raise ValueError("tree beyond the count kernels' limits")
    return tuple(ops)


def _emit(node, ops: list) -> None:
    # A module function, not a recursive closure: that would leave a
    # reference cycle per query for the cyclic collector.
    if node[0] == "leaf":
        if not 0 <= node[1] < MAX_LEAVES:
            raise ValueError(f"leaf {node[1]} beyond {MAX_LEAVES}")
        ops.append(node[1])
        return
    _emit(node[1], ops)
    kind = _OPCODES[node[0]]
    for child in node[2:]:
        if child[0] == "leaf":
            _emit(child, ops)
            ops[-1] |= kind << 8
        else:
            ops.append(_PUSH << 8)
            _emit(child, ops)
            ops.append((kind + 4) << 8)


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on a CUDA device, False when every one
    is on the CPU; mixed placements raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"count kernel inputs on mixed devices: {kinds}")


def leaf_steps(prog: tuple) -> tuple:
    """K1, K3 and K6's form of an accumulator program
    (csrc/coarse_tiles.cuh): one 32-bit step a leaf op, so the kernel's
    loads run ahead over a flat list of leaves. Bits 0-7 hold the leaf,
    8-9 its op (0 load, 1 and, 2 or, 3 andnot), bit 10 saves the
    accumulator before it (a nested operand begins), bits 11-14 count
    the saved values combined back after it and bits 15-30 hold their
    ops, two bits each, the first lowest. Raises ValueError for a program
    tree_program does not make: a first op or a nested operand that does
    not start with a load, a combine with nothing saved, values left
    saved."""
    steps: list = []
    push, sp = False, 0
    for op in prog:
        kind = op >> 8
        if kind < _PUSH:
            if kind and (push or not steps):
                raise ValueError(f"op {op:#x} combines into nothing")
            steps.append(op & 0xFF | kind << 8 | push << 10)
            push = False
        elif kind == _PUSH and not push and steps and sp < MAX_DEPTH - 1:
            push, sp = True, sp + 1
        elif _PUSH < kind < 8 and not push and sp:
            pops = steps[-1] >> 11 & 15
            steps[-1] += 1 << 11 | (kind - _PUSH) << (15 + 2 * pops)
            sp -= 1
        else:
            raise ValueError(f"op {op:#x} out of place in {prog}")
    if push or sp or not steps:
        raise ValueError(f"unbalanced program {prog}")
    return tuple(steps)


def _check_pools(pools, run_aligned: bool) -> None:
    s = pools[0].shape[0]
    for p in pools:
        if (p.dtype != torch.int32 or p.dim() != 3
                or p.shape[2] != CONTAINER_WORDS or p.shape[0] != s
                or not p.is_contiguous()):
            raise ValueError("pools must be contiguous (S, cap, 2048) int32 "
                             "tensors with one slice count")
        if run_aligned and p.shape[1] % ROW_SPAN:
            raise ValueError(f"pool capacity {p.shape[1]} is not a "
                             f"multiple of {ROW_SPAN}")


def _check_leaf_positions(prog: tuple, num_leaves: int) -> None:
    if any((op >> 8) < _PUSH and (op & 255) >= num_leaves for op in prog):
        raise ValueError(f"tree reads a leaf beyond its {num_leaves} "
                         f"leaf positions")


def _pool_args(pools, prog: tuple):
    """Each pool's base pointer and slice pitch (uint4 vectors), as every
    fold kernel's C entry takes them. The program reads leaf positions
    below len(pools): one per pool (K2's programs name its unique runs)."""
    _check_leaf_positions(prog, len(pools))
    bases = (ctypes.c_void_p * len(pools))(*[p.data_ptr() for p in pools])
    strides = (ctypes.c_longlong * len(pools))(
        *[p.shape[1] * CONTAINER_WORDS // 4 for p in pools])
    return bases, strides


def _kernel_args(pools, prog: tuple):
    """_pool_args and the program, as K2's C entry takes them."""
    return (*_pool_args(pools, prog), (ctypes.c_uint16 * len(prog))(*prog),
            len(prog))


@functools.lru_cache(maxsize=4096)
def _step_array(prog: tuple):
    """leaf_steps(prog) as the uint32 array K1, K3 and K6's C entries read
    (and never write): made once per program."""
    steps = leaf_steps(prog)
    return (ctypes.c_uint32 * len(steps))(*steps), len(steps)


def _tiled_args(pools, tree):
    """The by-pointer arguments of K1, K3 and K6's C entries: pools,
    slice pitches and the tree's leaf steps."""
    prog = tree_program(tree)
    return (*_pool_args(pools, prog), *_step_array(prog))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if getattr(_UNCOUNTED, "on", False):
        return
    with _LAUNCH_MU:
        LAUNCHES[name] += 1


def _gather_runs(pool: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(S, 16*2048) row runs at per-slice run index `starts`, zero where
    the start is negative."""
    s = pool.shape[0]
    runs = pool.view(s, pool.shape[1] // ROW_SPAN, ROW_SPAN * CONTAINER_WORDS)
    rows = runs[torch.arange(s, device=pool.device),
                starts.clamp(min=0).long()]
    return rows * (starts >= 0)[:, None]


def _slice_starts(starts: torch.Tensor, row: int, uniform: bool, s: int):
    return starts[row].expand(s) if uniform else starts[row]


# -- K1 coarse_count ---------------------------------------------------------


def coarse_plain(pools, starts, uniform: bool, tree, batch: int):
    num_leaves, s = len(pools), pools[0].shape[0]
    out = torch.empty((batch, s), dtype=torch.int32, device=starts.device)
    for b in range(batch):
        def leaf(i, b=b):
            return _gather_runs(pools[i], _slice_starts(
                starts, b * num_leaves + i, uniform, s))

        out[b] = popcount(fold_tree(tree, leaf)).sum(dim=1)
    return out


# K1, K3 and K6 cut every run into tiles (csrc/coarse_tiles.cuh): a
# 256-thread block folds TILE_UNROLL positions a thread at once, so a
# step of a block covers TILE_STEP_VEC of a run's RUN_VEC 16-byte
# vectors, and a run is cut into at most MAX_CHUNKS chunks of whole
# steps. The host picks
# the fewest chunks that give every SM TILES_PER_SM tiles; with more than
# one, the C entry zeroes the output on the card before the chunks add
# into it.
TILE_THREADS = 256
TILE_UNROLL = 4
RUN_VEC = ROW_SPAN * CONTAINER_WORDS // 4
TILE_STEP_VEC = TILE_THREADS * TILE_UNROLL
MAX_CHUNKS = RUN_VEC // TILE_STEP_VEC
TILES_PER_SM = 4


@functools.lru_cache(maxsize=1024)
def coarse_tiles(s: int, batch: int, sms: int, t: int = 1) -> int:
    """The chunk count C of a K1 / K3 / K6 launch over s slices, batch
    queries and t consecutive slices a tile, on a card of `sms` SMs: the
    fewest chunks (a power of two up to MAX_CHUNKS) that make
    s / t * batch * C tiles at least TILES_PER_SM * sms; 1 where
    s / t * batch already fills the card. The kernel's grid is
    (s / t * C, batch): block (x, y) folds query y, slices
    (x // C) * t .. + t - 1 and vectors [x % C, x % C + 1) * RUN_VEC / C
    of each run."""
    if s < 1 or batch < 1 or t < 1 or s % t:
        raise ValueError(f"no tiling of S={s}, B={batch}, T={t}")
    chunks = 1
    while chunks < MAX_CHUNKS and s // t * batch * chunks < TILES_PER_SM * sms:
        chunks *= 2
    return chunks


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _coarse(pools, starts, tree, batch: int, uniform: bool):
    pools = tuple(pools)
    _check_pools(pools, run_aligned=True)
    if not _on_cuda(*pools, starts):
        return coarse_plain(pools, starts, uniform, tree, batch)
    starts = starts.to(torch.int32).contiguous()
    s = pools[0].shape[0]
    chunks = coarse_tiles(s, batch, _sms(starts.device))
    out = torch.empty((batch, s), dtype=torch.int32, device=starts.device)
    bases, strides, steps, n_steps = _tiled_args(pools, tree)
    rc = kernel_fn("coarse_count")(
        bases, strides, len(pools), starts.data_ptr(), int(uniform), batch,
        s, chunks, steps, n_steps, out.data_ptr(), _stream(out))
    _launched("coarse_count", rc)
    return out


def _batch_of(pools, starts) -> int:
    batch, rem = divmod(int(starts.shape[0]), len(pools))
    if rem or batch < 1:
        raise ValueError(f"{starts.shape[0]} start rows for {len(pools)} "
                         "leaf positions")
    return batch


def coarse_count_per_slice(views, starts, tree):
    """Per-slice counts of `tree` over whole row runs. views: per leaf
    the (S, cap, 2048) pool; starts: (L, S) int32 run index, negative =
    absent. Returns (1, S) int32."""
    return _coarse(views, starts, tree, 1, uniform=False)


def coarse_count_identity_batch(pools, starts, tree):
    """B queries of one tree shape: pools per leaf position, starts
    (B*L, S) with slot = b*L + l. Returns (B, S) int32."""
    return _coarse(pools, starts, tree, _batch_of(pools, starts),
                   uniform=False)


def coarse_count_uniform(views, starts, tree):
    """The uniform layout: one run index per leaf for every slice,
    starts (L,). Returns (1, S) int32."""
    return _coarse(views, starts, tree, 1, uniform=True)


def coarse_count_uniform_batch(pools, starts, tree):
    """coarse_count_uniform for B queries: starts (B*L,). Returns
    (B, S) int32."""
    return _coarse(pools, starts, tree, _batch_of(pools, starts),
                   uniform=True)


# -- K2 coarse_count_shared --------------------------------------------------


def shared_plain(views, starts, uniform: bool, tree, leaf_map):
    s = views[0].shape[0]
    blocks = [_gather_runs(v, _slice_starts(starts, u, uniform, s))
              for u, v in enumerate(views)]
    return torch.stack([
        popcount(fold_tree(tree, lambda i, lm=lm: blocks[lm[i]])).sum(dim=1)
        for lm in leaf_map]).to(torch.int32)


def shared_programs(tree, leaf_map) -> tuple:
    """K2's per-query programs: tree_program(tree) once for each row of
    leaf_map, with every leaf op's leaf position replaced by the unique
    run it names, so the kernel picks a run's word by its index and keeps
    no leaf map. Returns B tuples of 16-bit ops."""
    prog = tree_program(tree)
    if len(prog) > _MAX_SHARED_PROG:
        raise ValueError(f"program of {len(prog)} ops beyond K2's "
                         f"{_MAX_SHARED_PROG}")
    _check_leaf_positions(prog, min(len(m) for m in leaf_map))
    return tuple(tuple(op if op >> 8 >= _PUSH else (op & 0xFF00) | m[op & 255]
                       for op in prog) for m in leaf_map)


def _shared(views, starts, tree, leaf_map, uniform: bool):
    views = tuple(views)
    leaf_map = tuple(tuple(int(u) for u in m) for m in leaf_map)
    _check_pools(views, run_aligned=True)
    if (not 1 <= len(leaf_map) <= MAX_BATCH
            or len(views) > MAX_SHARED_LEAVES
            or len(leaf_map[0]) > MAX_SHARED_LEAVES):
        raise ValueError(f"shared batch of {len(leaf_map)} queries over "
                         f"{len(views)} unique leaves is beyond "
                         f"{MAX_BATCH} x {MAX_SHARED_LEAVES}")
    if not _on_cuda(*views, starts):
        return shared_plain(views, starts, uniform, tree, leaf_map)
    if any(p.data_ptr() % 16 for p in views):
        raise ValueError("K2 copies 16-byte vectors: pools must start "
                         "16-byte aligned")
    s = views[0].shape[0]
    # One launch for both layouts: the uniform starts are expanded to the
    # (U, S) table on the card.
    starts = starts.to(torch.int32)
    if uniform:
        starts = starts[:, None].expand(len(views), s)
    starts = starts.contiguous()
    progs = shared_programs(tree, leaf_map)
    bases, strides, ops, _ = _kernel_args(views, sum(progs, ()))
    out = torch.zeros((len(leaf_map), s), dtype=torch.int32,
                      device=starts.device)
    rc = kernel_fn("coarse_count_shared")(
        bases, strides, len(views), starts.data_ptr(), s, ops,
        len(progs[0]), len(progs), out.data_ptr(), _stream(out))
    _launched("coarse_count_shared", rc)
    return out


def coarse_count_batch_per_slice(views, starts, tree, leaf_map):
    """Shared-read batch: B queries of one tree over U unique row runs,
    each read once per slice. views: per unique leaf the pool; starts
    (U, S); leaf_map: per query, leaf position -> unique index.
    Returns (B, S) int32."""
    return _shared(views, starts, tree, leaf_map, uniform=False)


def coarse_count_shared_uniform(views, starts, tree, leaf_map):
    """coarse_count_batch_per_slice for the uniform layout: starts
    (U,), expanded to the (U, S) table for the same launch. Returns
    (B, S) int32."""
    return _shared(views, starts, tree, leaf_map, uniform=True)


# -- K3 tree_count -----------------------------------------------------------


def gather_words(words, idx, hit):
    """(S, R, 2048) containers of one leaf from a dense pool, by (S, R)
    within-slice index; zero where hit is 0."""
    sl = torch.arange(words.shape[0], device=words.device)[:, None]
    return words[sl, idx.long()] * (hit != 0)[..., None]


def tree_plain(views, idx, hit, tree):
    batch, s = idx.shape[0], idx.shape[2]
    out = torch.empty((batch, s), dtype=torch.int32, device=idx.device)
    for b in range(batch):
        def leaf(i, b=b):
            return gather_words(views[i], idx[b, i], hit[b, i])

        out[b] = popcount(fold_tree(tree, leaf)).sum(dim=(1, 2))
    return out


def rows_plain(views, rows, tree):
    """tree_count_rows' plain version: each leaf's containers gathered
    through its index row."""
    s = views[0].shape[0]
    out = torch.empty((len(rows), s), dtype=torch.int32,
                      device=views[0].device)
    absent = torch.full((s, ROW_SPAN), -1, dtype=torch.int32,
                        device=views[0].device)
    for b, req in enumerate(rows):
        def leaf(i, req=req):
            return gather_containers(
                views[i], absent if req[i] is None else req[i])

        out[b] = popcount(fold_tree(tree, leaf)).sum(dim=(1, 2))
    return out


def tree_count_rows(views, rows, tree):
    """K3 (csrc/tree_count.cu, on the tiled fold): per-(query, slice)
    counts of `tree` over rows that are not whole runs, each leaf read
    container by container through its row of a container index table.
    views: per leaf position the (S, cap, 2048) pool; rows: B <=
    MAX_BATCH sequences of L entries, rows[b][l] the (S, 16) int32
    container index of query b's leaf l in views[l] (-1 = absent
    container; a row of parallel/mesh.row_table) on the pool's device,
    or None for an absent leaf. The kernel reads the index from the
    card: only the argument block goes up. Returns (B, S) int32."""
    views = tuple(views)
    _check_pools(views, run_aligned=False)
    s = views[0].shape[0]
    rows = [tuple(req) for req in rows]
    if (not 1 <= len(rows) <= MAX_BATCH
            or any(len(req) != len(views) for req in rows)):
        raise ValueError(f"tree_count_rows takes 1-{MAX_BATCH} queries of "
                         f"{len(views)} index rows")
    given = [r for req in rows for r in req if r is not None]
    if any(r.dtype != torch.int32 or tuple(r.shape) != (s, ROW_SPAN)
           or not r.is_contiguous() for r in given):
        raise ValueError(f"index rows must be contiguous ({s}, {ROW_SPAN}) "
                         "int32 tensors")
    if not _on_cuda(*views, *given):
        return rows_plain(views, rows, tree)
    dev = views[0].device
    chunks = coarse_tiles(s, len(rows), _sms(dev))
    out = torch.empty((len(rows), s), dtype=torch.int32, device=dev)
    bases, strides, steps, n_steps = _tiled_args(views, tree)
    ptrs = (ctypes.c_void_p * (len(rows) * len(views)))(
        *[None if r is None else r.data_ptr() for req in rows for r in req])
    rc = kernel_fn("tree_count")(bases, strides, len(views), ptrs,
                                 len(rows), s, chunks, steps, n_steps,
                                 out.data_ptr(), _stream(out))
    _launched("tree_count", rc)
    return out


def tree_count_per_slice(views, idx, hit, tree):
    """Per-(query, slice) counts over a per-container gather. views:
    per leaf position the (S, cap, 2048) pool; idx, hit: (B, L, S, 16)
    int32 container index within the slice and presence (1) flag. On the
    card the index, -1 where hit is 0, goes to tree_count_rows as B x L
    index rows, MAX_BATCH queries a launch. Returns (B, S) int32."""
    views = tuple(views)
    _check_pools(views, run_aligned=False)
    if (idx.dim() != 4 or idx.shape != hit.shape
            or idx.shape[1] != len(views)
            or tuple(idx.shape[2:]) != (views[0].shape[0], ROW_SPAN)):
        raise ValueError("idx/hit must be (B, L, S, 16) for L pools")
    if not _on_cuda(*views, idx, hit):
        return tree_plain(views, idx, hit, tree)
    index = torch.where(hit != 0, idx.to(torch.int32), -1).contiguous()
    return torch.cat([tree_count_rows(views, index[b:b + MAX_BATCH], tree)
                      for b in range(0, index.shape[0], MAX_BATCH)])


def tree_count_pallas(words, idx, hit, tree):
    """Total count of `tree` over one pool: idx, hit (L, S, 16). Returns
    a 0-d int64 tensor."""
    per = tree_count_per_slice((words,) * int(idx.shape[0]), idx[None],
                               hit[None], tree)
    return per.sum(dtype=torch.int64)


# -- K4 sparse_pair_count ----------------------------------------------------


def leaf_cards(cards, idx, hit):
    """(S, R) int32 cardinalities of one leaf's containers in a
    sorted-array pool, zero where hit is 0."""
    sl = torch.arange(cards.shape[0], device=cards.device)[:, None]
    return cards[sl, idx.long()] * (hit != 0)


def gather_sparse(vals, cards, idx, hit):
    """One leaf's containers from a sorted-array pool: ((S, R, K) values,
    leaf_cards)."""
    sl = torch.arange(vals.shape[0], device=vals.device)[:, None]
    return vals[sl, idx.long()], leaf_cards(cards, idx, hit)


def sparse_pair_plain(a_vals, a_cards, b_vals, b_cards, idx_a, hit_a, idx_b,
                      hit_b):
    va, na = gather_sparse(a_vals, a_cards, idx_a, hit_a)
    vb, nb = gather_sparse(b_vals, b_cards, idx_b, hit_b)
    return sparse_pair_intersect_counts(va, na, vb, nb)


def _check_sparse_pool(vals, cards, s: int) -> None:
    if (vals.dtype != torch.int16 or vals.dim() != 3 or vals.shape[0] != s
            or not vals.is_contiguous() or cards.dtype != torch.int32
            or cards.shape != vals.shape[:2] or not cards.is_contiguous()):
        raise ValueError("sorted-array pools must be contiguous (S, C, K) "
                         "int16 values with (S, C) int32 cardinalities")
    if not 1 <= vals.shape[2] <= ARRAY_MAX_SIZE:
        raise ValueError(f"value capacity {vals.shape[2]} is not in "
                         f"[1, {ARRAY_MAX_SIZE}]")


def sparse_pair_count(a_vals, a_cards, b_vals, b_cards, idx_a, hit_a, idx_b,
                      hit_b):
    """Per-(slice, r) |a ∩ b| of containers read straight from two
    sorted-array pools. a_vals (S, Ca, Ka) and b_vals (S, Cb, Kb) int16
    (u16 bits, sorted, 0xFFFF padded); a_cards (S, Ca), b_cards (S, Cb)
    int32; idx_*, hit_* (S, R) int32 within-slice container index and
    presence flag. An absent container on either side counts 0. Returns
    (S, R) int32."""
    s = a_vals.shape[0]
    _check_sparse_pool(a_vals, a_cards, s)
    _check_sparse_pool(b_vals, b_cards, s)
    if (idx_a.dim() != 2 or idx_a.shape[0] != s
            or not idx_a.shape == hit_a.shape == idx_b.shape == hit_b.shape):
        raise ValueError("idx/hit must be (S, R) for both leaves")
    if not _on_cuda(a_vals, a_cards, b_vals, b_cards, idx_a, hit_a, idx_b,
                    hit_b):
        return sparse_pair_plain(a_vals, a_cards, b_vals, b_cards, idx_a,
                                 hit_a, idx_b, hit_b)
    tables = [t.to(torch.int32).contiguous()
              for t in (idx_a, hit_a, idx_b, hit_b)]
    r = int(idx_a.shape[1])
    out = torch.empty((s, r), dtype=torch.int32, device=a_vals.device)
    rc = kernel_fn("sparse_pair_count")(
        a_vals.data_ptr(), a_cards.data_ptr(), a_vals.shape[1],
        a_vals.shape[2], b_vals.data_ptr(), b_cards.data_ptr(),
        b_vals.shape[1], b_vals.shape[2], *[t.data_ptr() for t in tables],
        s, r, out.data_ptr(), _stream(out))
    _launched("sparse_pair_count", rc)
    return out


def pallas_sparse_pair_counts(a_vals, a_len, b_vals, b_len):
    """Per-container |a ∩ b| with the flat contract of the Pallas function
    of this name: a_vals (..., Ka), b_vals (..., Kb) integer values
    (sorted, 0xFFFF padded), a_len/b_len (...,). K4 with one container
    per pool slot (C = 1, R = 1, idx = 0, hit = 1). Returns (...,)
    int32."""
    shape = a_vals.shape[:-1]
    n = 1
    for d in shape:
        n *= int(d)
    a = u16_bits(a_vals).reshape(n, 1, a_vals.shape[-1]).contiguous()
    b = u16_bits(b_vals).reshape(n, 1, b_vals.shape[-1]).contiguous()
    na = a_len.reshape(n, 1).to(torch.int32).contiguous()
    nb = b_len.reshape(n, 1).to(torch.int32).contiguous()
    zero = torch.zeros((n, 1), dtype=torch.int32, device=a.device)
    one = torch.ones((n, 1), dtype=torch.int32, device=a.device)
    out = sparse_pair_count(a, na, b, nb, zero, one, zero, one)
    return out.reshape(shape)


# -- K5 pair_count -----------------------------------------------------------


def pair_count_plain(a, b, op: str) -> torch.Tensor:
    """popcount(op(a, b)) (popcount(a) when b is None) as a 0-d int64."""
    return popcount(a if b is None else pair_op(op, a, b)).sum(
        dtype=torch.int64)


def _check_words(t, shape, what: str) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} int32 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def pair_count(a, b=None, op: str = "and") -> torch.Tensor:
    """popcount(op(a, b)) summed over two (M, 2048) int32 word blocks, as a
    0-d int64 tensor: the contract of the Pallas _pallas_pair_count, for
    op in and / or / xor / andnot and any M. b None counts a alone."""
    if op not in PAIR_OPS:
        raise ValueError(f"unknown pair op {op!r}")
    if a.dim() != 2 or a.shape[1] != CONTAINER_WORDS:
        raise ValueError(f"a must be (M, {CONTAINER_WORDS}), got "
                         f"{tuple(a.shape)}")
    _check_words(a, a.shape, "a")
    if b is not None:
        _check_words(b, a.shape, "b")
    if not _on_cuda(a, *([] if b is None else [b])):
        return pair_count_plain(a, b, op)
    out = torch.zeros((), dtype=torch.int64, device=a.device)
    rc = kernel_fn("pair_count")(
        a.data_ptr(), None if b is None else b.data_ptr(), a.numel() // 4,
        PAIR_OPS[op], out.data_ptr(), _stream(out))
    _launched("pair_count", rc)
    return out


def gather_containers(pool, idx):
    """(..., 2048) containers of a dense pool by (S, ...) within-slice
    index; zero where the index is negative."""
    return gather_words(pool, idx.clamp(min=0), idx >= 0)


def pair_rows_plain(pool, a_idx, op, b_pool, b_idx, b_block):
    b = (gather_containers(b_pool, b_idx) if b_idx is not None
         else b_block)
    out = torch.empty(a_idx.shape[0], dtype=torch.int64,
                      device=a_idx.device)
    for p in range(a_idx.shape[0]):
        out[p] = pair_count_plain(gather_containers(pool, a_idx[p]), b, op)
    return out


def pair_count_rows(pool, a_idx, op: str = "and", b_pool=None, b_idx=None,
                    b_block=None) -> torch.Tensor:
    """K5's serving form: per row p, popcount(op(row p, b)) over S slices.

    pool: the (S, cap, 2048) staged words; a_idx: (P, S, 16) int32 index
    of row p's container in each (slice, sub-key), negative = absent
    (read as zero). b, shared by every row: b_idx (S, 16) into b_pool, or
    b_block (S, 16, 2048) int32 words, or neither (plain popcount).
    Returns (P,) int64 totals."""
    if op not in PAIR_OPS:
        raise ValueError(f"unknown pair op {op!r}")
    _check_pools((pool,), run_aligned=False)
    s = pool.shape[0]
    if (a_idx.dim() != 3 or a_idx.shape[1:] != (s, ROW_SPAN)
            or not 1 <= a_idx.shape[0] <= 65535 or s > 65535):
        raise ValueError(f"a_idx must be (P, {s}, {ROW_SPAN}), got "
                         f"{tuple(a_idx.shape)}")
    if b_idx is not None and b_block is not None:
        raise ValueError("b is a pool row or a block, not both")
    tensors = [pool, a_idx]
    if b_idx is not None:
        _check_pools((b_pool,), run_aligned=False)
        if tuple(b_idx.shape) != (s, ROW_SPAN) or b_pool.shape[0] != s:
            raise ValueError(f"b_idx must be ({s}, {ROW_SPAN}) into a pool "
                             f"of {s} slices")
        tensors += [b_pool, b_idx]
    if b_block is not None:
        _check_words(b_block, (s, ROW_SPAN, CONTAINER_WORDS), "b_block")
        tensors.append(b_block)
    if not _on_cuda(*tensors):
        return pair_rows_plain(pool, a_idx, op, b_pool, b_idx, b_block)
    a_idx = a_idx.to(torch.int32).contiguous()
    if b_idx is not None:
        b_idx = b_idx.to(torch.int32).contiguous()
    out = torch.zeros(a_idx.shape[0], dtype=torch.int64, device=pool.device)
    rc = kernel_fn("pair_count_rows")(
        pool.data_ptr(), pool.shape[1] * CONTAINER_WORDS // 4,
        a_idx.data_ptr(), a_idx.shape[0], s,
        None if b_idx is None else b_pool.data_ptr(),
        0 if b_idx is None else b_pool.shape[1] * CONTAINER_WORDS // 4,
        None if b_idx is None else b_idx.data_ptr(),
        None if b_block is None else b_block.data_ptr(),
        PAIR_OPS[op], out.data_ptr(), _stream(out))
    _launched("pair_count", rc)
    return out


# -- K0 probe_ok -------------------------------------------------------------


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def probe_add(x: torch.Tensor) -> torch.Tensor:
    """K0 on a contiguous int32 tensor: adds 1 to every element, in place
    on the card (the plain version's new tensor on the CPU). Returns the
    result."""
    if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError("probe_add takes a non-empty contiguous int32 "
                         "tensor")
    if not _on_cuda(x):
        return probe_plain(x)
    rc = kernel_fn("probe_ok")(x.data_ptr(), x.numel(), _stream(x))
    _launched("probe_ok", rc)
    return x


def probe_ok(device="cuda") -> bool:
    """The canary of the Pallas pallas_probe_ok: one launch adding 1 over
    an (8, 128) int32 tensor of zeros; True when every element reads 1.
    A build or launch failure raises."""
    x = probe_add(torch.zeros((8, 128), dtype=torch.int32, device=device))
    return bool((x == 1).all())


# -- K6 coarse_count_blocked and stream_popcount -----------------------------

BLOCK_SLICES = (1, 2, 4, 8, 16, 32)


def coarse_count_blocked(views, starts, tree, t: int):
    """K6: coarse_count_uniform with T consecutive slices per tile, the
    shape of the bandwidth probe's Pallas kernel, on K1's tiled fold
    (coarse_tiles with t = T). views: per leaf the
    (S, cap, 2048) pool; starts: (L,) int32 run index per leaf, negative
    = absent; t in BLOCK_SLICES, dividing S. Returns (1, S) int32; the
    plain version is coarse_plain's uniform form."""
    views = tuple(views)
    _check_pools(views, run_aligned=True)
    s = views[0].shape[0]
    if t not in BLOCK_SLICES or s % t:
        raise ValueError(f"T={t} must be one of {BLOCK_SLICES} and divide "
                         f"S={s}")
    if starts.dim() != 1 or starts.shape[0] != len(views):
        raise ValueError(f"starts must be ({len(views)},), got "
                         f"{tuple(starts.shape)}")
    if not _on_cuda(*views, starts):
        return coarse_plain(views, starts, True, tree, 1)
    starts = starts.to(torch.int32).contiguous()
    chunks = coarse_tiles(s, 1, _sms(starts.device), t)
    out = torch.empty((1, s), dtype=torch.int32, device=starts.device)
    bases, strides, steps, n_steps = _tiled_args(views, tree)
    rc = kernel_fn("coarse_count_blocked")(
        bases, strides, len(views), starts.data_ptr(), s, t, chunks, steps,
        n_steps, out.data_ptr(), _stream(out))
    _launched("coarse_count_blocked", rc)
    return out


def stream_plain(pool: torch.Tensor) -> torch.Tensor:
    return popcount(pool).sum(dtype=torch.int64)


def stream_popcount(pool: torch.Tensor) -> torch.Tensor:
    """Set bits of a whole contiguous int32 tensor (uint32 words), as a
    0-d int64 tensor: each word read once, the card's streaming ceiling
    for a pool."""
    if (pool.dtype != torch.int32 or not pool.is_contiguous()
            or pool.numel() < 1):
        raise ValueError("stream_popcount takes a non-empty contiguous "
                         "int32 tensor")
    if not _on_cuda(pool):
        return stream_plain(pool)
    if pool.data_ptr() % 16:
        raise ValueError("stream_popcount reads 16-byte vectors: the "
                         "tensor must start 16-byte aligned")
    sms = torch.cuda.get_device_properties(pool.device).multi_processor_count
    # Eight 256-thread blocks an SM: the SM's 2048 resident threads.
    blocks = max(1, min(8 * sms, -(-pool.numel() // (4 * 256))))
    partials = torch.empty(blocks, dtype=torch.int64, device=pool.device)
    out = torch.empty((), dtype=torch.int64, device=pool.device)
    rc = kernel_fn("stream_popcount")(
        pool.data_ptr(), pool.numel(), partials.data_ptr(), blocks,
        out.data_ptr(), _stream(out))
    _launched("stream_popcount", rc)
    return out


# -- K7 apply_writes -----------------------------------------------------------

def scatter_plain(words, slot, word, set_mask, clear_mask):
    """(w & ~clear) | set at each in-bounds (slot, word) entry, in place
    by advanced indexing; entries with slot outside [0, cap) or word
    outside [0, 2048) drop. Shapes as scatter_words'."""
    w = words if words.dim() == 3 else words.unsqueeze(0)
    sl, wd, sm, cm = (t.reshape(w.shape[0], -1)
                      for t in (slot, word, set_mask, clear_mask))
    keep = (sl >= 0) & (sl < w.shape[1]) & (wd >= 0) & (wd < CONTAINER_WORDS)
    s_idx = torch.arange(w.shape[0], device=w.device)[:, None].expand_as(sl)
    s_idx, sl, wd = s_idx[keep], sl[keep], wd[keep]
    w[s_idx, sl, wd] = (w[s_idx, sl, wd] & ~cm[keep]) | sm[keep]
    return words


def scatter_words(words, slot, word, set_mask, clear_mask):
    """K7: (w & ~clear_mask) | set_mask at unique (slot, word) targets of
    a staged pool, in place, with the contract of the JAX package's
    ops/pool.scatter_words (vmapped over slices by its
    compile_serve_apply_writes). words: contiguous (S, cap, 2048) int32
    with (S, B) batches, or (cap, 2048) with (B,) batches; slot and word
    int32, the masks int32 holding uint32 bits. An entry with slot
    outside [0, cap) (padding rides slot = cap) drops, as mode="drop"
    drops it. Targets must be unique per slice (plan_slice_mutations).
    Returns words."""
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or words.shape[-1] != CONTAINER_WORDS
            or not words.is_contiguous()):
        raise ValueError("scatter_words takes a contiguous (S, cap, 2048) "
                         "or (cap, 2048) int32 pool")
    want = tuple(words.shape[:1]) if words.dim() == 3 else ()
    batch = (slot, word, set_mask, clear_mask)
    for t in batch:
        if (t.dtype != torch.int32 or t.dim() != len(want) + 1
                or tuple(t.shape[:-1]) != want or not t.is_contiguous()
                or t.shape != slot.shape):
            raise ValueError("scatter_words batches must be contiguous "
                             f"int32 tensors of one shape {want + ('B',)}")
    if not _on_cuda(words, *batch):
        return scatter_plain(words, *batch)
    if slot.numel() == 0:
        return words
    s = words.shape[0] if words.dim() == 3 else 1
    b = int(slot.shape[-1])
    rc = kernel_fn("apply_writes")(
        words.data_ptr(), s, words.shape[-2], slot.data_ptr(),
        word.data_ptr(), set_mask.data_ptr(), clear_mask.data_ptr(), b,
        _stream(words))
    _launched("apply_writes", rc)
    return words


def _int32_bits(x: int) -> int:
    """uint32 bits as the int32 value holding them."""
    return x - (1 << 32) if x >= 1 << 31 else x


def sector_probe_plain(words, offsets, flip: int):
    flat = words.view(-1)
    flat[offsets] ^= _int32_bits(flip)
    return words


def sector_probe(words, offsets, flip: int = 0):
    """The card's scattered 32-byte read-modify-write rate, K7's ceiling
    (csrc/sector_probe.cu), a measurement beside the kernels: xor `flip`
    (uint32 bits) into the words of a contiguous int32 tensor at unique
    int64 flat word offsets, in place, one offset a thread in blocks of
    256 threads, as K7 runs. Returns words."""
    if (words.dtype != torch.int32 or not words.is_contiguous()
            or offsets.dtype != torch.int64 or offsets.dim() != 1
            or not offsets.is_contiguous() or not 0 <= flip < 1 << 32):
        raise ValueError("sector_probe takes contiguous int32 words, (n,) "
                         "int64 offsets and a uint32 flip")
    if not _on_cuda(words, offsets):
        return sector_probe_plain(words, offsets, flip)
    if offsets.numel() == 0:
        return words
    rc = kernel_fn("sector_probe")(words.data_ptr(), offsets.data_ptr(),
                                   offsets.numel(), flip, _stream(words))
    _launched("sector_probe", rc)
    return words
