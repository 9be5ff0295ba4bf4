"""K3 tree_count on the tiled fold (csrc/coarse_tiles.cuh, table mode)
and K7 apply_writes' grid (csrc/apply_writes.cu), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py). What they
take from the host is checked here: K3's walk over a tile's containers,
mirrored as the kernel reads its block and thread indices, covers every
(query, slice, container, vector) of a launch once; its table form (a
row of a container index table a leaf, tree_count_rows) counts as the
gathered idx/hit form and as the JAX package's Pallas K3 in interpret
mode; K7's mapping of entries to threads covers every entry once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.ops import kernels as jk
from pilosa_tpu_torch.bsi import FieldSchema, cond_tree, to_shape
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.parallel.plan import canonical_tree
from torch_threads import one_torch_thread  # noqa: F401

H100_SMS = 132
SLICE_COUNTS = (1, 7, 24, 96, 133, 960)
CONTAINER_VEC = 512  # 16-byte vectors of one 2048-word container


def table_walk(chunks: int, x: int, thread: int) -> list:
    """(container, vector) pairs thread `thread` of block x reads in its
    tile's slice, in the kernel's order (coarse_tiles_kernel, table
    mode): step i of the chunk reads containers 2i and 2i + 1 of the
    chunk's 16 / C, two vectors of each, 256 apart."""
    c = x % chunks
    span = 16 // chunks
    return [(c * span + 2 * i + u // 2, (u % 2) * tk.TILE_THREADS + thread)
            for i in range(span // 2) for u in range(tk.TILE_UNROLL)]


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("s", SLICE_COUNTS)
def test_table_tiles_cover_every_container_vector_once(s, batch):
    chunks = tk.coarse_tiles(s, batch, H100_SMS)
    span = 16 // chunks
    assert span >= 2 and span % 2 == 0
    # One tile's threads cover its chunk's containers once.
    for x in range(chunks):
        seen = np.zeros((16, CONTAINER_VEC), dtype=np.int16)
        for th in range(tk.TILE_THREADS):
            for j, v in table_walk(chunks, x, th):
                seen[j, v] += 1
        c = x % chunks
        assert (seen[c * span:(c + 1) * span] == 1).all()
        assert seen.sum() == span * CONTAINER_VEC
    # The grid (S * C, B): block x of query y folds slice x // C, chunk
    # x % C; every (query, slice, chunk) once.
    grid = np.zeros((batch, s, chunks), dtype=np.int16)
    xs = np.arange(s * chunks)
    for y in range(batch):
        np.add.at(grid[y], (xs // chunks, xs % chunks), 1)
    assert (grid == 1).all()


def test_table_walk_reads_the_run_walk_positions():
    """Table mode reads, container by container, the run positions run
    mode reads: position p of a run is vector p % 512 of container
    p // 512."""
    for chunks in (1, 2, 4, 8):
        for x in range(chunks):
            for th in (0, 1, 255):
                table = [j * CONTAINER_VEC + v
                         for j, v in table_walk(chunks, x, th)]
                assert table == run_positions(chunks, x, th)


def run_positions(chunks: int, x: int, thread: int) -> list:
    """Run mode's positions for thread `thread` of block x (as in
    tests/test_torch_tiles.py thread_vectors)."""
    v0 = x % chunks * tk.RUN_VEC // chunks
    return [v0 + thread + i + u * tk.TILE_THREADS
            for i in range(0, tk.RUN_VEC // chunks, tk.TILE_STEP_VEC)
            for u in range(tk.TILE_UNROLL)]


# -- the table form against the gathered form and the Pallas K3 ------------

W = 2048
L = [["leaf", i] for i in range(80)]


def pools(rng, n: int, s: int, cap: int):
    return [rng.integers(0, 1 << 32, size=(s, cap, W), dtype=np.uint32)
            for _ in range(n)]


def tables_and_rows(rng, n: int, s: int, cap: int, batch: int):
    """Per leaf position an (R, S, 16) table (-1 = absent container) and
    per query a row of each: some containers, slices and first
    containers absent, and some whole leaves absent (-1)."""
    tabs = []
    for _ in range(n):
        r = 3
        t = rng.integers(0, cap, size=(r, s, 16)).astype(np.int32)
        t[rng.random(t.shape) < 0.3] = -1
        t[0, :, 0] = -1                  # a row missing its first container
        t[1, s // 2] = -1                # a row absent from one slice
        t[2] = -1                        # a row staged nowhere
        tabs.append(t)
    rows = rng.integers(-1, 3, size=(batch, n)).astype(np.int64)
    rows[0, 0] = 0
    return tabs, rows


def gathered(tabs, rows):
    """The (B, L, S, 16) idx / hit the table rows stand for."""
    b, n = rows.shape
    s = tabs[0].shape[1]
    idx = np.zeros((b, n, s, 16), dtype=np.int32)
    for q in range(b):
        for l in range(n):
            if rows[q, l] >= 0:
                idx[q, l] = tabs[l][rows[q, l]]
            else:
                idx[q, l] = -1
    return np.maximum(idx, 0), (idx >= 0).astype(np.int32)


def index_rows(tabs, rows):
    """tree_count_rows' rows: per query the table row of each leaf, None
    for an absent leaf (-1)."""
    return [[torch.from_numpy(tabs[l][r]) if r >= 0 else None
             for l, r in enumerate(req)] for req in rows.tolist()]


def as_t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


TABLE_TREES = {
    "pair": ["and", L[0], L[1]],
    "nested": ["or", ["and", L[0], L[1]], ["andnot", L[2], L[3]]],
    "or-29": ["or"] + L[:29],
    "andnot-80": ["andnot", ["or"] + L[:40], ["and"] + L[40:80]],
}


def nleaves(tree) -> int:
    if tree[0] == "leaf":
        return tree[1] + 1
    return max(nleaves(c) for c in tree[1:])


@pytest.mark.parametrize("name", sorted(TABLE_TREES))
def test_table_form_equals_the_gathered_form(name):
    tree = TABLE_TREES[name]
    n, s, cap = nleaves(tree), 5, 4
    rng = np.random.default_rng(n)
    ps = pools(rng, min(n, 3), s, cap)
    views = tuple(as_t(ps[i % len(ps)]) for i in range(n))
    tabs, rows = tables_and_rows(rng, n, s, cap, batch=3)
    got = tk.tree_count_rows(views, index_rows(tabs, rows), tree)
    idx, hit = gathered(tabs, rows)
    want = tk.tree_count_per_slice(views, torch.from_numpy(idx),
                                   torch.from_numpy(hit), tree)
    assert got.dtype == torch.int32 and got.shape == (3, s)
    assert torch.equal(got, want)
    assert (got > 0).any()


@pytest.mark.parametrize("name", sorted(TABLE_TREES))
def test_table_form_matches_pallas(name):
    """tree_count_rows (CPU: rows_plain) and tree_count_pallas against
    the JAX package's tree_count_pallas in interpret mode, one query over
    one pool."""
    tree = TABLE_TREES[name]
    n, s, cap = nleaves(tree), 2, 4
    rng = np.random.default_rng(100 + n)
    pool = pools(rng, 1, s, cap)[0]
    tabs, rows = tables_and_rows(rng, n, s, cap, batch=1)
    idx, hit = gathered(tabs, rows)
    want = int(jk.tree_count_pallas(jnp.asarray(pool), jnp.asarray(idx[0]),
                                    jnp.asarray(hit[0]), tree,
                                    interpret=True))
    views = (as_t(pool),) * n
    got = tk.tree_count_rows(views, index_rows(tabs, rows), tree)
    assert int(got.sum()) == want
    assert int(tk.tree_count_pallas(as_t(pool), torch.from_numpy(idx[0]),
                                    torch.from_numpy(hit[0]), tree)) == want


def ladder_trees():
    """The canonical trees of Count(Range(field op c)) over a 16-plane
    field, the BSI path's K3 trees, one per operator."""
    schema = FieldSchema("v", -32768, 32767)
    out = {}
    for op, c in ((">", 1000), (">=", -5), ("<", 0), ("<=", 77),
                  ("==", -12), ("!=", 0), ("><", (-1000, 1000))):
        raw, leaves = [], []
        tree = canonical_tree(to_shape(cond_tree(schema, op, c), "f",
                                       schema.view, raw), raw, leaves)
        out[op] = (tree, len(leaves))
    return out


LADDERS = ladder_trees()


@pytest.mark.parametrize("op", sorted(LADDERS))
def test_tree_plain_matches_pallas_on_bsi_ladders(op):
    """tree_plain against the JAX package's Pallas K3 (interpret mode)
    on the ladder trees the BSI Ranges send to K3, with the field's rows
    as one pool's rows: the top plane nearly empty, some containers
    absent."""
    tree, n = LADDERS[op]
    s, cap = 2, 3 * 16
    rng = np.random.default_rng(len(op) + n)
    pool = pools(rng, 1, s, cap)[0]
    idx = rng.integers(0, cap, size=(n, s, 16)).astype(np.int32)
    hit = (rng.random((n, s, 16)) < 0.8).astype(np.int32)
    hit[n - 1] = 0
    hit[n - 1, 0, 3] = 1  # the top plane: one container
    want = int(jk.tree_count_pallas(jnp.asarray(pool), jnp.asarray(idx),
                                    jnp.asarray(hit), tree, interpret=True))
    got = tk.tree_plain((as_t(pool),) * n, torch.from_numpy(idx)[None],
                        torch.from_numpy(hit)[None], tree)
    assert int(got.sum()) == want


def test_tree_count_rows_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(5)
    views = tuple(as_t(p) for p in pools(rng, 2, 3, 4))
    row = torch.full((3, 16), -1, dtype=torch.int32)
    pair = ["and", L[0], L[1]]
    with pytest.raises(ValueError):  # a row of another dtype
        tk.tree_count_rows(views, [[row, row.long()]], pair)
    with pytest.raises(ValueError):  # a row for each leaf position
        tk.tree_count_rows(views, [[row]], pair)
    with pytest.raises(ValueError):  # more queries than one launch takes
        tk.tree_count_rows(views, [[row, None]] * (tk.MAX_BATCH + 1), pair)
    with pytest.raises(ValueError):  # a row of another slice count
        tk.tree_count_rows(views, [[row[:2].contiguous(), row]], pair)


# -- K7's grid ----------------------------------------------------------------


@pytest.mark.parametrize("s,b", [(1, 1), (960, 8), (37, 100), (960, 1023),
                                 (960, 1024), (5, 4096), (3, 8195)])
def test_scatter_grid_covers_every_entry_once(s, b):
    """Thread i of K7's flat grid of 256-thread blocks takes entry i % b
    of slice i // b: every (slice, entry) once, and no block past the
    batch."""
    threads = 256
    n = s * b
    blocks = -(-n // threads)
    i = np.arange(blocks * threads)
    i = i[i < n]
    seen = np.zeros((s, b), dtype=np.int16)
    np.add.at(seen, (i // b, i % b), 1)
    assert (seen == 1).all()
    assert (blocks - 1) * threads < n


def test_scatter_words_takes_an_empty_batch():
    """No entries: K7 launches nothing and the pool stays as it was."""
    words = torch.arange(2 * 3 * 2048, dtype=torch.int32).reshape(2, 3, 2048)
    before = words.clone()
    empty = torch.zeros((2, 0), dtype=torch.int32)
    assert tk.scatter_words(words, empty, empty, empty, empty) is words
    assert torch.equal(words, before)


def test_sector_probe_plain_flips_the_words_at_its_offsets():
    rng = np.random.default_rng(4)
    words = as_t(rng.integers(0, 1 << 32, size=(3, 16, 2048),
                              dtype=np.uint32))
    before = words.clone()
    offs = torch.from_numpy(rng.choice(words.numel(), size=100,
                                       replace=False).astype(np.int64))
    tk.sector_probe(words, offs, 0x80000001)
    flat, was = words.view(-1), before.view(-1)
    assert torch.equal(flat[offs], was[offs] ^ tk._int32_bits(0x80000001))
    keep = torch.ones(words.numel(), dtype=torch.bool)
    keep[offs] = False
    assert torch.equal(flat[keep], was[keep])
    tk.sector_probe(words, offs, 0x80000001)
    assert torch.equal(words, before)
    with pytest.raises(ValueError):  # a flip wider than 32 bits
        tk.sector_probe(words, offs, 1 << 32)
