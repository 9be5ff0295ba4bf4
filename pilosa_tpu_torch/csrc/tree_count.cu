// K3 tree_count: per-(query, slice) popcount of a bitmap-op tree over
// rows that are not staged as whole aligned runs (partial rows, rows
// missing containers in some slices), each container found through a
// container index table.
//
// Replaces the Pallas kernel _tree_count_call / tree_count_pallas
// (pilosa_tpu/ops/kernels.py:262, call :279; :721).
//
// Bound on an H100 SXM: bytes. Each present container is read once,
// 8 KB, plus 64 bytes of index a (leaf, slice); an absent one is a zero
// that reads nothing.
//
// v2 design: the tiled fold of coarse_tiles.cuh in table mode, one slice
// a tile. The host cuts each row's 16 containers into C chunks so that
// S * B * C tiles fill the card (kernels.coarse_tiles, as K1); a tile
// reads its leaves' index slabs once into a shared table of container
// pointers (nullptr where absent), then every thread keeps 128 bytes in
// flight (4 positions, the next leaf's loads issued before the current
// one is folded) over the program's leaf steps. Chunks of one (b, s) add
// into a zeroed out[b, s] with one integer atomicAdd each. v1 (one block
// a (slice, query), its 16 sub-keys one after another with two barriers
// each, one 16-byte load in flight a thread) ran a pair over 96 slices at
// 28% of its bound. The index comes from the card: on the serving path a
// leaf's slab is its row's container index, kept on the card with the
// staged view from the row's first K3 Count on (parallel/serve.py
// StagedView.index_row), so a later Count uploads nothing but the
// argument block. The TPU kernel's SMEM slab loop over slices is
// a TPU artefact and has no counterpart here.
#include "coarse_tiles.cuh"

// rows: batch * num_leaves device pointers, at b * num_leaves + l the
// (num_slices, 16) int32 index slab of query b's leaf l (-1 = absent
// container; nullptr = an absent leaf), at most K3_MAX_ROWS
// (table_tiles_launch in coarse_tiles.cuh). chunks: 1, 2, 4 or 8
// (ops/kernels.py coarse_tiles); out: device int32 (batch, num_slices),
// zeroed here (cudaMemsetAsync) when chunks > 1.
extern "C" int pilosa_tree_count(const void* const* bases,
                                 const long long* strides, int num_leaves,
                                 const void* const* rows, int batch,
                                 int num_slices, int chunks,
                                 const unsigned* steps, int num_steps,
                                 int* out, void* stream) {
  return table_tiles_launch(bases, strides, num_leaves, rows, batch,
                            num_slices, chunks, steps, num_steps, out,
                            stream);
}
