// K1 coarse_count: per-(query, slice) popcount of a bitmap-op tree over
// whole 16-container row runs.
//
// Replaces the Pallas kernels coarse_count_per_slice (pilosa_tpu/ops/
// kernels.py:300, call :337), coarse_count_identity_batch (:358, call
// :401), coarse_count_uniform (:456, call :490) and
// coarse_count_uniform_batch (:513, call :545).
//
// Bound on an H100 SXM: bytes. Each (query, slice, leaf) reads one
// 128 KB row run once; a lone pair over 960 slices moves 252 MB, 75 us
// at 3.35 TB/s, and a 29-leaf OR over 96 slices 365 MB, 109 us. The fold
// and __popc are a few integer ops per 16 bytes.
//
// v3 design: the tiled fold of coarse_tiles.cuh with one slice a tile
// (t = 1): the host cuts each run into C chunks so that S * B * C tiles
// fill the card (C = 1 at the headline's 960 slices), and each thread
// keeps 128 bytes in flight (4 positions, the next leaf's loads issued
// before the current one is folded): ~32 KB a block, ~64 KB an SM at two
// blocks an SM. Chunks of one (b, s) add into a zeroed out[b, s] with one
// integer atomicAdd each, so the count is exact and the same every run.
// The row-run start comes from a (B*L, S) table or, for the uniform
// layout, one scalar per (query, leaf); a negative start is an absent
// leaf that reads nothing. The TPU kernel's multi-slice blocks and scalar
// prefetch tables are TPU artefacts and have no counterpart here.
#include "coarse_tiles.cuh"

// starts: device int32, (batch*num_leaves,) when uniform else
// (batch*num_leaves, num_slices); chunks: 1, 2, 4 or 8 (ops/kernels.py
// coarse_tiles); out: device int32 (batch, num_slices), zeroed here
// (cudaMemsetAsync) when chunks > 1.
extern "C" int pilosa_coarse_count(const void* const* bases,
                                   const long long* strides, int num_leaves,
                                   const int* starts, int uniform, int batch,
                                   int num_slices, int chunks,
                                   const unsigned* steps, int num_steps,
                                   int* out, void* stream) {
  return coarse_tiles_launch(bases, strides, num_leaves, starts, uniform,
                             batch, num_slices, chunks, 1, steps,
                             num_steps, out, stream);
}
