// The tiled fold shared by K1 coarse_count, K6 coarse_count_blocked and
// K3 tree_count: per-(query, slice) popcount of a bitmap-op tree over
// each leaf's 16 containers of a row, cut into work tiles that fill the
// card at any slice count. A leaf's containers are found in one of two
// ways (the template's kTable):
// - run start (K1, K6): the row sits as one aligned 16-container run,
//   and a start per (query, leaf[, slice]) names it;
// - container table (K3): the row's containers sit anywhere in the
//   slice, and an (S, 16) int32 slab of a container index table names
//   each one (-1 = absent), for rows that are not whole runs.
//
// What held the one-block-per-(slice, query) kernels back (measured on an
// H100): each thread had one 16-byte load in flight, because fold.cuh's
// interpreter loaded a leaf only when its op came up, so a block kept
// ~4 KB in flight. An SM needs ~25-35 KB in flight to draw its 1/132
// share of 3.35 TB/s. At 960 slices ~7 blocks sat on each SM and K1 ran
// at 85-93% of its bound; at 96 slices one block sat on 96 SMs (24%; K3
// 28%, which also walked its 16 sub-keys one after another with two
// barriers each), and K6 at T = 32 ran 30 blocks over 960 slices (7%).
//
// The design:
// - Tiles. A tile is (query b, group of t consecutive slices, chunk c of
//   the run): the 8,192 16-byte vectors of a run (16 containers of 512)
//   are cut into C equal chunks of whole 1,024-vector steps, C in
//   {1, 2, 4, 8}, picked on the host from S / t, B and the SM count
//   (ops/kernels.py coarse_tiles, which the CPU tests hold to covering
//   every vector once). The grid is (S / t * C, B), one 256-thread block
//   a tile; C = 1 where S * B already fills the card (the headline's 960
//   slices). K3 runs t = 1.
// - Leaf addresses, resolved once a tile into shared memory: in run mode
//   one pointer a leaf (its run in the tile's first slice); in table mode
//   one pointer a (leaf, container) of the chunk, read from the leaf's
//   row slab (80 leaves x 16 containers = 10 KB), nullptr where absent,
//   so a load reads no table.
// - Bytes in flight. A thread folds K1_UNROLL = 4 positions 256 vectors
//   apart, so a leaf op issues 4 independent 16-byte loads; and the loads
//   of the next leaf op are issued before the current one is folded (two
//   register buffers in turn), so 2 x 4 x 16 = 128 bytes a thread, 32 KB
//   a block, are in flight while it waits. At the two blocks an SM the
//   launch bounds ask for, an SM keeps ~64 KB in flight. A step's 1,024
//   vectors are two whole containers, so in table mode a thread reads two
//   shared pointers a leaf op, the same for the whole block (an absent
//   container costs no load and no divergence).
// - The program. The host turns the accumulator program of fold.cuh into
//   one 32-bit step a leaf op (ops/kernels.py leaf_steps: leaf, op kind,
//   a save of the accumulator before it, and the combines of saved
//   values after it), so the loads run ahead over a flat list of leaves
//   and a step never waits on a push or a pop. Saved values sit in a
//   per-thread local array.
// - Exact reduction across chunks. With C = 1 a block owns its (b, s) and
//   stores the block sum. With C > 1 every chunk adds its block sum into
//   out[b, s], zeroed first by a cudaMemsetAsync on the same stream (a
//   device operation, counted in the kernel's time), with one integer
//   atomicAdd: per-slice counts are <= 2^20, and integer addition gives
//   the same result in any order.
#pragma once

#include "fold.cuh"

#define K1_UNROLL 4
#define K1_STEP_VEC (PILOSA_THREADS * K1_UNROLL)
#define K1_MAX_CHUNKS (PILOSA_RUN_VEC / K1_STEP_VEC)
#define K1_MAX_T 32

// The kernel's by-value arguments: per leaf its pool and slice pitch (in
// uint4 vectors), and the program as n steps, one a leaf op
// (ops/kernels.py leaf_steps): bits 0-7 the leaf, 8-9 the op (0 load,
// 1 and, 2 or, 3 andnot), 10 save the accumulator first (a nested
// operand begins), 11-14 the number of saved values combined back after
// it, 15-30 their ops (1-3, two bits each, the first in the lowest
// bits). The first step is a load. Two sizes: the full block (80 leaves,
// 768 steps) is 4.4 KB, past the 4 KB over which a launch takes longer
// on the host, so trees of up to 32 leaves and 64 steps, nearly every
// query, launch with a 0.8 KB block.
template <int kLeaves, int kSteps>
struct TileArgs {
  static constexpr int kMaxLeaves = kLeaves;
  const uint4* base[kLeaves];
  long long slice_stride[kLeaves];
  int n;
  unsigned w[kSteps];
};
#define K1_SMALL_LEAVES 32
#define K1_SMALL_STEPS 64

// K3's arguments: the fold's, and per (query b, leaf l) at b * L + l the
// (S, 16) int32 slab of its row in a container index table (nullptr: an
// absent leaf). The small block (1 KB) takes up to 32 rows: a lone
// query of up to 32 leaves, or 16 pairs; the full one (14.6 KB) a batch
// of 16 queries of 80 leaves.
template <int kLeaves, int kSteps, int kRows>
struct TableArgs : TileArgs<kLeaves, kSteps> {
  const int* row[kRows];
};
#define K3_SMALL_ROWS 32
#define K3_MAX_ROWS (PILOSA_MAX_BATCH * PILOSA_MAX_LEAVES)

typedef uint4 Lanes[K1_UNROLL];

template <int kKind>
__device__ __forceinline__ void fold_lanes(Lanes& acc, const Lanes& v) {
#pragma unroll
  for (int u = 0; u < K1_UNROLL; ++u)
    acc[u] = kKind == 0 ? v[u] : combine(kKind, acc[u], v[u]);
}

// Applies step w to the accumulators with the leaf's words v.
__device__ __forceinline__ void apply_step(unsigned w, Lanes& acc,
                                           const Lanes& v,
                                           Lanes (&saved)[PILOSA_MAX_DEPTH],
                                           int& sp) {
  if (w & (1u << 10)) {
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) saved[sp][u] = acc[u];
    ++sp;
  }
  switch ((w >> 8) & 3) {
    case 0: fold_lanes<0>(acc, v); break;
    case 1: fold_lanes<1>(acc, v); break;
    case 2: fold_lanes<2>(acc, v); break;
    default: fold_lanes<3>(acc, v);
  }
  const int pops = (w >> 11) & 15;
  for (int p = 0; p < pops; ++p) {
    const int kind = (w >> (15 + 2 * p)) & 3;
    --sp;
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u)
      acc[u] = combine(kind, saved[sp][u], acc[u]);
  }
}

// Two 16-byte vectors of a container at this thread's positions, or
// zeros when it is absent.
__device__ __forceinline__ void load_pair(const uint4* p, uint4& a,
                                          uint4& b) {
  if (p != nullptr) {
    a = __ldg(p + threadIdx.x);
    b = __ldg(p + threadIdx.x + PILOSA_THREADS);
  } else {
    a = zero4();
    b = zero4();
  }
}

// Block (x, y): query y, slices g*t .. g*t + t - 1 with g = x / chunks,
// vectors [c, c + 1) * 8192 / chunks of each run with c = x % chunks.
// Run mode: starts, (B*L,) when uniform else (B*L, S); t > 1 only with
// uniform. Table mode (t = 1): starts is unused, args.row names each
// leaf's index slab.
template <class Args, bool kTable>
__global__ void __launch_bounds__(PILOSA_THREADS, 2)
coarse_tiles_kernel(const __grid_constant__ Args args,
                    const int* __restrict__ starts, int uniform,
                    int num_leaves, int num_slices, int chunks, int t,
                    int* __restrict__ out) {
  constexpr int kLeaves = Args::kMaxLeaves;
  __shared__ int red[32];
  // Run mode: leaf l's run at [l]; table mode: its container j of the
  // chunk at [l * 16 + j].
  __shared__ const uint4* lp[kTable ? kLeaves * 16 : kLeaves];
  const int c = blockIdx.x % chunks;
  const long long s0 = (long long)(blockIdx.x / chunks) * t;
  const int b = blockIdx.y;
  const int chunk_vec = PILOSA_RUN_VEC / chunks;
  if constexpr (kTable) {
    const int span = 16 / chunks;  // containers of the chunk
    for (int i = threadIdx.x; i < num_leaves * span; i += PILOSA_THREADS) {
      const int l = i / span, j = i - l * span;
      const int* r = args.row[b * num_leaves + l];
      const int k = r != nullptr ? __ldg(r + s0 * 16 + c * span + j) : -1;
      lp[l * 16 + j] = k < 0 ? nullptr
                             : args.base[l] + s0 * args.slice_stride[l] +
                                   (long long)k * PILOSA_CONTAINER_VEC;
    }
  } else if (threadIdx.x < num_leaves) {
    const int l = threadIdx.x;
    const long long slot = (long long)b * num_leaves + l;
    const int st = uniform ? starts[slot] : starts[slot * num_slices + s0];
    lp[l] = st < 0 ? nullptr
                   : args.base[l] + s0 * args.slice_stride[l] +
                         (long long)st * PILOSA_RUN_VEC + c * chunk_vec;
  }
  __syncthreads();
  const int iters = chunk_vec / K1_STEP_VEC;
  const int nl = args.n;

  // The load cursor runs two steps ahead of the fold: slice j, step i of
  // the chunk, leaf step k.
  int lj = 0, li = 0, lk = 0;
  auto issue = [&](Lanes& v) {
    if (lj < t) {  // block-uniform
      const int l = args.w[lk] & 255;
      if constexpr (kTable) {
        // Step i covers containers 2i and 2i + 1 of the chunk.
        load_pair(lp[l * 16 + 2 * li], v[0], v[1]);
        load_pair(lp[l * 16 + 2 * li + 1], v[2], v[3]);
      } else {
        const uint4* r = lp[l];
        if (r != nullptr) {
          r += lj * args.slice_stride[l] + threadIdx.x + li * K1_STEP_VEC;
#pragma unroll
          for (int u = 0; u < K1_UNROLL; ++u)
            v[u] = __ldg(r + u * PILOSA_THREADS);
        } else {
#pragma unroll
          for (int u = 0; u < K1_UNROLL; ++u) v[u] = zero4();
        }
      }
      if (++lk == nl) {
        lk = 0;
        if (++li == iters) li = 0, ++lj;
      }
    }
  };

  Lanes acc, saved[PILOSA_MAX_DEPTH];
  int sp = 0, count = 0;
  int fj = 0, fi = 0, fk = 0;  // the fold's cursor
  auto fold_step = [&](Lanes& v) {
    apply_step(args.w[fk], acc, v, saved, sp);
    issue(v);  // v is free again: it takes the step two ahead
    if (++fk == nl) {
      fk = 0;
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) count += popc4(acc[u]);
      if (++fi == iters) {  // block-uniform: the chunk of slice fj is done
        fi = 0;
        const int sum = block_sum(count, red);
        count = 0;
        if (threadIdx.x == 0) {
          int* o = out + (long long)b * num_slices + s0 + fj;
          if (chunks == 1)
            *o = sum;
          else
            atomicAdd(o, sum);
        }
        ++fj;
      }
    }
  };

  Lanes va, vb;
  issue(va);
  issue(vb);
  const int total = t * iters * nl;
  for (int g = 0; g < total; g += 2) {
    fold_step(va);
    if (g + 1 < total) fold_step(vb);
  }
}

// Host: 0 when every step reads a leaf below num_leaves and its saves
// and combines keep 0 .. PILOSA_MAX_DEPTH - 1 values saved, ending at 0;
// else a cudaError_t.
static inline int coarse_check_steps(const unsigned* w, int n,
                                     int num_leaves) {
  if (n < 1 || n > PILOSA_MAX_PROG) return (int)cudaErrorInvalidValue;
  int sp = 0;
  for (int k = 0; k < n; ++k) {
    if ((int)(w[k] & 255) >= num_leaves || (k == 0 && (w[k] >> 8 & 7) != 0))
      return (int)cudaErrorInvalidValue;
    sp += (w[k] >> 10) & 1;
    const int pops = (w[k] >> 11) & 15;
    if (sp > PILOSA_MAX_DEPTH - 1 || pops > sp)
      return (int)cudaErrorInvalidValue;
    sp -= pops;
  }
  return sp == 0 ? 0 : (int)cudaErrorInvalidValue;
}

// Host: the fold's part of the argument block.
template <int kLeaves, int kSteps>
static inline void fill_tile_args(TileArgs<kLeaves, kSteps>& args,
                                  const void* const* bases,
                                  const long long* strides, int num_leaves,
                                  const unsigned* step_words,
                                  int num_steps) {
  for (int i = 0; i < kLeaves; ++i) {
    args.base[i] = i < num_leaves ? (const uint4*)bases[i] : nullptr;
    args.slice_stride[i] = i < num_leaves ? strides[i] : 0;
  }
  args.n = num_steps;
  for (int i = 0; i < kSteps; ++i)
    args.w[i] = i < num_steps ? step_words[i] : 0u;
}

// Host: checks the tiling and the steps, and zeroes out when chunks add
// into it. Returns 0 or a cudaError_t.
static inline int tiles_prologue(int num_leaves, int batch, int num_slices,
                                 int chunks, int t, int uniform,
                                 const unsigned* step_words, int num_steps,
                                 int* out, cudaStream_t s) {
  if (num_leaves < 1 || num_leaves > PILOSA_MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  int rc = coarse_check_steps(step_words, num_steps, num_leaves);
  if (rc != 0) return rc;
  if (batch < 1 || batch > 65535 || num_slices < 1 || chunks < 1 ||
      chunks > K1_MAX_CHUNKS || (chunks & (chunks - 1)) != 0 || t < 1 ||
      t > K1_MAX_T || (t & (t - 1)) != 0 || num_slices % t != 0 ||
      (t > 1 && !uniform) ||
      (long long)(num_slices / t) * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (chunks > 1)
    return (int)cudaMemsetAsync(out, 0, sizeof(int) * (size_t)batch *
                                            (size_t)num_slices, s);
  return 0;
}

template <int kLeaves, int kSteps>
static inline int coarse_tiles_grid(const void* const* bases,
                                    const long long* strides, int num_leaves,
                                    const int* starts, int uniform,
                                    int batch, int num_slices, int chunks,
                                    int t, const unsigned* step_words,
                                    int num_steps, int* out,
                                    cudaStream_t stream) {
  TileArgs<kLeaves, kSteps> args;
  fill_tile_args(args, bases, strides, num_leaves, step_words, num_steps);
  dim3 grid((unsigned)(num_slices / t * chunks), (unsigned)batch);
  coarse_tiles_kernel<TileArgs<kLeaves, kSteps>, false>
      <<<grid, PILOSA_THREADS, 0, stream>>>(args, starts, uniform,
                                            num_leaves, num_slices, chunks,
                                            t, out);
  return (int)cudaGetLastError();
}

// Host, run mode (K1, K6): checks the tiling, zeroes out when chunks add
// into it, and launches one grid.
static inline int coarse_tiles_launch(
    const void* const* bases, const long long* strides, int num_leaves,
    const int* starts, int uniform, int batch, int num_slices, int chunks,
    int t, const unsigned* step_words, int num_steps, int* out,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = tiles_prologue(num_leaves, batch, num_slices, chunks, t, uniform,
                          step_words, num_steps, out, s);
  if (rc != 0) return rc;
  if (num_leaves <= K1_SMALL_LEAVES && num_steps <= K1_SMALL_STEPS)
    return coarse_tiles_grid<K1_SMALL_LEAVES, K1_SMALL_STEPS>(
        bases, strides, num_leaves, starts, uniform, batch, num_slices,
        chunks, t, step_words, num_steps, out, s);
  return coarse_tiles_grid<PILOSA_MAX_LEAVES, PILOSA_MAX_PROG>(
      bases, strides, num_leaves, starts, uniform, batch, num_slices, chunks,
      t, step_words, num_steps, out, s);
}

template <int kLeaves, int kSteps, int kRows>
static inline int table_tiles_grid(const void* const* bases,
                                   const long long* strides, int num_leaves,
                                   const void* const* rows, int batch,
                                   int num_slices, int chunks,
                                   const unsigned* step_words, int num_steps,
                                   int* out, cudaStream_t stream) {
  TableArgs<kLeaves, kSteps, kRows> args;
  fill_tile_args(args, bases, strides, num_leaves, step_words, num_steps);
  const int n_rows = batch * num_leaves;
  for (int i = 0; i < kRows; ++i)
    args.row[i] = i < n_rows ? (const int*)rows[i] : nullptr;
  dim3 grid((unsigned)(num_slices * chunks), (unsigned)batch);
  coarse_tiles_kernel<TableArgs<kLeaves, kSteps, kRows>, true>
      <<<grid, PILOSA_THREADS, 0, stream>>>(args, nullptr, 0, num_leaves,
                                            num_slices, chunks, 1, out);
  return (int)cudaGetLastError();
}

// Host, table mode (K3): rows holds batch * num_leaves device pointers,
// rows[b * L + l] the (S, 16) int32 index slab of query b's leaf l
// (nullptr: an absent leaf), up to K3_MAX_ROWS.
static inline int table_tiles_launch(const void* const* bases,
                                     const long long* strides,
                                     int num_leaves, const void* const* rows,
                                     int batch, int num_slices, int chunks,
                                     const unsigned* step_words,
                                     int num_steps, int* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = tiles_prologue(num_leaves, batch, num_slices, chunks, 1, 0,
                          step_words, num_steps, out, s);
  if (rc != 0) return rc;
  const long long n_rows = (long long)batch * num_leaves;
  if (n_rows > K3_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (num_leaves <= K1_SMALL_LEAVES && num_steps <= K1_SMALL_STEPS &&
      n_rows <= K3_SMALL_ROWS)
    return table_tiles_grid<K1_SMALL_LEAVES, K1_SMALL_STEPS, K3_SMALL_ROWS>(
        bases, strides, num_leaves, rows, batch, num_slices, chunks,
        step_words, num_steps, out, s);
  return table_tiles_grid<PILOSA_MAX_LEAVES, PILOSA_MAX_PROG, K3_MAX_ROWS>(
      bases, strides, num_leaves, rows, batch, num_slices, chunks,
      step_words, num_steps, out, s);
}
