// K2 coarse_count_shared: B queries of one tree shape over U unique
// whole-row runs, each unique run read from memory once a slice.
//
// Replaces the Pallas kernels coarse_count_batch_per_slice
// (pilosa_tpu/ops/kernels.py:566, call :614) and
// coarse_count_shared_uniform (:638, call :668).
//
// Bound on an H100 SXM: bytes, and the bytes scale with U, not B*L. The
// headline batch (16 pairs over 8 dense rows of 960 slices) reads the
// 1.01 GB pool once: 0.3005 ms at 3.35 TB/s, where K1 would read 4.03 GB.
//
// What held v2 back (measured on the card): one block a slice (7.3
// waves of 960 blocks) at 97 registers a thread, so two blocks an SM;
// at every 16-byte position a thread loaded the U words into registers,
// then ran the fold interpreter once per query, each leaf picked through
// the leaf map and a 16-way switch over the registers, with the loads of
// the next position waiting on all 16 folds. It ran at 31% of the bound
// (0.9647 ms).
//
// v3:
// - The grid is persistent (as many 256-thread blocks as fit, one or two
//   an SM) and walks tiles of (slice, 256 positions of the run), an
//   equal contiguous range of tiles a block, so every SM does the same
//   work whatever the slice count.
// - The U runs stream through a ring of 3 to 8 stages in shared memory
//   with 16-byte cp.async copies, so two or more tiles are in flight
//   while one is folded. A thread copies exactly the positions it later
//   folds, so it waits on its own copies only and the loop has no
//   barrier. An absent run (start -1) is written as zeros.
// - Each query's program arrives with its unique indices folded in on
//   the host (ops/kernels.py shared_programs), so a leaf op names the
//   unique run and its word is picked by a computed shared address: no
//   leaf map, no switch.
// - The op loop is outside and the queries inside it: an op's kind is
//   decoded once for 8 or 16 queries, whose accumulators (and first
//   saved level) sit in registers and fold independently. Up to 8 runs
//   the queries go in passes of 8, so a thread holds ~125 registers and
//   two blocks share an SM; above 8 the ring takes a whole SM, and one
//   pass folds all 16.
// - Counts are summed per warp when a block's range leaves a slice and
//   added into the zeroed out[b, s] with one atomicAdd per warp and
//   query: integer addition, so the result is exact and the same every
//   run.
// B <= 16 and U <= 16 (PILOSA_SHARED_LEAVES); the wrapper raises beyond
// that, and the serving path sends wider batches to K1.
#include <mutex>

#include "fold.cuh"

// A query's program: at most 16 leaf ops and a push and a combine for
// each of at most 15 nested operands.
#define K2_MAX_PROG 48

struct SharedRuns {
  const uint4* base[PILOSA_SHARED_LEAVES];
  long long slice_stride[PILOSA_SHARED_LEAVES];  // uint4 vectors
};

struct SharedProgs {
  int n;
  unsigned short op[PILOSA_MAX_BATCH * K2_MAX_PROG];  // query q at q * 48
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One leaf op of the pass's queries: acc[q] = w or acc[q] op= w, where w
// is the word of query q's unique run at this thread's position of the
// tile; off holds the queries' run offsets in uint4 units.
template <int kKind, int kPass>
__device__ __forceinline__ void leaf_op(uint4 (&acc)[kPass],
                                        const uint4* tile, const int* off,
                                        int nq) {
  int o[kPass];
#pragma unroll
  for (int i = 0; i < kPass / 4; ++i) {
    const int4 v = ((const int4*)off)[i];
    o[4 * i] = v.x, o[4 * i + 1] = v.y, o[4 * i + 2] = v.z, o[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < kPass; ++q) {
    if (q < nq) {
      const uint4 w = tile[o[q]];
      acc[q] = kKind == 0 ? w : combine(kKind, acc[q], w);
    }
  }
}

// kPass queries are folded in one pass over a tile, their accumulators
// and first saved level in registers; the register budget is set for
// kMinBlocks blocks an SM.
template <int kStages, int kPass, int kMinBlocks>
__global__ void __launch_bounds__(PILOSA_THREADS, kMinBlocks)
coarse_count_shared_kernel(const __grid_constant__ SharedRuns runs,
                           const int* __restrict__ starts, int num_unique,
                           int num_slices,
                           const __grid_constant__ SharedProgs progs,
                           int batch, int* __restrict__ out) {
  extern __shared__ __align__(16) uint4 ring[];
  // Per op: its kind, and the run offset of each query's leaf.
  __shared__ __align__(16) int offs[K2_MAX_PROG][PILOSA_MAX_BATCH];
  __shared__ unsigned char kinds[K2_MAX_PROG];
  constexpr int kTilesPerSlice = PILOSA_RUN_VEC / PILOSA_THREADS;
  const int stage_vec = num_unique * PILOSA_THREADS;
  const int tid = threadIdx.x;
  const int n = progs.n;

  const long long tiles = (long long)num_slices * kTilesPerSlice;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  if (t0 >= t1) return;
  for (int i = tid; i < K2_MAX_PROG * PILOSA_MAX_BATCH; i += PILOSA_THREADS) {
    const int k = i / PILOSA_MAX_BATCH, q = i % PILOSA_MAX_BATCH;
    const int op = k < n ? progs.op[q * K2_MAX_PROG + k] : 0;
    offs[k][q] = (op >> 8) < 4 ? (op & 255) * PILOSA_THREADS : 0;
    if (q == 0) kinds[k] = (unsigned char)(op >> 8);
  }
  __syncthreads();

  // Issues tile t's copies into stage st: this thread's position of every
  // unique run, zeros for an absent run. A thread folds only what it
  // copied, so it waits on its own copies and needs no barrier.
  auto issue = [&](long long t, int st) {
    if (t < t1) {
      const int s = (int)(t / kTilesPerSlice);
      const int off = (int)(t % kTilesPerSlice) * PILOSA_THREADS + tid;
      uint4* dst = ring + st * stage_vec + tid;
      for (int u = 0; u < num_unique; ++u) {
        const int start = starts[(long long)u * num_slices + s];
        if (start < 0) {
          dst[u * PILOSA_THREADS] = zero4();
        } else {
          cp_async16(dst + u * PILOSA_THREADS,
                     runs.base[u] + s * runs.slice_stride[u] +
                         (long long)start * PILOSA_RUN_VEC + off);
        }
      }
    }
    cp_commit();  // one group a tile, empty or not, so the waits line up
  };

  int cnt[PILOSA_MAX_BATCH];
#pragma unroll
  for (int q = 0; q < PILOSA_MAX_BATCH; ++q) cnt[q] = 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(t0 + i, i);

  int st = 0;
  for (long long t = t0; t < t1; ++t) {
    issue(t + kStages - 1, st == 0 ? kStages - 1 : st - 1);
    cp_wait<kStages - 1>();  // this thread's copies of tile t have landed
    const uint4* tile = ring + st * stage_vec + tid;
#pragma unroll
    for (int h = 0; h < PILOSA_MAX_BATCH; h += kPass) {
      if (h < batch) {
        const int nq = min(kPass, batch - h);
        uint4 acc[kPass];    // each query's accumulator
        uint4 saved[kPass];  // the first nested level, in registers
        uint4 deep[PILOSA_MAX_DEPTH - 1][kPass];  // deeper levels
        int sp = 0;
        for (int k = 0; k < n; ++k) {
          const int kind = kinds[k];
          const int* o = offs[k] + h;
          switch (kind) {
            case 0: leaf_op<0, kPass>(acc, tile, o, nq); break;
            case 1: leaf_op<1, kPass>(acc, tile, o, nq); break;
            case 2: leaf_op<2, kPass>(acc, tile, o, nq); break;
            case 3: leaf_op<3, kPass>(acc, tile, o, nq); break;
            case 4:
              if (sp == 0) {
#pragma unroll
                for (int q = 0; q < kPass; ++q)
                  if (q < nq) saved[q] = acc[q];
              } else {
#pragma unroll
                for (int q = 0; q < kPass; ++q)
                  if (q < nq) deep[sp - 1][q] = acc[q];
              }
              ++sp;
              break;
            default:
              --sp;
              if (sp == 0) {
#pragma unroll
                for (int q = 0; q < kPass; ++q)
                  if (q < nq) acc[q] = combine(kind - 4, saved[q], acc[q]);
              } else {
#pragma unroll
                for (int q = 0; q < kPass; ++q)
                  if (q < nq)
                    acc[q] = combine(kind - 4, deep[sp - 1][q], acc[q]);
              }
          }
        }
#pragma unroll
        for (int q = 0; q < kPass; ++q)
          if (q < nq) cnt[h + q] += popc4(acc[q]);
      }
    }
    st = st + 1 == kStages ? 0 : st + 1;
    const int s = (int)(t / kTilesPerSlice);
    if (t + 1 == t1 || (t + 1) / kTilesPerSlice != s) {  // block-uniform
#pragma unroll
      for (int q = 0; q < PILOSA_MAX_BATCH; ++q) {
        if (q < batch) {
          const int v = __reduce_add_sync(0xffffffffu, cnt[q]);
          if ((tid & 31) == 0 && v != 0)
            atomicAdd(out + (long long)q * num_slices + s, v);
          cnt[q] = 0;
        }
      }
    }
  }
}

template <int kStages, int kPass, int kMinBlocks>
static int launch(const SharedRuns& runs, const int* starts, int num_unique,
                  int num_slices, const SharedProgs& progs, int batch,
                  int* out, cudaStream_t stream) {
  auto kernel = coarse_count_shared_kernel<kStages, kPass, kMinBlocks>;
  const int smem = kStages * num_unique * PILOSA_THREADS * 16;
  // The blocks that fit on the card at once, computed once per (card,
  // smem) for this form of the kernel.
  static std::mutex mu;
  static int last_dev = -1, last_smem = -1;
  static long long resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> hold(mu);
    if (dev != last_dev || smem != last_smem) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, PILOSA_THREADS, smem);
      if (err != cudaSuccess) return (int)err;
      last_dev = dev, last_smem = smem;
      resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    }
  }
  const long long tiles =
      (long long)num_slices * (PILOSA_RUN_VEC / PILOSA_THREADS);
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, PILOSA_THREADS, smem, stream>>>(runs, starts, num_unique,
                                                 num_slices, progs, batch,
                                                 out);
  return (int)cudaGetLastError();
}

// bases/strides: per unique run its pool and slice pitch (uint4 vectors);
// starts: device int32 (num_unique, num_slices) run index, negative =
// absent; progs: host, batch programs of prog_len ops each, leaf ops
// naming unique runs (ops/kernels.py shared_programs); out: device int32
// (batch, num_slices), zeroed by the caller.
extern "C" int pilosa_coarse_count_shared(
    const void* const* bases, const long long* strides, int num_unique,
    const int* starts, int num_slices, const unsigned short* progs,
    int prog_len, int batch, int* out, void* stream) {
  if (num_unique < 1 || num_unique > PILOSA_SHARED_LEAVES || batch < 1 ||
      batch > PILOSA_MAX_BATCH || prog_len < 1 || prog_len > K2_MAX_PROG ||
      num_slices < 1)
    return (int)cudaErrorInvalidValue;
  SharedRuns runs;
  for (int u = 0; u < PILOSA_SHARED_LEAVES; ++u) {
    runs.base[u] = u < num_unique ? (const uint4*)bases[u] : nullptr;
    runs.slice_stride[u] = u < num_unique ? strides[u] : 0;
  }
  SharedProgs p;
  p.n = prog_len;
  for (int q = 0; q < PILOSA_MAX_BATCH; ++q)
    for (int k = 0; k < K2_MAX_PROG; ++k) {
      // Queries past the batch repeat query 0: every query runs the
      // same shape, so the op kinds are read from query 0.
      const int src = q < batch ? q : 0;
      const unsigned short op = k < prog_len ? progs[src * prog_len + k] : 0;
      if ((op >> 8) < 4 && (op & 255) >= num_unique)
        return (int)cudaErrorInvalidValue;
      if (q > 0 && (op >> 8) != (p.op[k] >> 8))
        return (int)cudaErrorInvalidValue;  // not one tree shape
      p.op[q * K2_MAX_PROG + k] = op;
    }
  const cudaStream_t s = (cudaStream_t)stream;
  // Up to 8 runs: 8-query passes, two blocks an SM, a 96 KB ring each.
  // More runs: a ring of 3 x 64 KB fits one block an SM, which then folds
  // all 16 queries in one pass.
  if (num_unique > 8)
    return launch<3, 16, 1>(runs, starts, num_unique, num_slices, p, batch,
                            out, s);
  if (num_unique > 4)
    return launch<3, 8, 2>(runs, starts, num_unique, num_slices, p, batch,
                           out, s);
  if (num_unique > 2)
    return launch<6, 8, 2>(runs, starts, num_unique, num_slices, p, batch,
                           out, s);
  return launch<8, 8, 2>(runs, starts, num_unique, num_slices, p, batch, out,
                         s);
}
