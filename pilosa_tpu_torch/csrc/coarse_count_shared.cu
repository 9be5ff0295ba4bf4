// K2 coarse_count_shared: B queries of one tree shape over U unique
// whole-row leaves, each unique row run read from memory once.
//
// Replaces the Pallas kernels coarse_count_batch_per_slice and
// coarse_count_shared_uniform (pilosa_tpu/ops/kernels.py).
//
// Bound on an H100 SXM: bytes, and the bytes scale with U, not B*L. The
// headline batch (16 pairs over 8 dense rows of 960 slices) reads the
// 1.01 GB pool once: 0.30 ms at 3.35 TB/s, where K1 would read 4.03 GB.
//
// Design: one block per slice. At each 16-byte position a thread loads
// the U unique words once into registers, then evaluates all B folds
// from them through the leaf map (query b, leaf position l) -> unique
// index, with B per-thread counters; one block reduction per query
// writes out[b, s]. The map is uniform across the block, so picking a
// unique word is a uniform branch, not an indexed (local memory) load.
// B <= 16 and U <= 16; the wrapper raises beyond that.
#include "fold.cuh"

struct LeafMap {
  unsigned char u[PILOSA_MAX_BATCH * PILOSA_MAX_LEAVES];
};

// w[u] for a block-uniform u, by a uniform branch on u: every index into
// w is a constant, so the U words stay in registers.
#define PILOSA_PICK_CASE(c) \
  case c:                   \
    return w[c];
__device__ __forceinline__ uint4 pick(const uint4 (&w)[PILOSA_MAX_LEAVES],
                                      int u) {
  switch (u) {
    PILOSA_PICK_CASE(0) PILOSA_PICK_CASE(1) PILOSA_PICK_CASE(2)
    PILOSA_PICK_CASE(3) PILOSA_PICK_CASE(4) PILOSA_PICK_CASE(5)
    PILOSA_PICK_CASE(6) PILOSA_PICK_CASE(7) PILOSA_PICK_CASE(8)
    PILOSA_PICK_CASE(9) PILOSA_PICK_CASE(10) PILOSA_PICK_CASE(11)
    PILOSA_PICK_CASE(12) PILOSA_PICK_CASE(13) PILOSA_PICK_CASE(14)
    PILOSA_PICK_CASE(15)
  }
  return zero4();
}

__global__ void __launch_bounds__(PILOSA_THREADS)
coarse_count_shared_kernel(const __grid_constant__ Pools pools,
                           const int* __restrict__ starts, int uniform,
                           int num_unique, int num_slices,
                           const __grid_constant__ Prog prog,
                           const __grid_constant__ LeafMap map, int batch,
                           int* __restrict__ out) {
  __shared__ int red[32];
  __shared__ const uint4* run[PILOSA_MAX_LEAVES];
  const int s = blockIdx.x;
  if (threadIdx.x < num_unique) {
    const int u = threadIdx.x;
    const int st = uniform ? starts[u] : starts[(long long)u * num_slices + s];
    run[u] = st < 0 ? nullptr
                    : pools.base[u] + s * pools.slice_stride[u] +
                          (long long)st * PILOSA_RUN_VEC;
  }
  __syncthreads();
  int cnt[PILOSA_MAX_BATCH];
#pragma unroll
  for (int q = 0; q < PILOSA_MAX_BATCH; ++q) cnt[q] = 0;
  for (int i = threadIdx.x; i < PILOSA_RUN_VEC; i += blockDim.x) {
    uint4 w[PILOSA_MAX_LEAVES];
#pragma unroll
    for (int u = 0; u < PILOSA_MAX_LEAVES; ++u) {
      const uint4* r = u < num_unique ? run[u] : nullptr;
      w[u] = r != nullptr ? __ldg(r + i) : zero4();
    }
#pragma unroll
    for (int q = 0; q < PILOSA_MAX_BATCH; ++q) {
      if (q < batch) {
        const unsigned char* m = map.u + q * PILOSA_MAX_LEAVES;
        cnt[q] += popc4(fold(prog, [&](int l) { return pick(w, m[l]); }));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PILOSA_MAX_BATCH; ++q) {
    if (q < batch) {  // uniform across the block: every thread reduces
      const int total = block_sum(cnt[q], red);
      if (threadIdx.x == 0) out[(long long)q * num_slices + s] = total;
    }
  }
}

// starts: device int32, (num_unique,) when uniform else (num_unique,
// num_slices); leaf_map: host bytes, batch rows of num_leaves unique
// indices; out: device int32 (batch, num_slices).
extern "C" int pilosa_coarse_count_shared(
    const void* const* bases, const long long* strides, int num_unique,
    const int* starts, int uniform, int num_slices, const unsigned char* ops,
    int prog_len, int num_leaves, const unsigned char* leaf_map, int batch,
    int* out, void* stream) {
  Pools pools;
  Prog prog;
  int rc = pilosa_pack(bases, strides, num_unique, ops, prog_len, &pools,
                       &prog);
  if (rc != 0) return rc;
  if (batch < 1 || batch > PILOSA_MAX_BATCH || num_leaves < 1 ||
      num_leaves > PILOSA_MAX_LEAVES || num_slices < 1)
    return (int)cudaErrorInvalidValue;
  LeafMap map;
  for (int q = 0; q < PILOSA_MAX_BATCH; ++q)
    for (int l = 0; l < PILOSA_MAX_LEAVES; ++l) {
      const int u = q < batch && l < num_leaves ? leaf_map[q * num_leaves + l] : 0;
      if (u >= num_unique) return (int)cudaErrorInvalidValue;
      map.u[q * PILOSA_MAX_LEAVES + l] = (unsigned char)u;
    }
  coarse_count_shared_kernel<<<num_slices, PILOSA_THREADS, 0,
                               (cudaStream_t)stream>>>(
      pools, starts, uniform, num_unique, num_slices, prog, map, batch, out);
  return (int)cudaGetLastError();
}
