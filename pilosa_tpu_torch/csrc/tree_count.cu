// K3 tree_count: per-(query, slice) popcount of a bitmap-op tree over a
// per-container gather, for rows that are not staged as whole aligned
// runs (partial rows, rows missing containers in some slices).
//
// Replaces the Pallas kernel _tree_count_call / tree_count_pallas
// (pilosa_tpu/ops/kernels.py).
//
// Bound on an H100 SXM: bytes. Each present container (hit != 0) is read
// once, 8 KB, plus 8 bytes of idx/hit per (leaf, slice, sub-key); an
// absent one is a zero that reads nothing.
//
// Design: one block per (slice s, query b). For each of the 16 sub-keys
// one thread per leaf reads idx[b, l, s, j] and hit[b, l, s, j] into a
// shared pointer table, then the block walks the 8 KB of the gathered
// containers with 16-byte loads, folds, popcounts, and reduces once per
// block into out[b, s]. The TPU kernel's SMEM
// slab loop over slices has no counterpart: a block reads its own
// indices.
#include "fold.cuh"

__global__ void __launch_bounds__(PILOSA_THREADS)
tree_count_kernel(const __grid_constant__ Pools pools,
                  const int* __restrict__ idx, const int* __restrict__ hit,
                  int num_leaves, int num_slices,
                  const __grid_constant__ Prog prog, int* __restrict__ out) {
  __shared__ int red[32];
  __shared__ const uint4* cont[PILOSA_MAX_LEAVES];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  int count = 0;
  for (int j = 0; j < 16; ++j) {
    if (threadIdx.x < num_leaves) {
      const int l = threadIdx.x;
      const long long t =
          (((long long)b * num_leaves + l) * num_slices + s) * 16 + j;
      cont[l] = hit[t] != 0 ? pools.base[l] + s * pools.slice_stride[l] +
                                  (long long)idx[t] * PILOSA_CONTAINER_VEC
                            : nullptr;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < PILOSA_CONTAINER_VEC; i += blockDim.x) {
      count += popc4(fold(prog, [&](int l) {
        const uint4* c = cont[l];
        return c != nullptr ? __ldg(c + i) : zero4();
      }));
    }
    __syncthreads();  // cont is rewritten for the next sub-key
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0) out[(long long)b * num_slices + s] = count;
}

// idx, hit: device int32 (batch, num_leaves, num_slices, 16);
// out: device int32 (batch, num_slices).
extern "C" int pilosa_tree_count(const void* const* bases,
                                 const long long* strides, int num_leaves,
                                 const int* idx, const int* hit, int batch,
                                 int num_slices, const unsigned short* ops,
                                 int prog_len, int* out, void* stream) {
  Pools pools;
  Prog prog;
  int rc = pilosa_pack(bases, strides, num_leaves, ops, prog_len, &pools,
                       &prog);
  if (rc != 0) return rc;
  if (batch < 1 || batch > 65535 || num_slices < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(num_slices, batch);
  tree_count_kernel<<<grid, PILOSA_THREADS, 0, (cudaStream_t)stream>>>(
      pools, idx, hit, num_leaves, num_slices, prog, out);
  return (int)cudaGetLastError();
}
