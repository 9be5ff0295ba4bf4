// K1 coarse_count: per-(query, slice) popcount of a bitmap-op tree over
// whole 16-container row runs.
//
// Replaces the Pallas kernels coarse_count_per_slice,
// coarse_count_identity_batch, coarse_count_uniform and
// coarse_count_uniform_batch (pilosa_tpu/ops/kernels.py).
//
// Bound on an H100 SXM: bytes. Each (query, slice, leaf) reads one
// 128 KB row run once; a lone pair over 960 slices moves 252 MB, 75 us
// at 3.35 TB/s. The fold and __popc are a few integer ops per 16 bytes.
//
// Design: one block per (slice s, query b). The row-run start comes
// from a (B*L, S) table or, for the uniform layout, one scalar per
// (query, leaf); a negative start is an absent leaf that reads nothing.
// The block's leaf pointers sit in shared memory. Each thread walks the
// run with 16-byte loads, neighbouring threads on neighbouring addresses,
// folds the leaves in a register accumulator and popcounts;
// a block reduction writes out[b, s]. No atomics, so the result is the
// same from run to run. The TPU kernel's multi-slice blocks and scalar
// prefetch tables are TPU artefacts and have no counterpart here.
#include "fold.cuh"

__global__ void __launch_bounds__(PILOSA_THREADS)
coarse_count_kernel(const __grid_constant__ Pools pools,
                    const int* __restrict__ starts, int uniform,
                    int num_leaves, int num_slices,
                    const __grid_constant__ Prog prog,
                    int* __restrict__ out) {
  __shared__ int red[32];
  __shared__ const uint4* run[PILOSA_MAX_LEAVES];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  if (threadIdx.x < num_leaves) {
    const int l = threadIdx.x;
    const long long slot = (long long)b * num_leaves + l;
    const int st = uniform ? starts[slot] : starts[slot * num_slices + s];
    run[l] = st < 0 ? nullptr
                    : pools.base[l] + s * pools.slice_stride[l] +
                          (long long)st * PILOSA_RUN_VEC;
  }
  __syncthreads();
  int count = 0;
  for (int i = threadIdx.x; i < PILOSA_RUN_VEC; i += blockDim.x) {
    count += popc4(fold(prog, [&](int l) {
      const uint4* r = run[l];
      return r != nullptr ? __ldg(r + i) : zero4();
    }));
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0) out[(long long)b * num_slices + s] = count;
}

// starts: device int32, (batch*num_leaves,) when uniform else
// (batch*num_leaves, num_slices); out: device int32 (batch, num_slices).
extern "C" int pilosa_coarse_count(const void* const* bases,
                                   const long long* strides, int num_leaves,
                                   const int* starts, int uniform, int batch,
                                   int num_slices, const unsigned char* ops,
                                   int prog_len, int* out, void* stream) {
  Pools pools;
  Prog prog;
  int rc = pilosa_pack(bases, strides, num_leaves, ops, prog_len, &pools,
                       &prog);
  if (rc != 0) return rc;
  if (batch < 1 || batch > 65535 || num_slices < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(num_slices, batch);
  coarse_count_kernel<<<grid, PILOSA_THREADS, 0, (cudaStream_t)stream>>>(
      pools, starts, uniform, num_leaves, num_slices, prog, out);
  return (int)cudaGetLastError();
}
