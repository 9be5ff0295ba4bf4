// K6 coarse_count_blocked: per-slice popcount of a bitmap-op tree over
// uniform 16-container row runs, T consecutive slices per tile; and
// stream_popcount, the popcount of a whole pool, the card's streaming
// ceiling for the same words.
//
// coarse_count_blocked replaces the Pallas kernel of the bandwidth probe
// (tools/probe_r5_bw.py:82, coarse_count_uniform, kernel :40-52): its
// grid step fetches T consecutive slices of every leaf at one row-run
// index per leaf. It lies only on the probe path, which sweeps T.
//
// stream_popcount stands in for the XLA whole-pool popcount that the JAX
// probes take as their ceiling (tools/probe_r5_bw.py:144-149). torch has
// no popcount op, and a ceiling has to come from a kernel that reads each
// byte once.
//
// Bound on an H100 SXM: bytes. K6 reads L x 128 KB per slice once (a
// pair over 960 slices: 252 MB, 75 us at 3.35 TB/s); the stream reads
// the pool once. The fold and __popc are a few integer ops per 16 bytes.
//
// Design. K6 v2 runs K1's tiled fold (coarse_tiles.cuh) with t = T: a
// tile is T consecutive slices of one chunk of the run, and the host
// picks the chunk count C from S / T and the SM count, so T is a tiling
// choice and no longer sets how much of the card is busy (v1, one block
// per T slices, ran T = 32 over 960 slices as 30 blocks at 7% of the
// bound). Each thread keeps 128 bytes in flight, and the loads run on
// across the slices of its tile; each slice's block sum is stored, or
// added with one integer atomicAdd into the zeroed out[0, s] when C > 1:
// exact, and the same every run.
// stream_popcount: a grid-stride loop of four 16-byte loads a thread,
// one int64 partial per block, then a single block sums the partials in
// a fixed order, so the total is deterministic too.
#include "coarse_tiles.cuh"

// starts: device int32 (num_leaves,), one run index per leaf, negative =
// absent; t: one of 1, 2, 4, 8, 16, 32, dividing num_slices; chunks: 1,
// 2, 4 or 8 (ops/kernels.py coarse_tiles); out: device int32
// (1, num_slices), zeroed here (cudaMemsetAsync) when chunks > 1.
extern "C" int pilosa_coarse_count_blocked(const void* const* bases,
                                           const long long* strides,
                                           int num_leaves, const int* starts,
                                           int num_slices, int t, int chunks,
                                           const unsigned* steps,
                                           int num_steps, int* out,
                                           void* stream) {
  return coarse_tiles_launch(bases, strides, num_leaves, starts, 1, 1,
                             num_slices, chunks, t, steps, num_steps,
                             out, stream);
}

__device__ __forceinline__ long long block_sum64(long long v,
                                                 long long* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(PILOSA_THREADS)
stream_popcount_kernel(const uint4* __restrict__ pool, long long n_vec,
                       const unsigned* __restrict__ tail, int n_tail,
                       long long* __restrict__ partials) {
  __shared__ long long red[32];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long count = 0;
  for (; i + 3 * stride < n_vec; i += 4 * stride) {
    const uint4 a = __ldg(pool + i);
    const uint4 b = __ldg(pool + i + stride);
    const uint4 c = __ldg(pool + i + 2 * stride);
    const uint4 d = __ldg(pool + i + 3 * stride);
    count += popc4(a) + popc4(b) + popc4(c) + popc4(d);
  }
  for (; i < n_vec; i += stride) count += popc4(__ldg(pool + i));
  if (blockIdx.x == 0 && threadIdx.x < n_tail)
    count += __popc(__ldg(tail + threadIdx.x));
  count = block_sum64(count, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = count;
}

__global__ void __launch_bounds__(PILOSA_THREADS)
sum_partials_kernel(const long long* __restrict__ partials, int n,
                    long long* __restrict__ out) {
  __shared__ long long red[32];
  long long v = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += partials[i];
  v = block_sum64(v, red);
  if (threadIdx.x == 0) *out = v;
}

// pool: device words, 16-byte aligned, n_words 32-bit words; partials:
// device int64 scratch of num_blocks; out: device int64 scalar.
extern "C" int pilosa_stream_popcount(const void* pool, long long n_words,
                                      long long* partials, int num_blocks,
                                      long long* out, void* stream) {
  if (n_words < 1 || num_blocks < 1 || num_blocks > 65535 ||
      ((unsigned long long)pool & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_vec = n_words / 4;
  const int n_tail = (int)(n_words % 4);
  cudaStream_t s = (cudaStream_t)stream;
  stream_popcount_kernel<<<num_blocks, PILOSA_THREADS, 0, s>>>(
      (const uint4*)pool, n_vec, (const unsigned*)pool + 4 * n_vec, n_tail,
      partials);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, PILOSA_THREADS, 0, s>>>(partials, num_blocks, out);
  return (int)cudaGetLastError();
}
