// K6 coarse_count_blocked: per-slice popcount of a bitmap-op tree over
// uniform 16-container row runs, T consecutive slices per block; and
// stream_popcount, the popcount of a whole pool, the card's streaming
// ceiling for the same words.
//
// coarse_count_blocked replaces the Pallas kernel of the bandwidth probe
// (tools/probe_r5_bw.py:82, coarse_count_uniform, kernel :40-52): its
// grid step fetches T consecutive slices of every leaf at one row-run
// index per leaf. It lies only on the probe path, which sweeps T; the
// serving path keeps K1 (one block per slice).
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
// Design. K6: grid (S / T); block g folds slices g*T .. g*T + T - 1 in
// turn, each with K1's walk (16-byte loads, neighbouring threads on
// neighbouring addresses, the fold program of fold.cuh in registers)
// and one block reduction per slice into out[0, s]. No atomics, so the
// result is the same from run to run. Fewer, longer blocks keep fewer
// loads in flight at a time; that is what the probe measures.
// stream_popcount: a grid-stride loop of four 16-byte loads a thread,
// one int64 partial per block, then a single block sums the partials in
// a fixed order, so the total is deterministic too.
#include "fold.cuh"

__global__ void __launch_bounds__(PILOSA_THREADS)
coarse_count_blocked_kernel(const __grid_constant__ Pools pools,
                            const int* __restrict__ starts, int num_leaves,
                            int t, const __grid_constant__ Prog prog,
                            int* __restrict__ out) {
  __shared__ int red[32];
  __shared__ const uint4* run[PILOSA_MAX_LEAVES];
  const long long s0 = (long long)blockIdx.x * t;
  if (threadIdx.x < num_leaves) {
    const int l = threadIdx.x;
    const int st = starts[l];
    run[l] = st < 0 ? nullptr
                    : pools.base[l] + s0 * pools.slice_stride[l] +
                          (long long)st * PILOSA_RUN_VEC;
  }
  __syncthreads();
  for (int j = 0; j < t; ++j) {
    int count = 0;
    for (int i = threadIdx.x; i < PILOSA_RUN_VEC; i += blockDim.x) {
      count += popc4(fold(prog, [&](int l) {
        const uint4* r = run[l];
        return r != nullptr ? __ldg(r + j * pools.slice_stride[l] + i)
                            : zero4();
      }));
    }
    count = block_sum(count, red);
    if (threadIdx.x == 0) out[s0 + j] = count;
  }
}

// starts: device int32 (num_leaves,), one run index per leaf, negative =
// absent; out: device int32 (1, num_slices). t must divide num_slices
// and be one of 1, 2, 4, 8, 16, 32.
extern "C" int pilosa_coarse_count_blocked(const void* const* bases,
                                           const long long* strides,
                                           int num_leaves, const int* starts,
                                           int num_slices, int t,
                                           const unsigned short* ops,
                                           int prog_len, int* out,
                                           void* stream) {
  Pools pools;
  Prog prog;
  int rc = pilosa_pack(bases, strides, num_leaves, ops, prog_len, &pools,
                       &prog);
  if (rc != 0) return rc;
  if (t < 1 || t > 32 || (t & (t - 1)) != 0 || num_slices < 1 ||
      num_slices % t != 0)
    return (int)cudaErrorInvalidValue;
  coarse_count_blocked_kernel<<<num_slices / t, PILOSA_THREADS, 0,
                                (cudaStream_t)stream>>>(
      pools, starts, num_leaves, t, prog, out);
  return (int)cudaGetLastError();
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
