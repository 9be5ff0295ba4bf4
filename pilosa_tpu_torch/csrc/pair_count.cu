// K5 pair_count: popcount(op(a, b)) summed to one int64, for op in
// and / or / xor / andnot, over packed words.
//
// Replaces the Pallas kernel _pallas_pair_count and its dispatcher
// fused_pair_count (pilosa_tpu/ops/kernels.py), which the JAX package
// runs once per plane of an integer field (pilosa_tpu/ops/bsi.py
// plane_counts). Two entry points share the op switch:
//
//   pilosa_pair_count: the Pallas function's own contract, two (M, 2048)
//     word blocks (b may be absent: plain popcount of a).
//   pilosa_pair_count_rows: the serving form. P row runs of one staged
//     pool, each addressed per (slice, sub-key) by a container index
//     (negative = absent, as K3 addresses containers), each paired with
//     one b operand over S slices: a row of a pool addressed the same
//     way, a materialized (S, 16, 2048) filter block, or nothing. One
//     int64 total per row: the per-plane counts of a Sum.
//
// Bound on an H100 SXM: bytes. Each input word is read once, a popcount
// and a bitwise op per 16 bytes is far below the card's integer rate.
// The Sum of a 16-bit field over 960 slices reads 18 row runs of
// 126 MB: 2.26 GB, 0.68 ms at 3.35 TB/s.
//
// Design, a streaming reduction: 16-byte loads with neighbouring threads
// on neighbouring addresses, __popc, a warp-then-block reduction, and one
// int64 atomicAdd per block. The flat form walks its words in a
// grid-stride loop over enough blocks to fill the card; the serving form
// runs one block per (row, slice) that reads its 16 container pointers
// into shared memory first. Absent containers read as zero and are not
// loaded. Integer atomics commute, so the result is the same every run.
// The Pallas kernel's SMEM scalar accumulator across grid steps and its
// zero-padding to a block multiple have no counterpart: blocks run in
// parallel, and the grid-stride loop ends exactly at M.
#include "fold.cuh"

enum { K5_AND = 0, K5_OR = 1, K5_XOR = 2, K5_ANDNOT = 3 };
// b operand of the serving form.
enum { K5_B_NONE = 0, K5_B_ROW = 1, K5_B_BLOCK = 2 };

template <int OP>
__device__ __forceinline__ uint4 pair_op(uint4 a, uint4 b) {
  if (OP == K5_AND) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  if (OP == K5_OR) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  if (OP == K5_XOR) return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// Block-wide sum of one 64-bit value per thread; the total lands in
// thread 0. Every thread of the block must call it.
__device__ __forceinline__ unsigned long long block_sum64(
    unsigned long long v, unsigned long long* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// HAS_B false: popcount(a). n: uint4 vectors in each operand.
template <int OP, bool HAS_B>
__global__ void __launch_bounds__(PILOSA_THREADS)
pair_count_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                  long long n, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long red[32];
  unsigned long long count = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint4 va = __ldg(a + i);
    count += popc4(HAS_B ? pair_op<OP>(va, __ldg(b + i)) : va);
  }
  count = block_sum64(count, red);
  if (threadIdx.x == 0 && count != 0) atomicAdd(out, count);
}

template <int OP, int BMODE>
__global__ void __launch_bounds__(PILOSA_THREADS)
pair_count_rows_kernel(const uint4* __restrict__ pool_a, long long stride_a,
                       const int* __restrict__ a_idx, int num_slices,
                       const uint4* __restrict__ pool_b, long long stride_b,
                       const int* __restrict__ b_idx,
                       const uint4* __restrict__ b_blk,
                       unsigned long long* __restrict__ out) {
  __shared__ unsigned long long red[32];
  __shared__ const uint4* ca[16];
  __shared__ const uint4* cb[16];
  const int p = blockIdx.x;
  const int s = blockIdx.y;
  if (threadIdx.x < 16) {
    const int j = threadIdx.x;
    const int ia = a_idx[((long long)p * num_slices + s) * 16 + j];
    ca[j] = ia < 0 ? nullptr
                   : pool_a + s * stride_a + (long long)ia * PILOSA_CONTAINER_VEC;
    const uint4* rb = nullptr;
    if (BMODE == K5_B_ROW) {
      const int ib = b_idx[s * 16 + j];
      rb = ib < 0 ? nullptr
                  : pool_b + s * stride_b + (long long)ib * PILOSA_CONTAINER_VEC;
    } else if (BMODE == K5_B_BLOCK) {
      rb = b_blk + ((long long)s * 16 + j) * PILOSA_CONTAINER_VEC;
    }
    cb[j] = rb;
  }
  __syncthreads();
  unsigned int count = 0;  // at most 2^20 bits per (row, slice)
  for (int j = 0; j < 16; ++j) {
    const uint4* ra = ca[j];
    const uint4* rb = cb[j];
    // Block-uniform: skip containers whose result is all zero.
    const bool zero_a = ra == nullptr;
    const bool zero_b = BMODE == K5_B_NONE || rb == nullptr;
    if (zero_a && (BMODE == K5_B_NONE || OP == K5_AND || OP == K5_ANDNOT ||
                   zero_b))
      continue;
    if (zero_b && BMODE != K5_B_NONE && OP == K5_AND) continue;
#pragma unroll
    for (int i = threadIdx.x; i < PILOSA_CONTAINER_VEC; i += PILOSA_THREADS) {
      const uint4 va = zero_a ? zero4() : __ldg(ra + i);
      if (BMODE == K5_B_NONE) {
        count += popc4(va);
      } else {
        const uint4 vb = zero_b ? zero4() : __ldg(rb + i);
        count += popc4(pair_op<OP>(va, vb));
      }
    }
  }
  const unsigned long long total = block_sum64(count, red);
  if (threadIdx.x == 0 && total != 0) atomicAdd(out + p, total);
}

template <int OP>
static int launch_flat(const uint4* a, const uint4* b, long long n,
                       unsigned long long* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + PILOSA_THREADS - 1) / PILOSA_THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  const int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  if (b != nullptr)
    pair_count_kernel<OP, true><<<blocks, PILOSA_THREADS, 0, stream>>>(a, b, n, out);
  else
    pair_count_kernel<OP, false><<<blocks, PILOSA_THREADS, 0, stream>>>(a, b, n, out);
  return (int)cudaGetLastError();
}

// a, b: device words, n_vec uint4 vectors each (b null: popcount of a);
// op 0 and, 1 or, 2 xor, 3 andnot; out: one device int64, zeroed by the
// caller, that the kernel adds to.
extern "C" int pilosa_pair_count(const void* a, const void* b, long long n_vec,
                                 int op, void* out, void* stream) {
  if (n_vec < 0 || op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  const uint4* pa = (const uint4*)a;
  const uint4* pb = (const uint4*)b;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case K5_AND: return launch_flat<K5_AND>(pa, pb, n_vec, o, st);
    case K5_OR: return launch_flat<K5_OR>(pa, pb, n_vec, o, st);
    case K5_XOR: return launch_flat<K5_XOR>(pa, pb, n_vec, o, st);
    default: return launch_flat<K5_ANDNOT>(pa, pb, n_vec, o, st);
  }
}

template <int OP>
static int launch_rows(dim3 grid, cudaStream_t st, const uint4* pool_a,
                       long long stride_a, const int* a_idx, int num_slices,
                       const uint4* pool_b, long long stride_b,
                       const int* b_idx, const uint4* b_blk,
                       unsigned long long* out) {
  if (b_idx != nullptr)
    pair_count_rows_kernel<OP, K5_B_ROW><<<grid, PILOSA_THREADS, 0, st>>>(
        pool_a, stride_a, a_idx, num_slices, pool_b, stride_b, b_idx, b_blk, out);
  else if (b_blk != nullptr)
    pair_count_rows_kernel<OP, K5_B_BLOCK><<<grid, PILOSA_THREADS, 0, st>>>(
        pool_a, stride_a, a_idx, num_slices, pool_b, stride_b, b_idx, b_blk, out);
  else
    pair_count_rows_kernel<OP, K5_B_NONE><<<grid, PILOSA_THREADS, 0, st>>>(
        pool_a, stride_a, a_idx, num_slices, pool_b, stride_b, b_idx, b_blk, out);
  return (int)cudaGetLastError();
}

// pool_a: device (S, cap_a, 2048) words, stride_a = cap_a * 512 uint4;
// a_idx: device int32 (num_rows, S, 16) container index, negative =
// absent. The b operand: b_idx (S, 16) into pool_b (stride_b), or b_blk
// (S, 16, 2048) words, or neither. out: device int64 (num_rows,), zeroed
// by the caller, that the kernel adds to.
extern "C" int pilosa_pair_count_rows(
    const void* pool_a, long long stride_a, const int* a_idx, int num_rows,
    int num_slices, const void* pool_b, long long stride_b, const int* b_idx,
    const void* b_blk, int op, void* out, void* stream) {
  if (num_rows < 1 || num_rows > 65535 || num_slices < 1 ||
      num_slices > 65535 || op < 0 ||
      op > 3 || (b_idx != nullptr && (pool_b == nullptr || b_blk != nullptr)))
    return (int)cudaErrorInvalidValue;
  // Rows of one slice are neighbouring blocks, so a b container read by
  // the first of them is an L2 hit for the rest.
  const dim3 grid(num_rows, num_slices);
  const uint4* pa = (const uint4*)pool_a;
  const uint4* pb = (const uint4*)pool_b;
  const uint4* bb = (const uint4*)b_blk;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case K5_AND:
      return launch_rows<K5_AND>(grid, st, pa, stride_a, a_idx, num_slices, pb,
                                 stride_b, b_idx, bb, o);
    case K5_OR:
      return launch_rows<K5_OR>(grid, st, pa, stride_a, a_idx, num_slices, pb,
                                stride_b, b_idx, bb, o);
    case K5_XOR:
      return launch_rows<K5_XOR>(grid, st, pa, stride_a, a_idx, num_slices, pb,
                                 stride_b, b_idx, bb, o);
    default:
      return launch_rows<K5_ANDNOT>(grid, st, pa, stride_a, a_idx, num_slices,
                                    pb, stride_b, b_idx, bb, o);
  }
}
