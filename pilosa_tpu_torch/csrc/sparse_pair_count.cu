// K4 sparse_pair_count: per-(slice, sub-key) |a ∩ b| of two sorted-array
// containers, read straight from their pools.
//
// Replaces the Pallas kernel pallas_sparse_pair_counts
// (pilosa_tpu/ops/kernels.py:810, call :843) on the ss group of a
// two-leaf sparse count (pilosa_tpu/parallel/mesh.py:618-717).
//
// The Pallas kernel tests every a-value against every b-value with
// broadcast compares, because the TPU has no per-lane gather. Here b's
// values sit in shared memory and each a-value binary-searches them.
//
// Bound on an H100 SXM: the bytes, 2 B per real value on each side (a
// merge needs only ~len_a + len_b steps). The binary searches here cost
// len_a * ceil(log2 len_b) shared-memory lookups per pair, one 4-byte
// bank access per lane per clock, which for containers of a few percent
// fill takes a little longer than the bytes; chip_smoke.py reports both.
//
// Design: one block per (slice s, sub-key j). The block reads hit/idx of
// both sides; if either side is absent or empty the count is 0.
// Otherwise it loads b's len_b values (at most 4096 x 2 B = 8 KB) into
// shared memory with 16-byte loads where the container is 16-byte
// aligned, and each thread binary-searches a strided share of a's len_a
// values (branch-free lower bound; the first levels are broadcasts).
// Membership comes from the lengths, never from the 0xFFFF pad, so 65535
// is exact. A warp and then a block reduction writes out[s, j]; no
// atomics, so the result is the same from run to run. Nothing is
// gathered into device memory first.
#include <stdint.h>

#include "fold.cuh"

#define PILOSA_MAX_VALUES 4096

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

__global__ void __launch_bounds__(PILOSA_THREADS)
sparse_pair_count_kernel(const uint16_t* __restrict__ a_vals,
                         const int* __restrict__ a_cards, int a_cap, int a_k,
                         const uint16_t* __restrict__ b_vals,
                         const int* __restrict__ b_cards, int b_cap, int b_k,
                         const int* __restrict__ idx_a,
                         const int* __restrict__ hit_a,
                         const int* __restrict__ idx_b,
                         const int* __restrict__ hit_b, int r,
                         int* __restrict__ out) {
  __shared__ __align__(16) uint16_t bs[PILOSA_MAX_VALUES];
  __shared__ int red[32];
  const long long sr = blockIdx.x;  // s * r + j
  const long long s = sr / r;
  int la = 0, lb = 0;
  const uint16_t* ap = nullptr;
  const uint16_t* bp = nullptr;
  if (hit_a[sr] != 0 && hit_b[sr] != 0) {
    const long long ca = s * a_cap + idx_a[sr];
    const long long cb = s * b_cap + idx_b[sr];
    la = min(a_cards[ca], a_k);
    lb = min(b_cards[cb], b_k);
    ap = a_vals + ca * a_k;
    bp = b_vals + cb * b_k;
  }
  if (la <= 0 || lb <= 0) {  // block-uniform: no thread reaches a barrier
    if (threadIdx.x == 0) out[sr] = 0;
    return;
  }
  int head = 0;
  if (aligned16(bp)) {
    head = lb & ~7;
    const uint4* src = (const uint4*)bp;
    uint4* dst = (uint4*)bs;
    for (int i = threadIdx.x; i < head / 8; i += blockDim.x)
      dst[i] = __ldg(src + i);
  }
  for (int i = head + threadIdx.x; i < lb; i += blockDim.x) bs[i] = bp[i];
  __syncthreads();

  int count = 0;
  for (int i = threadIdx.x; i < la; i += blockDim.x) {
    const uint16_t x = __ldg(ap + i);
    // Lower bound of x in bs[0, lb).
    int base = 0;
    int n = lb;
    while (n > 1) {
      const int half = n >> 1;
      base = bs[base + half] < x ? base + half : base;
      n -= half;
    }
    const int pos = base + (bs[base] < x);
    count += (pos < lb && bs[pos] == x);
  }
  count = block_sum(count, red);
  if (threadIdx.x == 0) out[sr] = count;
}

// a_vals/b_vals: device uint16 (S, cap, k) pools; a_cards/b_cards: device
// int32 (S, cap); idx_*/hit_*: device int32 (S, r) within-slice container
// index and presence flag; out: device int32 (S, r).
extern "C" int pilosa_sparse_pair_count(
    const void* a_vals, const void* a_cards, int a_cap, int a_k,
    const void* b_vals, const void* b_cards, int b_cap, int b_k,
    const void* idx_a, const void* hit_a, const void* idx_b,
    const void* hit_b, int num_slices, int r, void* out, void* stream) {
  if (num_slices < 1 || r < 1 || a_cap < 1 || b_cap < 1 || a_k < 1 ||
      b_k < 1 || b_k > PILOSA_MAX_VALUES ||
      (long long)num_slices * r > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  sparse_pair_count_kernel<<<num_slices * r, PILOSA_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint16_t*)a_vals, (const int*)a_cards, a_cap, a_k,
      (const uint16_t*)b_vals, (const int*)b_cards, b_cap, b_k,
      (const int*)idx_a, (const int*)hit_a, (const int*)idx_b,
      (const int*)hit_b, r, (int*)out);
  return (int)cudaGetLastError();
}
