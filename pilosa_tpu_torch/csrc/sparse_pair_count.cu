// K4 sparse_pair_count: per-(slice, sub-key) |a ∩ b| of two sorted-array
// containers, read straight from their pools.
//
// Replaces the Pallas kernel pallas_sparse_pair_counts
// (pilosa_tpu/ops/kernels.py:810, call :843) on the ss group of a
// two-leaf sparse count (pilosa_tpu/parallel/mesh.py:618-717). The Pallas
// kernel tests every a-value against every b-value with broadcast
// compares, because the TPU has no per-lane gather.
//
// Bound on an H100 SXM: the bytes, 2 B per real value on each side, read
// once (chip_smoke.py: 0.0283 ms for one pair of 960 x 16 containers of
// 1,024-2,048 values, 3.35 TB/s).
//
// What held v2 back (measured on the card): one 256-thread block per
// pair, 15,360 short blocks; three dependent global reads before the
// first value, then len_a binary searches of ceil(log2 len_b) dependent
// shared loads (more shared lookups than the byte bound has time for).
// It ran at 19% of the bound (0.1522 ms).
//
// v3, O(len_a + len_b) work with the next pair's values in flight:
// - The grid is persistent: as many 128-thread blocks as fit (about 8 an
//   SM), each walking an equal contiguous range of pairs. A block reads
//   the table entries (hit, idx, cards) of 32 pairs at once, one a thread.
// - Values move by TMA bulk copies (cp.async.bulk) into a two-stage ring
//   in shared memory, each stage completing on its own mbarrier: one
//   thread starts the next pair's two copies while the block counts the
//   current pair. A container need not start 16-byte aligned (2*K bytes
//   each): the copy takes the aligned 16-byte chunks that cover it and
//   the count skips the values outside it. A chunk that crosses the edge
//   of the pool tensor is copied value by value.
// - The count is a bitmap intersection: the shorter side sets its
//   values' bits in a 65,536-bit bitmap in shared memory (atomicOr), the
//   longer side tests its values' bits, and the bitmap is cleared. Each
//   value costs one shared access and no step depends on another, where a
//   merge walk chains a dependent load per step; a thread takes one value
//   at a time, which took fewer instructions than unpacking 16-byte
//   chunks and swizzling the bitmap against their bank conflicts.
// Membership comes from the lengths, never from the 0xFFFF pad, so 65535
// is exact, and cards above K are clipped to K. A block sum and one plain
// store write out[s, j]; no atomics on the output, so the result is the
// same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define K4_MAX_VALUES 4096
#define K4_BITMAP_WORDS 2048  // 65,536 bits
#define K4_WARPS 4   // a block: 4 warps on one pair at a time
#define K4_STAGES 2  // the ring: the next pair in flight
#define K4_THREADS (32 * K4_WARPS)
#define K4_GROUP 32  // pairs whose table entries are read at once

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory by the TMA unit, counted on mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The one arrival a phase waits for, after `bytes` more bytes are due.
__device__ __forceinline__ void bar_arrive(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Shared-memory bytes of a region holding k values at any 2-byte offset:
// the 16-byte chunks that cover them.
static inline __host__ __device__ int region_bytes(int k) {
  return 16 * ((2 * k + 14 + 15) / 16);
}

struct Pool {
  const uint16_t* vals;
  const int* cards;
  int cap, k;
  const uint16_t* end;  // one past the pool's last value
};

// A pair: its two containers (pool index s * cap + idx) and lengths.
struct PairRef {
  int ca, cb, la, lb;
};

__device__ __forceinline__ int chunk_head(const uint16_t* p) {
  return (int)(((uintptr_t)p & 15u) >> 1);
}

__device__ __forceinline__ bool inside(const uint16_t* g, const Pool& pool) {
  return g >= pool.vals && g + 8 <= pool.end;
}

// The values of a chunk that crosses the edge of the pool tensor, one
// by one (those outside it are never read).
__device__ __forceinline__ void copy_edge(uint4* dst, const uint16_t* g,
                                          const Pool& pool) {
  uint16_t* d = (uint16_t*)dst;
  for (int e = 0; e < 8; ++e)
    if (g + e >= pool.vals && g + e < pool.end) d[e] = g[e];
}

// Thread 0 copies the chunks covering p[0, len) into region (the values
// land at region's u16 index chunk_head(p) on): the edge chunks of the
// pool tensor by hand, the rest in one bulk copy. Returns the bulk bytes.
__device__ __forceinline__ unsigned load_side(uint4* region,
                                              const uint16_t* p, int len,
                                              const Pool& pool,
                                              uint64_t* bar) {
  const uint16_t* g0 = p - chunk_head(p);
  int c0 = 0, c1 = (2 * (chunk_head(p) + len) + 15) >> 4;
  if (!inside(g0, pool)) copy_edge(region, g0, pool), c0 = 1;
  if (c1 > c0 && !inside(g0 + 8 * (c1 - 1), pool))
    --c1, copy_edge(region + c1, g0 + 8 * c1, pool);
  if (c1 <= c0) return 0u;
  bulk_copy(region + c0, g0 + 8 * c0, 16u * (c1 - c0), bar);
  return 16u * (c1 - c0);
}

// Sets (kSet) or counts the bits of the len values held at region's u16
// index head on, one value a thread at a time: neighbouring threads take
// neighbouring values, so at a few percent fill they touch neighbouring
// words, in different banks. Returns the thread's count.
template <bool kSet>
__device__ __forceinline__ int bitmap_pass(unsigned* bm, const uint4* region,
                                           int head, int len) {
  const uint16_t* vals = (const uint16_t*)region + head;
  int count = 0;
#pragma unroll 4
  for (int j = threadIdx.x; j < len; j += K4_THREADS) {
    const unsigned x = vals[j];
    unsigned* word = bm + (x >> 5);
    if (kSet) atomicOr(word, 1u << (x & 31u));
    else count += (*word >> (x & 31u)) & 1u;
  }
  return count;
}

__global__ void __launch_bounds__(K4_THREADS)
sparse_pair_count_kernel(Pool pa, Pool pb, const int* __restrict__ idx_a,
                         const int* __restrict__ hit_a,
                         const int* __restrict__ idx_b,
                         const int* __restrict__ hit_b, int r,
                         long long num_pairs, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PairRef meta[2][K4_GROUP];  // two groups of pairs
  __shared__ int red[K4_WARPS];
  __shared__ __align__(8) uint64_t bars[K4_STAGES];  // one a stage
  unsigned* bm = (unsigned*)smem;
  uint4* ring = (uint4*)(smem + 4 * K4_BITMAP_WORDS);
  const int a_vec = region_bytes(pa.k) / 16;
  const int stage_vec = a_vec + region_bytes(pb.k) / 16;
  const int tid = threadIdx.x;

  const long long p0 = num_pairs * blockIdx.x / gridDim.x;
  const long long p1 = num_pairs * (blockIdx.x + 1) / gridDim.x;
  if (p0 >= p1) return;
  for (int i = tid; i < K4_BITMAP_WORDS; i += K4_THREADS) bm[i] = 0u;
  if (tid == 0) {
    for (int st = 0; st < K4_STAGES; ++st) bar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Table entries of the pairs, K4_GROUP at a time (one a thread of the
  // first warp), in two slots: the loop reads one pair ahead.
  long long loaded = -1;
  auto ensure = [&](long long i) {  // block-uniform i = q - p0
    const long long g = i / K4_GROUP;
    if (g <= loaded) return;
    loaded = g;
    __syncthreads();  // slot g & 1 held group g - 2: no one reads it now
    const long long q = p0 + g * K4_GROUP + tid;
    if (tid < K4_GROUP) {
      PairRef m{0, 0, 0, 0};
      if (q < p1) {  // the four table reads at once, then the two cards
        const int ha = hit_a[q], hb = hit_b[q], ia = idx_a[q], ib = idx_b[q];
        const long long s = q / r;
        m.ca = (int)(s * pa.cap + ia);
        m.cb = (int)(s * pb.cap + ib);
        if (ha != 0 && hb != 0) {
          m.la = min(pa.cards[m.ca], pa.k);
          m.lb = min(pb.cards[m.cb], pb.k);
        }
      }
      meta[g & 1][tid] = m;
    }
    __syncthreads();
  };
  auto ref = [&](long long i) {
    return meta[(i / K4_GROUP) & 1][i % K4_GROUP];
  };
  // Pair i's values into stage i % K4_STAGES: thread 0 starts the copies
  // and arrives on the stage's barrier.
  auto issue = [&](long long i) {
    if (p0 + i >= p1) return;
    ensure(i);
    if (tid != 0) return;
    const PairRef m = ref(i);
    uint4* ra = ring + (int)(i % K4_STAGES) * stage_vec;
    uint64_t* bar = &bars[i % K4_STAGES];
    unsigned bytes = 0;
    if (m.la > 0 && m.lb > 0) {
      // Orders the block's reads of this stage (the pair two back) before
      // the copies overwrite it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bytes += load_side(ra, pa.vals + (long long)m.ca * pa.k, m.la, pa, bar);
      bytes += load_side(ra + a_vec, pb.vals + (long long)m.cb * pb.k, m.lb,
                         pb, bar);
    }
    bar_arrive(bar, bytes);
  };

  for (int j = 0; j < K4_STAGES - 1; ++j) issue(j);
  for (long long i = 0; p0 + i < p1; ++i) {
    issue(i + K4_STAGES - 1);
    // Pair i has landed: the (i / K4_STAGES)-th phase of its stage.
    bar_wait(&bars[i % K4_STAGES], (unsigned)(i / K4_STAGES) & 1u);
    __syncthreads();  // and the last pair's clear and red reads are done
    const PairRef m = ref(i);
    const bool both = m.la > 0 && m.lb > 0;  // block-uniform
    const uint4* ra = ring + (int)(i % K4_STAGES) * stage_vec;
    const uint4* rb = ra + a_vec;
    const int ha = chunk_head(pa.vals + (long long)m.ca * pa.k);
    const int hb = chunk_head(pb.vals + (long long)m.cb * pb.k);
    // The shorter side sets the bits, the longer one tests them.
    const bool a_sets = m.la <= m.lb;
    const uint4* rs = a_sets ? ra : rb;
    const uint4* rt = a_sets ? rb : ra;
    const int hs = a_sets ? ha : hb, ht = a_sets ? hb : ha;
    const int ls = a_sets ? m.la : m.lb, lt = a_sets ? m.lb : m.la;
    int count = 0;
    if (both) {
      bitmap_pass<true>(bm, rs, hs, ls);
      __syncthreads();
      count = bitmap_pass<false>(bm, rt, ht, lt);
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if ((tid & 31) == 0) red[tid >> 5] = count;
    __syncthreads();  // the counts are in; the bitmap and the stage are read
    // The next pair's barrier after its wait orders this clear before its
    // bits are set and the red reads before its counts are written; no
    // one reads this stage before the next issue refills it.
    if (both) {
      uint4* b4 = (uint4*)bm;
      for (int j = tid; j < K4_BITMAP_WORDS / 4; j += K4_THREADS)
        b4[j] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < K4_WARPS; ++w) total += red[w];
      out[p0 + i] = total;
    }
  }
}

// The blocks of `smem` dynamic shared bytes that fit on the current card
// at once, computed once per (card, smem).
static int resident_blocks(int smem, long long* blocks) {
  static std::mutex mu;
  static int last_dev = -1, last_smem = -1;
  static long long last = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(mu);
  if (dev != last_dev || smem != last_smem) {
    err = cudaFuncSetAttribute(sparse_pair_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sparse_pair_count_kernel, K4_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    last_dev = dev, last_smem = smem;
    last = (long long)sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = last;
  return 0;
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
      b_k < 1 || a_k > K4_MAX_VALUES || b_k > K4_MAX_VALUES ||
      (long long)num_slices * r > 0x7fffffffLL ||
      (long long)num_slices * a_cap > 0x7fffffffLL ||
      (long long)num_slices * b_cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Pool pa{(const uint16_t*)a_vals, (const int*)a_cards, a_cap, a_k,
          (const uint16_t*)a_vals + (long long)num_slices * a_cap * a_k};
  Pool pb{(const uint16_t*)b_vals, (const int*)b_cards, b_cap, b_k,
          (const uint16_t*)b_vals + (long long)num_slices * b_cap * b_k};
  const int smem = 4 * K4_BITMAP_WORDS +
                   K4_STAGES * (region_bytes(a_k) + region_bytes(b_k));
  long long resident = 0;
  const int rc = resident_blocks(smem, &resident);
  if (rc != 0) return rc;
  const long long pairs = (long long)num_slices * r;
  const int grid = (int)(pairs < resident ? pairs : resident);
  sparse_pair_count_kernel<<<grid, K4_THREADS, smem, (cudaStream_t)stream>>>(
      pa, pb, (const int*)idx_a, (const int*)hit_a, (const int*)idx_b,
      (const int*)hit_b, r, pairs, (int*)out);
  return (int)cudaGetLastError();
}
