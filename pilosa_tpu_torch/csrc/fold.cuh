// Shared pieces of the count kernels: the fold program, the per-leaf
// pool table, popcount and the block reduction.
//
// A query's bitmap-op tree reaches a kernel as a program in accumulator
// form (ops/kernels.py tree_program). Each op is 16 bits, the opcode in
// the high byte and a leaf index in the low one:
//   0x00ll LOAD l     acc = leaf l
//   0x01ll AND l      acc &= leaf l
//   0x02ll OR l       acc |= leaf l
//   0x03ll ANDNOT l   acc &= ~leaf l
//   0x0400 PUSH       save acc (a nested right operand follows)
//   0x0500/0x0600/0x0700  acc = saved and/or/andnot acc
// A flat n-ary tree is LOAD plus one op per further leaf: the value stays
// in registers and the save stack is never touched. The planner puts the
// deepest operand of and/or first (parallel/plan.py canonical_tree), so
// the BSI comparison ladders run as such chains too. Every thread runs
// the same program over its own 16 bytes of the leaves' words, so the
// tree shape is data, not code, and one build serves every query.
#pragma once

#include <cuda_runtime.h>

// K1/K3 leaves: 2 + 62 rows of the deepest integer field and a 16-leaf
// filter. K2 streams at most 16 unique runs through shared memory.
#define PILOSA_MAX_LEAVES 80
#define PILOSA_SHARED_LEAVES 16
#define PILOSA_MAX_BATCH 16
#define PILOSA_MAX_PROG 768
#define PILOSA_MAX_DEPTH 8
#define PILOSA_THREADS 256
// uint4 vectors in one 2048-word container and in one 16-container run.
#define PILOSA_CONTAINER_VEC 512
#define PILOSA_RUN_VEC (16 * PILOSA_CONTAINER_VEC)

struct Prog {
  int n;
  unsigned short op[PILOSA_MAX_PROG];
};

// One pool per leaf position (leaves may share a pool). slice_stride is
// the pool's slice pitch in uint4 vectors: cap * 2048 / 4.
struct Pools {
  const uint4* base[PILOSA_MAX_LEAVES];
  long long slice_stride[PILOSA_MAX_LEAVES];
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// kind 1 = and, 2 = or, 3 = andnot.
__device__ __forceinline__ uint4 combine(int kind, uint4 a, uint4 b) {
  if (kind == 1) return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  if (kind == 2) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// Runs the program; leaf(l) yields leaf l's uint4 at this position.
template <class Leaf>
__device__ __forceinline__ uint4 fold(const Prog& p, Leaf leaf) {
  uint4 acc = zero4();
  uint4 saved[PILOSA_MAX_DEPTH];
  int sp = 0;
  for (int k = 0; k < p.n; ++k) {
    const int op = p.op[k];
    const int kind = op >> 8;
    if (kind == 0) {
      acc = leaf(op & 255);
    } else if (kind < 4) {
      acc = combine(kind, acc, leaf(op & 255));
    } else if (kind == 4) {
      saved[sp++] = acc;
    } else {
      acc = combine(kind - 4, saved[--sp], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Block-wide sum of one int per thread; the total lands in thread 0.
// smem holds one slot per warp. Every thread of the block must call it.
__device__ __forceinline__ int block_sum(int v, int* smem) {
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
  __syncthreads();  // smem may be reused by the next call
  return v;
}

// Host-side packing of the by-value kernel arguments. Returns 0 or a
// cudaError_t for arguments the kernels do not take.
static inline int pilosa_pack(const void* const* bases,
                              const long long* strides, int n,
                              const unsigned short* ops, int prog_len,
                              Pools* pools, Prog* prog) {
  if (n < 1 || n > PILOSA_MAX_LEAVES || prog_len < 1 ||
      prog_len > PILOSA_MAX_PROG)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < PILOSA_MAX_LEAVES; ++i) {
    pools->base[i] = i < n ? (const uint4*)bases[i] : nullptr;
    pools->slice_stride[i] = i < n ? strides[i] : 0;
  }
  prog->n = prog_len;
  for (int i = 0; i < PILOSA_MAX_PROG; ++i)
    prog->op[i] = i < prog_len ? ops[i] : 0;
  return 0;
}
