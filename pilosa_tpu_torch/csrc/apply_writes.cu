// K7 apply_writes: fold a batch of written bits into a staged pool, in
// place. Each (slice, entry) of an (S, B) batch updates one uint32 word:
//   w[s][slot][word] = (w & ~clear_mask) | set_mask
// An entry whose slot lies outside [0, cap) (the padding rides
// slot = cap) or whose word lies outside [0, 2048) is dropped.
//
// Replaces no Pallas call: it is the counterpart of the JAX package's
// XLA program compile_serve_apply_writes (pilosa_tpu/parallel/mesh.py:
// 1997-2027, a vmap of ops/pool.scatter_words), which gathers the
// targets, masks them and scatters them back into a new pool. Here one
// launch updates the pool in place: a copy of a 1 GB pool would cost as
// much as restaging it. The launch is ordered after every count kernel
// already queued on the stream, so those read the words as they were.
//
// The planner (ops/pool.plan_slice_mutations) makes the targets unique
// per slice, so no two threads touch one word and no atomics are
// needed. Bound: bytes. Each live entry reads and writes one word,
// which the card moves as a 32-byte sector each way, and every entry's
// 16 bytes (slot, word, two masks) are read once; consecutive entries
// on consecutive threads, so the entry reads coalesce. The targets are
// scattered sectors (a slice's entries sorted by slot and word).
//
// What caps it (measured on an H100 80GB HBM3 at 700 W by chip_smoke.py;
// PERF.md §6): the card's rate for scattered read-modify-writes.
// sector_probe.cu, the same sectors with no entry logic, runs within a
// few percent of this kernel: the memory, not the kernel, sets the pace,
// at about a quarter of the bytes bound. Of the levers tried, four
// entries a thread with every load issued before the first store ran
// slower (more scattered requests in flight), a block per slice ran
// slower at the write rounds' (960, 8) batches (960 small blocks), and
// 16-byte entry records ran slower than the four arrays. So v2 keeps one
// entry a thread in 256-thread blocks on a flat grid, and its index
// arithmetic is 32-bit (the batch holds fewer than 2^31 entries): no
// 64-bit division is left.
#include <cuda_runtime.h>

static constexpr int kWords = 2048;

// Thread i takes entry i of the (S, b) batch, slice i / b.
__global__ void apply_writes_kernel(unsigned int* __restrict__ words,
                                    int cap, int b, int n,
                                    const int* __restrict__ slot,
                                    const int* __restrict__ word,
                                    const unsigned int* __restrict__ set_mask,
                                    const unsigned int* __restrict__ clear_mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int sl = __ldg(slot + i);
  const int wd = __ldg(word + i);
  if (sl < 0 || sl >= cap || wd < 0 || wd >= kWords) return;
  unsigned int* p = words + ((long long)(i / b) * cap + sl) * kWords + wd;
  *p = (*p & ~__ldg(clear_mask + i)) | __ldg(set_mask + i);
}

// words: device (S, cap, 2048) uint32 pool; slot, word, set_mask,
// clear_mask: device (S, b) int32 / uint32 batches, row-major.
extern "C" int pilosa_apply_writes(void* words, int s, int cap, void* slot,
                                   void* word, void* set_mask,
                                   void* clear_mask, int b, void* stream) {
  const long long n = (long long)s * b;
  if (s < 1 || cap < 0 || b < 1 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  apply_writes_kernel<<<(unsigned int)((n + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(
      (unsigned int*)words, cap, b, (int)n, (const int*)slot,
      (const int*)word, (const unsigned int*)set_mask,
      (const unsigned int*)clear_mask);
  return (int)cudaGetLastError();
}
