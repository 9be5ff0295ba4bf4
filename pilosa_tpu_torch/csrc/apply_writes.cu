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
// 16 bytes (slot, word, two masks) are read once; one thread an entry,
// 256 threads a block, consecutive entries on consecutive threads, so
// the entry reads coalesce.
#include <cuda_runtime.h>

static constexpr int kWords = 2048;

__global__ void apply_writes_kernel(unsigned int* __restrict__ words,
                                    int cap, int b, long long n,
                                    const int* __restrict__ slot,
                                    const int* __restrict__ word,
                                    const unsigned int* __restrict__ set_mask,
                                    const unsigned int* __restrict__ clear_mask) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int sl = slot[i];
  const int wd = word[i];
  if (sl < 0 || sl >= cap || wd < 0 || wd >= kWords) return;
  const long long s = i / b;
  unsigned int* p = words + (s * cap + sl) * (long long)kWords + wd;
  *p = (*p & ~clear_mask[i]) | set_mask[i];
}

// words: device (S, cap, 2048) uint32 pool; slot, word, set_mask,
// clear_mask: device (S, b) int32 / uint32 batches, row-major.
extern "C" int pilosa_apply_writes(void* words, int s, int cap, void* slot,
                                   void* word, void* set_mask,
                                   void* clear_mask, int b, void* stream) {
  if (s < 1 || cap < 0 || b < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)s * b;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  apply_writes_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (unsigned int*)words, cap, b, n, (const int*)slot, (const int*)word,
      (const unsigned int*)set_mask, (const unsigned int*)clear_mask);
  return (int)cudaGetLastError();
}
