// sector_probe: the card's rate for scattered 32-byte read-modify-writes,
// the ceiling of K7 apply_writes. A measurement, not a kernel of any
// serving path: no Pallas call or XLA program stands behind it, as the
// stream ceiling stream_popcount (coarse_count_blocked.cu) stands beside
// K1 and K6.
//
// For each of n word offsets into a pool it reads the word and writes it
// back xor flip, one offset a thread in 256-thread blocks as K7 takes
// one entry a thread, and nothing else: no slot or word bounds, no
// masks, no slice. Given the flat offsets of K7's
// live entries it touches the same sectors in the same order, so K7's
// time over the probe's is the cost of K7's own logic and its 16-byte
// entry reads (the probe reads 8 bytes an offset). Offsets must be
// unique, as K7's targets are.
#include <cuda_runtime.h>

__global__ void sector_probe_kernel(unsigned int* __restrict__ words,
                                    const long long* __restrict__ offsets,
                                    int n, unsigned int flip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned int* p = words + __ldg(offsets + i);
  *p = *p ^ flip;
}

// words: device uint32 words; offsets: device int64 (n,) unique word
// offsets into them.
extern "C" int pilosa_sector_probe(void* words, const void* offsets,
                                   long long n, unsigned int flip,
                                   void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  sector_probe_kernel<<<(unsigned int)((n + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(
      (unsigned int*)words, (const long long*)offsets, (int)n, flip);
  return (int)cudaGetLastError();
}
