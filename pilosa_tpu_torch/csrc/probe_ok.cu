// K0 probe_ok: the canary launch. Adds 1 to every element of an int32
// tensor; the wrapper checks that each reads 1 afterwards.
//
// Replaces the Pallas kernel pallas_probe_ok (pilosa_tpu/ops/kernels.py),
// the JAX server's boot-time check that kernels compile and run on its
// device at all. The port's server runs it once before it binds, on an
// (8, 128) tensor, and refuses to start if it fails.
//
// Bound: launch latency; 4 KB in and out is nothing to the card.
#include <cuda_runtime.h>

__global__ void probe_ok_kernel(int* __restrict__ x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1;
}

// x: device int32, n elements, updated in place.
extern "C" int pilosa_probe_ok(void* x, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  probe_ok_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>((int*)x, n);
  return (int)cudaGetLastError();
}
