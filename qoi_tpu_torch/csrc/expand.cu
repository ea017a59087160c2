// Run expansion, delta placement: kernel B of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/expand.py::expand_px in its
// production form (_expand_px_wide with _make_wide_kernel, accum "xw").
// With d[i] = px32[i] - px32[i-1] (the seed before byte 0) and
// landed[p] = sum of d[i] over bytes with pix_off[i] == p, the decoded
// pixel plane is cumsum(landed) + seed mod 2^32 (the telescoping identity
// in the JAX module's docstring). This kernel computes `landed`; the
// wrapper leaves the cumsum to torch, as the JAX package leaves it to XLA.
//
// The TPU kernel avoids data-dependent memory access (scatters serialize
// there) with anchored windows and masked sums. On this card a scatter is
// cheap: one thread per byte adds its delta into landed[pix_off[i]] with
// an unsigned atomicAdd, exact mod 2^32. At most one byte per pixel
// carries a nonzero delta (only chunk starts change px, and every chunk
// start has its own pixel offset), and zero deltas are skipped, so the
// atomics never contend. Bytes whose offset falls outside [0, n_px_cap)
// are dropped, as mode="drop" drops them in expand_px_xla.
//
// Bound on the H100: memory traffic. At 4K the input is about 15 M bytes
// x 8 B of (pix_off, px32) reads, coalesced, plus ~8 M scattered 4 B
// atomics into a 33 MB plane that fits the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_landed_kernel(const int32_t* __restrict__ pix_off,
                                     const uint32_t* __restrict__ px32,
                                     uint32_t* __restrict__ landed,
                                     long long m, long long n_px_cap,
                                     uint32_t seed) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    int32_t p = pix_off[i];
    if (p < 0 || p >= n_px_cap) continue;
    uint32_t d = px32[i] - (i ? px32[i - 1] : seed);
    if (d) atomicAdd(&landed[p], d);
  }
}

}  // namespace

extern "C" int qoi_expand_px(const void* pix_off, const void* px32,
                             void* landed, long long m, long long n_px_cap,
                             unsigned int seed, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  expand_landed_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)pix_off, (const uint32_t*)px32, (uint32_t*)landed, m,
      n_px_cap, seed);
  return (int)cudaGetLastError();
}
