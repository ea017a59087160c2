// Run expansion, direct fill: kernel B of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/expand.py::expand_px in its
// production form (_expand_px_wide with _make_wide_kernel, accum "xw").
// out[p] = px32[I(p)], I(p) the last byte with pix_off[i] <= p, or the
// seed where no byte qualifies. The TPU kernel gets this as a telescoping
// sum of px deltas (cumsum of the deltas landed at pix_off, plus the
// seed), because scatters serialise there. This card has no such limit,
// so the kernel writes the answer directly, in one launch, with no zero
// fill, no atomics and no cumsum.
//
// With pix_off nondecreasing and >= 0 (the wrapper's precondition), byte
// i owns the pixels [pix_off[i], pix_off[i+1]) (the last byte up to
// n_px_cap), both ends clamped to [0, n_px_cap]; pixels before pix_off[0]
// take the seed. These ranges tile [0, n_px_cap) exactly, so every output
// word is written once: the result is deterministic and an uninitialised
// output is safe. Bytes that share an offset own empty ranges except the
// last of them; offsets >= n_px_cap (the _INF tail of the dense records,
// a truncated stream) own nothing, as mode="drop" drops them in
// expand_px_xla.
//
// Only the seed prefix and the last byte's range can be long (the
// bucket's padding past the last pixel, ~94k pixels at 4K, or millions
// for a truncated stream); every other range is at most one QOI run (62
// pixels). So the two long ranges are written grid-stride by all threads,
// and each other byte's range by its own thread.
//
// Bound on the H100: bytes. 8 B read per byte (pix_off, px32) and 4 B
// written per pixel: 151 MB at 4K, 0.045 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long clamp_px(int32_t p, long long cap) {
  return p < 0 ? 0 : (p > cap ? cap : (long long)p);
}

__global__ void expand_fill_kernel(const int32_t* __restrict__ pix_off,
                                   const uint32_t* __restrict__ px32,
                                   uint32_t* __restrict__ out, long long m,
                                   long long n_px_cap, uint32_t seed) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long head = m ? clamp_px(pix_off[0], n_px_cap) : n_px_cap;
  for (long long p = tid; p < head; p += stride) out[p] = seed;
  if (m == 0) return;
  const uint32_t last = px32[m - 1];
  for (long long p = clamp_px(pix_off[m - 1], n_px_cap) + tid; p < n_px_cap;
       p += stride)
    out[p] = last;
  for (long long i = tid; i < m - 1; i += stride) {
    const long long lo = clamp_px(pix_off[i], n_px_cap);
    const long long hi = clamp_px(pix_off[i + 1], n_px_cap);
    if (lo < hi) {
      const uint32_t v = px32[i];
      for (long long p = lo; p < hi; ++p) out[p] = v;
    }
  }
}

}  // namespace

extern "C" int qoi_expand_px(const void* pix_off, const void* px32,
                             void* out, long long m, long long n_px_cap,
                             unsigned int seed, void* stream) {
  if (n_px_cap <= 0) return 0;
  const int threads = 256;
  const long long work = m > n_px_cap ? m : n_px_cap;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  expand_fill_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pix_off, (const uint32_t*)px32, (uint32_t*)out, m,
      n_px_cap, seed);
  return (int)cudaGetLastError();
}
