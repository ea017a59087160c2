// Record word placement: kernel P of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/pack.py::_place_words
// (_make_pack_kernel), reached through place_records and
// compact_bytes6_pack. Dense record r adds its contribution c0[r] into
// stream word wp[r] and c1[r] into word wp[r] + 1 (the rare third word is
// already folded into the next record's c0 by _prep_planes).
//
// The TPU kernel avoids data-dependent addressing: each output tile
// matches word ids against prefetched, anchored windows of records with
// equality compares. On this card a scatter is cheap, so the kernel is one
// thread per record that adds c0 and c1 with 32-bit atomicAdd into the
// zeroed output (the wrapper's torch.zeros, so bytes past the stream are 0,
// not stale). Every output byte has exactly one owning record, so the adds
// are carry-free: the sum is exact, and its order does not matter, which
// keeps the result deterministic although the atomics run in any order.
// Zero contributions are skipped (about half the c1 of a 4K frame), and
// words at or past w_cap are dropped. The gather alternative (one thread
// per output word, binary search over the nondecreasing wp) avoids atomics
// but reads ~log2(N) records per word; the scatter reads each record once.
//
// Bound on the H100: memory traffic. At 4K, N + 1 = 2^23 + 1 records of
// (wp, c0, c1) int32 are read once (~101 MB) and 6N/4 output words written
// (~50 MB, plus the zero fill): ~151 MB, ~0.045 ms at 3.35 TB/s.
// Neighbouring records mostly hit the same or the next word, so a warp's
// atomics fall on a few cache lines of L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void place_words_kernel(const int32_t* __restrict__ wp,
                                   const uint32_t* __restrict__ c0,
                                   const uint32_t* __restrict__ c1,
                                   uint32_t* __restrict__ out, long long r,
                                   long long w_cap) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < r; i += stride) {
    long long w = wp[i];
    uint32_t a = c0[i];
    uint32_t b = c1[i];
    if (a && w >= 0 && w < w_cap) atomicAdd(&out[w], a);
    if (b && w + 1 >= 0 && w + 1 < w_cap) atomicAdd(&out[w + 1], b);
  }
}

}  // namespace

extern "C" int qoi_place_words(const void* wp, const void* c0, const void* c1,
                               void* out, long long r, long long w_cap,
                               void* stream) {
  if (r <= 0 || w_cap <= 0) return 0;
  const int threads = 256;
  long long blocks = (r + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  place_words_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)wp, (const uint32_t*)c0, (const uint32_t*)c1,
      (uint32_t*)out, r, w_cap);
  return (int)cudaGetLastError();
}
