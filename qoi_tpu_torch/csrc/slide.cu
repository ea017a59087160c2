// Word-sum event slide: kernel A of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/slide.py::slide_val
// (_slide_kernel), which slides every alive event of a segment row left by
// its distance in log2(sw) in-VMEM shift passes.
//
// Every event that ops/compact._wordsum_events_words builds has a UNIQUE
// destination i - dist inside its own row (destinations are strictly
// increasing in slot order), so no pass structure is needed on this card:
// each thread takes one slot and, if the event there is alive (aux bit 0),
// stores its value straight at i - dist of the zeroed output. Dead slots
// stay 0, as the Pallas kernel's alive mask leaves them.
//
// Bound on the H100: memory traffic only (read val and aux, write out:
// about 3 x 66 MB at a 4K frame), no arithmetic to speak of. The simple
// design reads both planes once, coalesced, and writes each landed event
// once; the zero fill is the wrapper's torch.zeros. An event whose distance
// would leave its row is dropped, as the shift passes drop it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void slide_val_kernel(const int32_t* __restrict__ val,
                                 const int32_t* __restrict__ aux,
                                 int32_t* __restrict__ out,
                                 long long total, int sw) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int32_t a = aux[i];
    if (a & 1) {
      int32_t dist = a >> 1;
      if (dist <= (int32_t)(i % sw)) out[i - dist] = val[i];
    }
  }
}

}  // namespace

extern "C" int qoi_slide_val(const void* val, const void* aux, void* out,
                             long long total, int sw, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond
  slide_val_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)val, (const int32_t*)aux, (int32_t*)out, total, sw);
  return (int)cudaGetLastError();
}
