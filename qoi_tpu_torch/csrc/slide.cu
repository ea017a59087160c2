// Event slides: kernel A (one value plane) and kernel D (two planes) of the
// PyTorch/CUDA port.
//
// qoi_slide_val replaces the Pallas kernel qoi_tpu/kernels/slide.py::
// slide_val (_slide_kernel), which slides every alive event of a segment row
// left by its distance in log2(sw) in-VMEM shift passes. qoi_slide_val2
// replaces slide_val2 (_slide_kernel2), the same slide carrying two value
// planes (pix_off, px32) through the same moves, for the decoder's chunk
// compaction (models/decode_v3._compact_chunks).
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
//
// Kernel D is the same placement for two planes. In _compact_chunks an
// alive slot is a chunk start and its distance is (index in row) - (chunk
// rank in row), so destinations are again unique and increasing. Bound on
// the H100: memory traffic, 3 planes read and 2 written, 20 B per slot
// (about 294 MB for a 4K mixed stream of ~14.7 M bytes).
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

__global__ void slide_val2_kernel(const int32_t* __restrict__ val,
                                  const int32_t* __restrict__ val2,
                                  const int32_t* __restrict__ aux,
                                  int32_t* __restrict__ out,
                                  int32_t* __restrict__ out2,
                                  long long total, int sw) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int32_t a = aux[i];
    if (a & 1) {
      int32_t dist = a >> 1;
      if (dist <= (int32_t)(i % sw)) {
        out[i - dist] = val[i];
        out2[i - dist] = val2[i];
      }
    }
  }
}

long long grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return blocks > 65535LL * 16 ? 65535LL * 16 : blocks;  // grid-stride beyond
}

}  // namespace

extern "C" int qoi_slide_val(const void* val, const void* aux, void* out,
                             long long total, int sw, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  slide_val_kernel<<<(unsigned)grid_for(total, threads), threads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)val, (const int32_t*)aux, (int32_t*)out, total, sw);
  return (int)cudaGetLastError();
}

extern "C" int qoi_slide_val2(const void* val, const void* val2,
                              const void* aux, void* out, void* out2,
                              long long total, int sw, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  slide_val2_kernel<<<(unsigned)grid_for(total, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)val, (const int32_t*)val2, (const int32_t*)aux,
      (int32_t*)out, (int32_t*)out2, total, sw);
  return (int)cudaGetLastError();
}
