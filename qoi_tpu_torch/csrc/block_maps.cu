// Decode pass 1, per-block symbolic maps: kernel C of the PyTorch/CUDA port.
//
// Replaces the lax.scan of qoi_tpu/models/decode_v3.py::_block_maps
// (emit_px=True). That one is not a Pallas kernel but an XLA scan of up to
// 8192 sequential steps; as a loop of torch ops it would cost ~10^5
// launches per fixpoint round. Each block lane n walks its b positions in
// order, carrying the decoder's 65-entry state symbolically: per channel a
// (root, val) byte pair, root 0 = the block's entry px, 1+s = entry table
// slot s, 65 = absolute (val alone). At every position it emits the px
// entry's (root, val); at the end, the whole 65-entry map.
//
// Design: one thread per block lane. The px entry lives in registers; the
// 64 table slots live in shared memory laid out [slot][thread], so a warp's
// accesses to any slot row hit 32 distinct banks. Inputs are position-major
// (b, nb), so at each step neighbouring threads read neighbouring words.
//
// Bound on the H100: the sequential chain of b dependent steps per lane,
// not bandwidth. At 4K, nb is only about 1800 lanes (~29 blocks of 64
// threads): a fraction of the 132 SMs, and each step waits on its loads.
// Splitting lanes further (smaller b) or running several streams at once
// is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kSlots = 64;

// op classes (decode_v3 cls field)
constexpr int kClsAdd = 1, kClsRgb = 2, kClsRgba = 3, kClsIndex = 4;

__device__ __forceinline__ uint32_t swar_add(uint32_t a, uint32_t b) {
  uint32_t lo = ((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu;
  uint32_t hi = ((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u;
  return lo | hi;
}

__global__ void __launch_bounds__(kThreads)
block_maps_kernel(const int32_t* __restrict__ meta,
                  const uint32_t* __restrict__ d32,
                  const uint32_t* __restrict__ lit32,
                  uint32_t* __restrict__ proot, uint32_t* __restrict__ pval,
                  uint32_t* __restrict__ root, uint32_t* __restrict__ val,
                  int b, int nb) {
  __shared__ uint32_t troot[kSlots][kThreads];
  __shared__ uint32_t tval[kSlots][kThreads];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kThreads + t;
  if (n >= nb) return;  // no block-wide barrier below: early exit is safe
  for (int s = 0; s < kSlots; ++s) {
    troot[s][t] = (uint32_t)(1 + s) * 0x01010101u;
    tval[s][t] = 0u;
  }
  uint32_t pr = 0u, pv = 0u;  // root 0 everywhere: the entry px
  for (int i = 0; i < b; ++i) {
    const size_t at = (size_t)i * nb + n;
    const int32_t mt = meta[at];
    const int cls = mt & 7;
    if (cls != 0) {
      const int w = (mt >> 3) & 63;
      switch (cls) {
        case kClsAdd:
          pv = swar_add(pv, d32[at]);
          break;
        case kClsRgb:
          pv = (lit32[at] & 0x00FFFFFFu) | (pv & 0xFF000000u);
          pr = (pr & 0xFF000000u) | 0x00414141u;  // rgb absolute, a flows
          break;
        case kClsRgba:
          pv = lit32[at];
          pr = 0x41414141u;
          break;
        case kClsIndex:  // an INDEX writes the slot it reads (w == r6)
          pv = tval[w][t];
          pr = troot[w][t];
          break;
        default:
          break;
      }
      troot[w][t] = pr;
      tval[w][t] = pv;
    }
    proot[at] = pr;
    pval[at] = pv;
  }
  root[n] = pr;
  val[n] = pv;
  for (int s = 0; s < kSlots; ++s) {
    root[(size_t)(1 + s) * nb + n] = troot[s][t];
    val[(size_t)(1 + s) * nb + n] = tval[s][t];
  }
}

}  // namespace

extern "C" int qoi_block_maps(const void* meta, const void* d32,
                              const void* lit32, void* proot, void* pval,
                              void* root, void* val, int b, int nb,
                              void* stream) {
  if (nb <= 0) return 0;
  const int blocks = (nb + kThreads - 1) / kThreads;
  block_maps_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const uint32_t*)d32, (const uint32_t*)lit32,
      (uint32_t*)proot, (uint32_t*)pval, (uint32_t*)root, (uint32_t*)val, b,
      nb);
  return (int)cudaGetLastError();
}
