// Decode pass 3 as a numeric re-scan: kernel I of the PyTorch/CUDA port.
//
// Replaces the lax.scan of qoi_tpu/models/decode_v3.py::_numeric_scan, the
// pass 3 of _resolve_p(apply="scan"): the differential anchor of the
// vectorized apply (_apply_symbolic). Inputs are position-major (b, nb)
// planes, meta = cls | w << 3 | r6 << 9, d32 and lit32 (u32 bit patterns),
// and the (65, nb) numeric entry state of every block lane from pass 2
// (row 0 the px, row 1+s slot s). Each lane walks its b positions in order
// from its entry state: a live step (cls != 0) computes the new px by the
// selects of decode_v3._step_common (ADD: bytewise add of d32, RGB: the
// literal's rgb under the running alpha, RGBA: the literal, INDEX: slot
// w), sets px and writes slot w; every step stores px at [i, lane]. After
// its last position, the last lane writes the exit state (px, slots).
//
// Bound on the H100: bytes. 12 B read and 4 B written a position, plus the
// entry states (65 x nb x 4 B): 235 MB at 4K mixed (b = 8192, nb = 1792),
// 0.070 ms at 3.35 TB/s. The kernel is not near it: a lane is one chain
// of b dependent steps, and there are only nb lanes.
//
// Design, simple on purpose (segmenting the lanes is what _apply_symbolic
// already is):
// - one thread a lane, carrying px in a register; the 64 slots live in
//   shared memory laid out [slot][thread], so a warp's accesses to any
//   slot row hit 32 distinct banks (the choice of csrc/block_maps.cu);
// - one warp a block (8 KB of slots), so that the nb / 32 warps spread
//   over as many SMs, each with its own load units and L1;
// - the loads do not depend on the state: they run kAhead positions ahead
//   into a register ring, so the chain runs through shared memory alone;
//   a step is branch-free selects, so a warp does not diverge on the op
//   class; a warp's loads and stores are whole 128 B row pieces.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;    // lanes of a block
constexpr int kSlots = 64;
constexpr int kAhead = 16;      // positions loaded ahead

// op classes (decode_v3 cls field)
constexpr int kClsAdd = 1, kClsRgb = 2, kClsRgba = 3, kClsIndex = 4;

__device__ __forceinline__ uint32_t swar_add(uint32_t a, uint32_t b) {
  uint32_t lo = ((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu;
  uint32_t hi = ((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u;
  return lo | hi;
}

__global__ void __launch_bounds__(kThreads)
numeric_scan_kernel(const int32_t* __restrict__ meta,
                    const uint32_t* __restrict__ d32,
                    const uint32_t* __restrict__ lit32,
                    const uint32_t* __restrict__ entry,
                    uint32_t* __restrict__ px_out,
                    uint32_t* __restrict__ exit65, int b, int nb) {
  __shared__ uint32_t tval[kSlots * kThreads];   // [slot][thread]
  const int t = threadIdx.x;
  const int n = blockIdx.x * kThreads + t;
  if (n >= nb) return;  // no barrier in this kernel

  uint32_t pv = entry[n];
  for (int s = 0; s < kSlots; ++s) {
    tval[s * kThreads + t] = entry[(size_t)(1 + s) * nb + n];
  }
  int32_t mc[kAhead], mn[kAhead];
  uint32_t dc[kAhead], dn[kAhead], lc[kAhead], ln[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const size_t at = (size_t)k * nb + n;
    mc[k] = k < b ? meta[at] : 0;
    dc[k] = k < b ? d32[at] : 0u;
    lc[k] = k < b ? lit32[at] : 0u;
  }
  for (int base = 0; base < b; base += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {  // the next chunk, in flight
      const int i = base + kAhead + k;
      const size_t at = (size_t)i * nb + n;
      mn[k] = i < b ? meta[at] : 0;
      dn[k] = i < b ? d32[at] : 0u;
      ln[k] = i < b ? lit32[at] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = base + k;
      if (i < b) {
        const int cls = mc[k] & 7;
        const int slot = ((mc[k] >> 3) & 63) * kThreads + t;
        uint32_t nv = pv;
        nv = cls == kClsAdd ? swar_add(pv, dc[k]) : nv;
        nv = cls == kClsRgb ? (lc[k] & 0x00FFFFFFu) | (pv & 0xFF000000u)
                            : nv;
        nv = cls == kClsRgba ? lc[k] : nv;
        nv = cls == kClsIndex ? tval[slot] : nv;
        if (cls != 0) {
          pv = nv;
          tval[slot] = pv;
        }
        px_out[(size_t)i * nb + n] = pv;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      mc[k] = mn[k];
      dc[k] = dn[k];
      lc[k] = ln[k];
    }
  }
  if (n == nb - 1) {
    exit65[0] = pv;
    for (int s = 0; s < kSlots; ++s) exit65[1 + s] = tval[s * kThreads + t];
  }
}

}  // namespace

extern "C" int qoi_numeric_scan(const void* meta, const void* d32,
                                const void* lit32, const void* entry,
                                void* px_out, void* exit65, int b, int nb,
                                void* stream) {
  if (nb <= 0) return 0;
  numeric_scan_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const uint32_t*)d32, (const uint32_t*)lit32,
      (const uint32_t*)entry, (uint32_t*)px_out, (uint32_t*)exit65, b, nb);
  return (int)cudaGetLastError();
}
