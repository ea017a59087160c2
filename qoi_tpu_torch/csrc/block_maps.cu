// Decode pass 1, per-block symbolic maps: kernel C of the PyTorch/CUDA port.
//
// Replaces the lax.scan of qoi_tpu/models/decode_v3.py::_block_maps
// (emit_px=True). That one is not a Pallas kernel but an XLA scan of up to
// 8192 sequential steps. Each block lane n walks its b positions in order,
// carrying the decoder's 65-entry state symbolically: per channel a
// (root, val) byte pair, root 0 = the lane's entry px, 1+s = entry table
// slot s, 0x41 = absolute (val alone). At every position it emits the px
// entry's (root, val); at the end, the whole 65-entry map.
//
// Bound on the H100: bytes. 12 B read (meta, d32, lit32) and 8 B written
// (proot, pval) per position plus the 65-entry maps: 0.088 ms at 4K mixed
// (b = 8192, nb = 1792) at 3.35 TB/s. One thread per lane, walking all b
// positions, leaves the card nearly idle: 1792 threads, each a chain of
// 8192 steps that waits on its own loads.
//
// Design: a segmented walk. A step is an affine map per channel
// (x -> entry[root] + val mod 256, or absolute), and such maps compose
// exactly, so a lane's b positions are cut into S segments of
// L = ceil(b / S) positions (the last ones shorter or empty) that run at
// the same time, in three phases inside one block:
//   1. walk: thread (j, g) walks segment j of lane g from the identity
//      state, writing its per-position (proot, pval) relative to the
//      segment's entry; its final px and 64 slots are its segment map M_j;
//   2. compose: per lane, E_0 = identity, E_{j+1} = E_j o M_j (per entry
//      and channel: root 0x41 stays (0x41, val), else
//      (E_j[root].root, E_j[root].val + val)); S sequential steps, the
//      65 entries x G lanes of a step spread over the block. E_j replaces
//      M_j in segment j's table; E_S is the lane's output map;
//   3. fix-up: segment j > 0 maps its relative (proot, pval) through E_j
//      by the same rule (segment 0 has E_0 = identity and skips it).
// Choices:
// - Shared memory: a thread keeps a 65-entry table (px + 64 slots, root
//   and val, 520 B) laid out [entry][thread], so a warp's accesses to any
//   entry row hit 32 distinct banks. A block is G lanes x S segments plus
//   2 x 65 x G words of running prefix maps, and holds all segments of its
//   lanes, so the compose needs no second launch.
// - Shape: G = 16 lanes x S = 12 segments, 192 threads and 116,480 B a
//   block, one block an SM: at 4K 112 blocks on 132 SMs, chains of 683
//   steps. In a sweep of G in {8, 16} and S in {8, 12, 16, 20, 24, 32} on
//   an H100 this was the fastest at 4K; more walking threads were not
//   faster: the kernel is bound by how well DRAM serves its scattered
//   row pieces, not by the chains. Narrower frames leave SMs idle (1080p:
//   32 blocks), which costs them little beside their decode's scans.
// - Coalescing: inputs stay position-major (b, nb). A warp is 16
//   consecutive lanes x 2 segments, so each load instruction uses its two
//   64 B row pieces whole.
// - Latency: the chain runs through the shared-memory table, not the
//   loads. The walk and the fix-up load kAhead positions ahead into a
//   register ring (the next chunk is in flight while the current one is
//   processed), and a step is branch-free selects, so a warp does not
//   diverge on the op class. The fix-up runs its segment backwards, so it
//   starts on the positions the walk wrote last, the ones most likely
//   still in L2.
// - Traffic: the fix-up re-reads and re-writes (proot, pval) of segments
//   1..S-1: 16 B more a position, 36 B in all against the bound's 20.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;      // consecutive lanes of a block
constexpr int kSegs = 12;       // segments of a lane
constexpr int kThreads = kLanes * kSegs;
constexpr int kEntries = 65;    // px + 64 table slots
constexpr int kPrefix = kEntries * kLanes;  // one prefix map of the block
constexpr int kSmem = (2 * kEntries * kThreads + 4 * kPrefix) * 4;
constexpr int kAhead = 16;      // positions loaded ahead
constexpr uint32_t kAbs = 0x41u;

// op classes (decode_v3 cls field)
constexpr int kClsAdd = 1, kClsRgb = 2, kClsRgba = 3, kClsIndex = 4;

__device__ __forceinline__ uint32_t swar_add(uint32_t a, uint32_t b) {
  uint32_t lo = ((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu;
  uint32_t hi = ((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u;
  return lo | hi;
}

// One entry (mr, mv) of a map taken through the prefix map E, whose entry
// e sits at er/ev[e * stride + col]. Roots are always <= 0x41.
__device__ __forceinline__ void through(uint32_t mr, uint32_t mv,
                                       const uint32_t* er,
                                       const uint32_t* ev, int stride,
                                       int col, uint32_t& out_r,
                                       uint32_t& out_v) {
  uint32_t r_out = 0u, v_out = 0u;
#pragma unroll
  for (int c = 0; c < 32; c += 8) {
    const uint32_t r = (mr >> c) & 0xFFu, v = (mv >> c) & 0xFFu;
    if (r == kAbs) {
      r_out |= kAbs << c;
      v_out |= v << c;
    } else {
      const int at = (int)r * stride + col;
      r_out |= er[at] & (0xFFu << c);
      v_out |= (((ev[at] >> c) + v) & 0xFFu) << c;
    }
  }
  out_r = r_out;
  out_v = v_out;
}

__global__ void __launch_bounds__(kThreads, 1)
block_maps_kernel(const int32_t* __restrict__ meta,
                  const uint32_t* __restrict__ d32,
                  const uint32_t* __restrict__ lit32,
                  uint32_t* __restrict__ proot, uint32_t* __restrict__ pval,
                  uint32_t* __restrict__ root, uint32_t* __restrict__ val,
                  int b, int nb) {
  constexpr int nt = kThreads, ne = kPrefix;
  extern __shared__ uint32_t smem[];
  uint32_t* troot = smem;                   // [65][nt]: 0 px, 1+s slot s
  uint32_t* tval = troot + kEntries * nt;
  uint32_t* eroot = tval + kEntries * nt;   // [2][65][kLanes] E_j, E_j+1
  uint32_t* evals = eroot + 2 * ne;
  const int t = threadIdx.x;
  const int g = t % kLanes, j = t / kLanes;
  const int n = blockIdx.x * kLanes + g;
  const int len = (b + kSegs - 1) / kSegs;
  const int i0 = min(b, j * len), i1 = min(b, i0 + len);
  // lanes past nb walk nothing, but keep every barrier
  const bool live = n < nb;

  // ---- 1. walk segment j of lane n from the identity state ----------
  for (int e = 1; e < kEntries; ++e) {
    troot[e * nt + t] = (uint32_t)e * 0x01010101u;
    tval[e * nt + t] = 0u;
  }
  uint32_t pr = 0u, pv = 0u;
  if (live) {
    int32_t mc[kAhead], mn[kAhead];
    uint32_t dc[kAhead], dn[kAhead], lc[kAhead], ln[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = i0 + k;
      const size_t at = (size_t)i * nb + n;
      mc[k] = i < i1 ? meta[at] : 0;
      dc[k] = i < i1 ? d32[at] : 0u;
      lc[k] = i < i1 ? lit32[at] : 0u;
    }
    for (int base = i0; base < i1; base += kAhead) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {  // the next chunk, in flight
        const int i = base + kAhead + k;
        const size_t at = (size_t)i * nb + n;
        mn[k] = i < i1 ? meta[at] : 0;
        dn[k] = i < i1 ? d32[at] : 0u;
        ln[k] = i < i1 ? lit32[at] : 0u;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = base + k;
        if (i < i1) {
          const int cls = mc[k] & 7;
          const int slot = (1 + ((mc[k] >> 3) & 63)) * nt + t;
          // an INDEX writes the slot it reads (w == r6), so one slot
          // serves both; other classes only write it
          const uint32_t sr = troot[slot], sv = tval[slot];
          uint32_t nr = pr, nv = pv;
          nv = cls == kClsAdd ? swar_add(pv, dc[k]) : nv;
          nv = cls == kClsRgb ? (lc[k] & 0x00FFFFFFu) | (pv & 0xFF000000u)
                              : nv;
          nr = cls == kClsRgb ? (pr & 0xFF000000u) | 0x00414141u : nr;
          nv = cls == kClsRgba ? lc[k] : nv;
          nr = cls == kClsRgba ? 0x41414141u : nr;
          nv = cls == kClsIndex ? sv : nv;
          nr = cls == kClsIndex ? sr : nr;
          if (cls != 0) {
            pr = nr;
            pv = nv;
            troot[slot] = pr;
            tval[slot] = pv;
          }
          const size_t at = (size_t)i * nb + n;
          proot[at] = pr;
          pval[at] = pv;
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        mc[k] = mn[k];
        dc[k] = dn[k];
        lc[k] = ln[k];
      }
    }
  }
  troot[t] = pr;
  tval[t] = pv;
  for (int x = t; x < ne; x += nt) {  // E_0 = identity
    eroot[x] = (uint32_t)(x / kLanes) * 0x01010101u;
    evals[x] = 0u;
  }
  __syncthreads();

  // ---- 2. compose: E_{j+1} = E_j o M_j, E_j left in segment j's table --
  int cur = 0;
  for (int js = 0; js < kSegs; ++js) {
    const uint32_t* cr = eroot + cur * ne;
    const uint32_t* cv = evals + cur * ne;
    uint32_t* nr = eroot + (cur ^ 1) * ne;
    uint32_t* nv = evals + (cur ^ 1) * ne;
    for (int x = t; x < ne; x += nt) {
      const int e = x / kLanes, gg = x % kLanes;
      const int at = e * nt + js * kLanes + gg;
      through(troot[at], tval[at], cr, cv, kLanes, gg, nr[x], nv[x]);
      troot[at] = cr[x];
      tval[at] = cv[x];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int x = t; x < ne; x += nt) {
    const int nn = blockIdx.x * kLanes + x % kLanes;
    if (nn < nb) {
      const size_t at = (size_t)(x / kLanes) * nb + nn;
      root[at] = eroot[cur * ne + x];
      val[at] = evals[cur * ne + x];
    }
  }

  // ---- 3. fix-up: segment j's relative px entries through E_j, chunks
  // from the last to the first --------------------------------------------
  if (!live || j == 0 || i1 <= i0) return;  // no barrier below
  const int nch = (i1 - i0 + kAhead - 1) / kAhead;
  uint32_t rc[kAhead], vc[kAhead], rn[kAhead], vn[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int i = i0 + (nch - 1) * kAhead + k;
    const size_t at = (size_t)i * nb + n;
    rc[k] = i < i1 ? proot[at] : 0u;
    vc[k] = i < i1 ? pval[at] : 0u;
  }
  for (int c = nch - 1; c >= 0; --c) {
    const int base = i0 + c * kAhead;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {  // the chunk before, in flight
      const int i = base - kAhead + k;
      const size_t at = (size_t)i * nb + n;
      rn[k] = c > 0 ? proot[at] : 0u;
      vn[k] = c > 0 ? pval[at] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = base + k;
      if (i < i1) {
        uint32_t orr, ov;
        through(rc[k], vc[k], troot, tval, nt, t, orr, ov);
        const size_t at = (size_t)i * nb + n;
        proot[at] = orr;
        pval[at] = ov;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      rc[k] = rn[k];
      vc[k] = vn[k];
    }
  }
}

}  // namespace

extern "C" int qoi_block_maps(const void* meta, const void* d32,
                              const void* lit32, void* proot, void* pval,
                              void* root, void* val, int b, int nb,
                              void* stream) {
  if (nb <= 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  block_maps_kernel<<<(nb + kLanes - 1) / kLanes, kThreads, kSmem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const uint32_t*)d32, (const uint32_t*)lit32,
      (uint32_t*)proot, (uint32_t*)pval, (uint32_t*)root, (uint32_t*)val, b,
      nb);
  return (int)cudaGetLastError();
}
