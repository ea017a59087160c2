// Decode pass 3 as a numeric re-scan: kernel I of the PyTorch/CUDA port.
//
// Replaces the lax.scan of qoi_tpu/models/decode_v3.py::_numeric_scan, the
// pass 3 of _resolve_p(apply="scan"): the differential anchor of the
// vectorized apply (_apply_symbolic). Inputs are position-major (b, nb)
// planes, meta = cls | w << 3 | r6 << 9, d32 and lit32 (u32 bit patterns),
// and the (65, nb) numeric entry state of every block lane from pass 2
// (row 0 the px, row 1+s slot s). Each lane's positions, in order from its
// entry state: a live step (cls != 0) sets px by the selects of
// decode_v3._step_common (ADD: bytewise add of d32, RGB: the literal's rgb
// under the running alpha, RGBA: the literal, INDEX: slot w, cls 5-7: px
// kept) and writes px to slot w; px is stored at [i, lane] after every
// position. The last lane's state after its last position is the exit
// state (px, slots).
//
// Bound on the H100: bytes. 12 B read and 4 B written a position, plus the
// entry states (65 x nb x 4 B): 235 MB at 4K mixed (b = 8192, nb = 1792),
// 0.070 ms at 3.35 TB/s. A lane walked one step at a time is a chain of b
// dependent steps through the slot table, whatever the loads do; with one
// thread a lane that chain (8192 steps of a shared-memory round trip and
// selects) and not the bytes set the time.
//
// The design breaks the chain by what an INDEX is. It reads and writes the
// same slot w, so it writes back what it read: an INDEX takes the px of
// the last earlier live non-INDEX step of its lane with the same w, else
// the slot as the lane entered. Every other step is a map of px, "set the
// bytes of a mask, add to the others" (ADD, RGB, RGBA; cls 0 and 5-7 the
// identity), and such maps compose. So a lane is a segmented map scan with
// INDEX steps as anchors that point strictly backwards, resolved 32
// positions at a time:
// - one warp a block lane, one thread a position of the window. The maps
//   compose by a segmented inclusive scan of shuffles (five steps), the
//   segments starting at the window's INDEX positions; a position's px is
//   its composed map applied to its anchor's value, or to the px carried
//   in from the previous window;
// - an INDEX's writer is the last earlier live non-INDEX lane with its w
//   (__match_any_sync); without one it takes the lane's slot table (64
//   words of shared memory a warp). A writer's px may hang on an earlier
//   INDEX of the window, so the values are a fixpoint: rounds of two
//   shuffles, from the table's values, until no value changes. Round k
//   fixes the k-th INDEX in order, so the result is the walk's; windows
//   without an in-window writer take no round;
// - each slot takes the px of its last live writer in the window, and the
//   window's last px is carried on: the chain is ~256 windows, not 8192
//   steps;
// - a block of kLanes warps serves kLanes adjacent lanes, so that the
//   position-major planes move as whole rows: a ring of kStages tiles of
//   kStage positions x kLanes lanes x three planes, filled by cp.async
//   kStages - 1 tiles ahead; px goes out through a shared tile stored row
//   by row. The tiles' rows have a pitch of kLanes + 1 words, so that a
//   warp's column of 32 rows falls in 32 banks; the copies are 4 bytes
//   wide for that reason (16-byte copies keep a word's bank mod 4, and a
//   column read of them conflicts 4 ways at least). Each thread copies
//   the same two rows and lane of every tile, from pointers that advance
//   a tile at a time: 64-bit address arithmetic a copy cost more issue
//   slots than the copies;
// - kLanes = 8 (32 B rows, one sector): nb = 1792 gives 224 blocks of 8
//   warps, all resident at once, two on 92 of the 132 SMs and one on 40;
//   nb = 512 (a 4 MiB streamed tile) gives 64 blocks on 64 SMs. 16 lanes
//   would put 16 warps on each of 32 SMs there, half as many SMs.
// What bounds it on the card is the window's instruction stream, not the
// bytes: the scan's five shuffle steps, the match and the resolve, with 8
// to 16 warps an SM to hide their latency. A deeper ring, 16 lanes a
// block, a prefix-sum form of the scan and two windows' scans interleaved
// were no faster (PERF.md).
// No atomics: the result does not depend on the schedule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWin = 32;                // positions a window, one a thread
constexpr int kLanes = 8;               // block lanes a block, one a warp
constexpr int kThreads = 32 * kLanes;
constexpr int kPitch = kLanes + 1;      // tile row pitch in words
constexpr int kStage = 64;              // positions a tile
constexpr int kStages = 3;              // tiles in the ring
constexpr int kTile = kStage * kPitch;  // words a tile of one plane
constexpr int kSlots = 64;

// op classes (decode_v3 cls field)
constexpr int kClsAdd = 1, kClsRgb = 2, kClsRgba = 3, kClsIndex = 4;

__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// the per-channel map (byte mask m: set to v; else add v mod 256) on x
__device__ __forceinline__ uint32_t apply_map(uint32_t m, uint32_t v,
                                              uint32_t x) {
  return (v & m) | (__vadd4(x, v) & ~m);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One window of a lane: the px after each of its 32 positions (one a
// thread). carry is the px before the window; tab the lane's 64 slots,
// updated to the window's end.
__device__ __forceinline__ uint32_t window(uint32_t mt, uint32_t d,
                                           uint32_t l, uint32_t& carry,
                                           uint32_t* tab, int lane) {
  const unsigned lt = (1u << lane) - 1, le = (2u << lane) - 1;
  const int cls = (int)(mt & 7);
  const uint32_t w = (mt >> 3) & 63;
  const bool live = cls != 0, is_idx = cls == kClsIndex;
  // the position's own map; INDEX (an anchor), cls 0 and 5-7: identity
  uint32_t m = cls == kClsRgba ? kFull : cls == kClsRgb ? 0x00FFFFFFu : 0u;
  uint32_t v = cls == kClsAdd    ? d
               : cls == kClsRgb  ? (l & 0x00FFFFFFu)
               : cls == kClsRgba ? l
                                 : 0u;
  const unsigned idx = __ballot_sync(kFull, is_idx);
  const unsigned livem = __ballot_sync(kFull, live);
  const int hb = (idx & le) ? top_bit(idx & le) : -1;  // the anchor
  // segmented inclusive scan: the maps from the anchor (or the window's
  // start) on, left then self
#pragma unroll
  for (int s = 1; s < kWin; s <<= 1) {
    const uint32_t lm = __shfl_up_sync(kFull, m, s);
    const uint32_t lv = __shfl_up_sync(kFull, v, s);
    const bool take = lane >= s && hb <= lane - s;
    v = take ? apply_map(m, v, lv) : v;
    m = take ? (m | lm) : m;
  }
  const unsigned same = __match_any_sync(kFull, w) & livem;
  uint32_t px;
  if (idx == 0) {
    px = apply_map(m, v, carry);
  } else {
    // an INDEX's writer: the last earlier live non-INDEX lane of its slot
    const unsigned wr = same & ~idx & lt;
    const bool dep = is_idx && wr != 0;
    const int src = dep ? top_bit(wr) : lane;
    const uint32_t c = carry;
    uint32_t val = is_idx ? tab[w] : 0u;
    auto px_of = [&](uint32_t x) {
      const uint32_t head = __shfl_sync(kFull, x, hb & 31);
      return apply_map(m, v, hb >= 0 ? head : c);
    };
    px = px_of(val);
    if (__any_sync(kFull, dep)) {
      for (;;) {  // fixpoint rounds: round k fixes the k-th INDEX
        const uint32_t got = __shfl_sync(kFull, px, src);
        const uint32_t nv = dep ? got : val;
        if (!__any_sync(kFull, nv != val)) break;
        val = nv;
        px = px_of(val);
      }
    }
  }
  __syncwarp();  // the table reads above come before its writes
  if (live && !(same & ~le)) tab[w] = px;  // each slot's last writer
  __syncwarp();
  carry = __shfl_sync(kFull, px, kWin - 1);
  return px;
}

__global__ void __launch_bounds__(kThreads)
    numeric_scan_kernel(const int32_t* __restrict__ meta,
                        const uint32_t* __restrict__ d32,
                        const uint32_t* __restrict__ lit32,
                        const uint32_t* __restrict__ entry,
                        uint32_t* __restrict__ px_out,
                        uint32_t* __restrict__ exit65, int b, int nb) {
  // the input ring: [tile][plane][row * kPitch + lane of the block]
  __shared__ uint32_t s_in[kStages][3][kTile];
  __shared__ uint32_t s_out[2][kTile];
  __shared__ uint32_t s_tab[kLanes][kSlots];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kLanes, n = n0 + wp;
  const bool active = n < nb;  // warp-uniform
  const int ntile = (b + kStage - 1) / kStage;
  uint32_t* tab = s_tab[wp];
  uint32_t carry = 0;
  if (active) {
    carry = entry[n];
    tab[lane] = entry[(size_t)(1 + lane) * nb + n];
    tab[lane + 32] = entry[(size_t)(33 + lane) * nb + n];
  }
  __syncwarp();

  // this thread's element of a tile: row r0 (and r0 + kRows), lane c
  constexpr int kRows = kThreads / kLanes;
  static_assert(kStage == 2 * kRows, "two rows a thread a tile");
  const int r0 = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const bool col_ok = n0 + c < nb;
  const size_t row_step = (size_t)kRows * nb, tile_step = (size_t)kStage * nb;
  const size_t first = (size_t)r0 * nb + n0 + c;
  const uint32_t* src_m = reinterpret_cast<const uint32_t*>(meta) + first;
  const uint32_t* src_d = d32 + first;
  const uint32_t* src_l = lit32 + first;
  uint32_t* dst_px = px_out + first;
  const int mine = r0 * kPitch + c;
  // tile t of the three planes into ring slot t % kStages (the sources
  // advance a tile a call); rows past b and lanes past nb are not copied
  // (no warp reads them as live positions)
  auto load = [&](int t) {
    const int i0 = t * kStage + r0;
    uint32_t* dst = s_in[t % kStages][0] + mine;
    if (col_ok && i0 < b) {
      cp_async4(dst, src_m);
      cp_async4(dst + kTile, src_d);
      cp_async4(dst + 2 * kTile, src_l);
    }
    if (col_ok && i0 + kRows < b) {
      cp_async4(dst + kRows * kPitch, src_m + row_step);
      cp_async4(dst + kTile + kRows * kPitch, src_d + row_step);
      cp_async4(dst + 2 * kTile + kRows * kPitch, src_l + row_step);
    }
    src_m += tile_step;
    src_d += tile_step;
    src_l += tile_step;
  };
  // tile t's px out, row by row (the destination advances a tile a call)
  auto store = [&](int t) {
    const int i0 = t * kStage + r0;
    const uint32_t* src = s_out[t & 1] + mine;
    if (col_ok && i0 < b) dst_px[0] = src[0];
    if (col_ok && i0 + kRows < b) dst_px[row_step] = src[kRows * kPitch];
    dst_px += tile_step;
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntile) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t
    // everyone's copies of tile t; every warp is done with tile t - 1,
    // whose ring slot the next load takes
    __syncthreads();
    if (t > 0) store(t - 1);
    if (t + kStages - 1 < ntile) load(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t* tin = s_in[t % kStages][0];
    uint32_t* tout = s_out[t & 1];
#pragma unroll
    for (int j = 0; j < kStage / kWin; ++j) {
      const int r = j * kWin + lane, i = t * kStage + r;
      if (t * kStage + j * kWin >= b) break;  // warp-uniform
      const int at = r * kPitch + wp;
      // positions past b: cls 0, the identity
      const uint32_t mt = i < b ? tin[at] : 0u;
      tout[at] = window(mt, tin[kTile + at], tin[2 * kTile + at], carry,
                        tab, lane);
    }
  }
  __syncthreads();
  if (ntile > 0) store(ntile - 1);
  if (n == nb - 1) {  // the stream's exit state: the last lane's
    __syncwarp();
    if (lane == 0) exit65[0] = carry;
    exit65[1 + lane] = tab[lane];
    exit65[33 + lane] = tab[lane + 32];
  }
}

}  // namespace

extern "C" int qoi_numeric_scan(const void* meta, const void* d32,
                                const void* lit32, const void* entry,
                                void* px_out, void* exit65, int b, int nb,
                                void* stream) {
  if (nb <= 0) return 0;
  numeric_scan_kernel<<<(nb + kLanes - 1) / kLanes, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const uint32_t*)d32, (const uint32_t*)lit32,
      (const uint32_t*)entry, (uint32_t*)px_out, (uint32_t*)exit65, b, nb);
  return (int)cudaGetLastError();
}
