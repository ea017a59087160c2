// The sequential QOI codec: two kernels of the PyTorch/CUDA port.
//
// They replace the two lax.scans of qoi_tpu/models/scan_codec.py:
// `_decode_scan` (the reference decoder from an entry state, qoi.h:540-587,
// `lax.scan` at :212) and `_encode_scan` (the reference encoder, qoi.h:
// 406-478, `lax.scan` at :123). They are the codec's sequential anchor, the
// decode ladder's floor without the native build, and the streamed
// decoder's repair of tiles whose fixpoint does not converge. Each computes
// what its scan computes, not the scan's one-pixel step.
//
// Pixels are packed u32 (r in the low byte). A decoder state is 65 words:
// the px, then the 64 slots.
//
// decode_scan. Bound on the H100: neither bytes nor operations but the
// dependent chain through the px and the 64-slot table, which one launch
// has to walk in stream order (a few bytes a pixel against 3.35 TB/s would
// take microseconds). The design keeps everything else off that chain.
// One block of three warps, joined by two rings in shared memory:
// - a producer warp stages the stream into a byte ring of 8 segments of
//   2 KiB with cp.async (16-byte vectors from the 16-byte aligned base
//   below `data`), ahead of the walk, and publishes each segment by a
//   flag; the front warp releases a segment once its windows are past it.
//   Ring offsets are 32-bit; global offsets stay 64-bit. No read on the
//   chain goes to device memory.
// - a front warp takes windows at fixed 32-byte positions. Each lane takes
//   the length of a chunk that would start at its byte (1, 2, 4 or 5);
//   five doubling steps of shuffles give each lane the chunk chain from
//   its byte as a lane mask, and where it leaves the window (J^32). The
//   chunk starts are the chain of the window's entry lane, and the next
//   window's entry is J^32 of this one's entry lane, less 32: the FSM that
//   ops/fsm.chunk_starts composes, inside a warp, with one shuffle a
//   window left between entries. A start at or past chunks_len ends the
//   chunk stream; a chunk's bytes past the buffer read byte data_len - 1.
//   The chunks' pixel counts (1, or run + 1) take a prefix by ballots of
//   their six bits, and each chunk's lane takes its map: RGB, RGBA, DIFF
//   and LUMA are per-channel maps (set, or add mod 256).
//   All of this reads bytes and entries only; the front runs it as a
//   pipeline two windows deep, without branches inside a window's steps
//   (the card schedules a warp's instructions only within straight code),
//   and hands each window to the walker through a ring of 32 windows.
// - the walker warp keeps the chain. One window ahead of it, a segmented
//   scan composes each lane's map from the last INDEX chunk (or the
//   window's entry px). A chunk whose first pixel is at or past n_px is
//   not read. The INDEX values are a fixpoint of the window: an INDEX
//   reads the last earlier chunk of the window whose px hashes to its slot
//   (six ballots over the hash bits), else the entry table's slot. Rounds
//   start from the entry table and end when no INDEX value changes; round
//   k fixes at least the k-th INDEX in order, so the result is the walk's,
//   and the adversarial stream (INDEX 5 throughout) takes one round. The
//   table lives in registers, slots l and l + 32 in lane l, and each slot
//   takes its last writer of the window.
// - each chunk's lane stores its pixels, so a window of single pixels is
//   one coalesced store and nothing waits on it; the tail past the chunk
//   stream repeats the last px, in 16-byte stores, with no table write.
//   Direct stores, not a shared-memory ring flushed as 16-byte vectors:
//   on the card that ring slowed the walk more than it saved.
//
// encode_scan. Bound on the H100: one SM's instruction issue, since the
// whole image goes through one block (the carry between groups is one
// table and one run); bytes would take 0.03 ms at 4K. The state is less
// sequential than the loop reads: prev is pixel i - 1; run membership, the
// run counter (cap 62, reset when emitted, the last pixel emitting) and
// the literal chunk depend only on pixels and on the last non-run index;
// the table at pixel i, slot s, is the last earlier non-run pixel hashing
// to s, or 0, so a hit is "that pixel equals p". One block of 1024 threads
// walks the image in groups of 1024 pixels: coalesced loads; the last
// non-run index by ballots and a max over the warps, carried between
// groups; the last writer of a slot within the warp by __match_any_sync,
// else the warps' per-slot last writers (a warp bitmask per slot), else the
// table carried from earlier groups; records out through shared memory as
// 16-byte stores, the table updated from each slot's last writer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kOpIndex = 0x00, kOpDiff = 0x40, kOpLuma = 0x80,
                   kOpRun = 0xC0, kOpRgb = 0xFE, kOpRgba = 0xFF;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255)
constexpr uint32_t kRunCap = 62;
constexpr unsigned kFull = 0xFFFFFFFFu;

// decode: the byte ring, segments x count; the window ring
constexpr int kSeg = 2048, kNSeg = 8, kRing = kSeg * kNSeg, kWin = 32;
// a wait for the other warp that takes this many sleeps is a fault: trap
// rather than hang
constexpr unsigned kSpinLimit = 1u << 26;

// encode: pixels a group, one per thread
constexpr int kGroup = 1024, kWarps = kGroup / 32;

__device__ __forceinline__ uint32_t hash64(uint32_t p) {
  return __dp4a(p, 0x0B070503u, 0u) & 63u;  // 3r + 5g + 7b + 11a
}

__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// the per-channel map (byte mask m: set to v; else add v mod 256) on x
__device__ __forceinline__ uint32_t apply_map(uint32_t m, uint32_t v,
                                              uint32_t x) {
  return (v & m) | (__vadd4(x, v) & ~m);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void sleep_or_trap(unsigned& spins) {
  __nanosleep(128);
  if (++spins > kSpinLimit) __trap();
}

// Step 1 of the window at a fixed position: its bytes, and for the chunk
// chain from each lane on, its positions in the window (a lane mask) and
// where it leaves the window (J^32: 32 chunks on, sticky once at or past
// 32). Neither depends on where the window's chain enters.
struct Jumps {
  uint32_t b[5];   // the bytes at the lane's position on
  unsigned chain;  // the chain's positions from this lane
  int j32;         // J^32
};

__device__ __forceinline__ void read_bytes(Jumps& a, const uint8_t* ring,
                                           long long w0, long long last,
                                           uint32_t lastbyte, int shift,
                                           int lane) {
  // the lane's five bytes from the two ring words that hold them
  const uint32_t r0 = (uint32_t)(w0 + shift) + lane;
  const uint32_t* ring32 = reinterpret_cast<const uint32_t*>(ring);
  const uint32_t lo = ring32[(r0 >> 2) & (kRing / 4 - 1)];
  const uint32_t hi = ring32[((r0 >> 2) + 1) & (kRing / 4 - 1)];
  const uint32_t sh = (r0 & 3) * 8;
  const uint32_t x = __funnelshift_r(lo, hi, sh);
  a.b[0] = x & 0xFF;
  a.b[1] = (x >> 8) & 0xFF;
  a.b[2] = (x >> 16) & 0xFF;
  a.b[3] = x >> 24;
  a.b[4] = (hi >> sh) & 0xFF;
  if (w0 + 35 > last) {  // the buffer's end: bytes past it read the last
    const long long beyond = last - w0;
    const int lim = beyond < 0 ? -1 : (int)beyond;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (lane + k > lim) a.b[k] = lastbyte;
  }
}

// J^1: the lane plus the length of a chunk starting at its byte
__device__ __forceinline__ int first_jump(const Jumps& a, int lane) {
  const uint32_t b1 = a.b[0];
  return lane + 1 + ((b1 & 0xC0) == kOpLuma) + 3 * (b1 == kOpRgb) +
         4 * (b1 == kOpRgba);
}

// doubling step: from J^(2^s) and the chain's first 2^s positions to
// J^(2^(s+1)) and its first 2^(s+1)
__device__ __forceinline__ void jump_step(Jumps& a, int& jump) {
  const int jj = __shfl_sync(kFull, jump, jump & 31);
  const unsigned cc = __shfl_sync(kFull, a.chain, jump & 31);
  if (jump < 32) {
    a.chain |= cc;
    jump = jj;
  }
}

// Steps 2-3 of a window from its chunk marks: the starts below chunks_len,
// the pixel counts and their inclusive prefix, the INDEX heads and each
// lane's own map. They read nothing of the walk's state.
struct Window {
  int cnt, inc;        // the lane's pixel count, inclusive prefix
  uint32_t m, v;       // the lane's own map
  int hb;              // the head: last INDEX lane at or before, else -1
  uint32_t slot;       // an INDEX lane's slot
};

__device__ __forceinline__ Window chunks_of(const Jumps& a, unsigned mark,
                                            long long w0,
                                            long long chunks_len, int lane) {
  const unsigned le = (2u << lane) - 1;
  const long long limit = chunks_len - w0;
  const unsigned cand = limit >= 32 ? mark
                        : limit > 0 ? mark & ((1u << (int)limit) - 1)
                                    : 0u;
  Window w;

  // 2. pixel counts (1, or run + 1) and their prefix by count-bit ballots
  const uint32_t b1 = a.b[0], tag = b1 & 0xC0;
  const bool c_on = (cand >> lane) & 1u;
  const bool is_run = tag == kOpRun && b1 < kOpRgb;
  w.cnt = c_on ? (is_run ? (int)(b1 & 63) + 1 : 1) : 0;
  w.inc = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    w.inc += __popc(__ballot_sync(kFull, (w.cnt >> k) & 1) & le) << k;

  // 3. the lane's map (set, or add mod 256, per channel); INDEX heads and
  // RUN are the identity. Masks, not branches, pick it.
  const bool is_idx = c_on && tag == kOpIndex;
  const unsigned idx = __ballot_sync(kFull, is_idx);
  const uint32_t rgb = a.b[1] | a.b[2] << 8 | a.b[3] << 16;
  const uint32_t vg = (b1 & 0x3F) - 32;
  const uint32_t diff = ((((b1 >> 4) & 3) - 2) & 0xFF) |
                        ((((b1 >> 2) & 3) - 2) & 0xFF) << 8 |
                        (((b1 & 3) - 2) & 0xFF) << 16;
  const uint32_t luma = ((vg - 8 + (a.b[1] >> 4)) & 0xFF) | (vg & 0xFF) << 8 |
                        ((vg - 8 + (a.b[1] & 15)) & 0xFF) << 16;
  const uint32_t own = 0u - (uint32_t)(c_on && !is_idx);
  const uint32_t k_rgba = own & (0u - (uint32_t)(b1 == kOpRgba));
  const uint32_t k_rgb = own & (0u - (uint32_t)(b1 == kOpRgb));
  const uint32_t k_diff = own & (0u - (uint32_t)(tag == kOpDiff));
  const uint32_t k_luma = own & (0u - (uint32_t)(tag == kOpLuma));
  w.m = k_rgba | (k_rgb & 0x00FFFFFFu);
  w.v = (k_rgba & (rgb | a.b[4] << 24)) | (k_rgb & rgb) | (k_diff & diff) |
        (k_luma & luma);
  const unsigned upto = idx & le;
  w.hb = upto ? top_bit(upto) : -1;
  w.slot = b1 & 63;
  return w;
}

// step d of the segmented scan of the maps (m, v): compose the map d
// lanes left, unless a head (hb) lies between
__device__ __forceinline__ void scan_step(uint32_t& m, uint32_t& v, int hb,
                                          int d, int lane) {
  const uint32_t lm = __shfl_up_sync(kFull, m, d);
  const uint32_t lv = __shfl_up_sync(kFull, v, d);
  const bool take = lane >= d && hb <= lane - d;  // left then self
  const uint32_t nv = apply_map(m, v, lv);
  v = take ? nv : v;
  m = take ? m | lm : m;
}

// step 1 for one window, as the pipeline's prologue runs it
__device__ __forceinline__ Jumps jumps_at(const uint8_t* ring, long long w0,
                                          long long last, uint32_t lastbyte,
                                          int shift, int lane) {
  Jumps a;
  read_bytes(a, ring, w0, last, lastbyte, shift, lane);
  int jump = first_jump(a, lane);
  a.chain = 1u << lane;
#pragma unroll
  for (int s = 0; s < 5; ++s) jump_step(a, jump);
  a.j32 = jump;
  return a;
}

__global__ void __launch_bounds__(96, 1)
    decode_scan_kernel(const uint8_t* __restrict__ data, long long data_len,
                       long long chunks_len, long long n_px,
                       const uint32_t* __restrict__ state_in,
                       uint32_t* __restrict__ out,
                       uint32_t* __restrict__ state_out) {
  __shared__ __align__(16) uint8_t ring[kRing];
  // the window ring: per window and lane the count | (head + 1) << 8 |
  // slot << 16, the inclusive prefix, the map's mask and value
  __shared__ uint32_t s_win[kWin][4][32];
  __shared__ int s_end[kWin];                // the window is past the end
  __shared__ volatile long long s_filled;    // segments staged
  __shared__ volatile long long s_released;  // segments below the front
  __shared__ volatile long long s_ready;     // windows the front published
  __shared__ volatile long long s_taken;     // windows the walker read
  __shared__ volatile int s_done;            // the walker has finished
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (data_len <= 0) chunks_len = 0;
  const long long last = data_len - 1;
  // the last byte the producer stages, in a 16-byte aligned frame
  const long long hi = (data_len < chunks_len + 4 ? data_len
                                                  : chunks_len + 4) - 1;
  const uintptr_t base = (uintptr_t)data & ~(uintptr_t)15;
  const int shift = (int)((uintptr_t)data - base);
  const long long nseg =
      chunks_len > 0 ? (shift + hi + 1 + kSeg - 1) / kSeg : 0;
  if (threadIdx.x == 0) {
    s_filled = 0;
    s_released = 0;
    s_ready = 0;
    s_taken = 0;
    s_done = 0;
  }
  __syncthreads();

  if (warp == 0) {  // ---- the producer warp: bytes into the ring
    const long long end = shift + hi + 1;
    for (long long g = 0; g < nseg; ++g) {
      int stop = 0;
      if (lane == 0) {
        unsigned spins = 0;
        while (g >= s_released + kNSeg && !s_done) sleep_or_trap(spins);
        stop = s_done;
      }
      if (__shfl_sync(kFull, stop, 0)) break;
      uint8_t* dst = ring + (int)(g % kNSeg) * kSeg;
      for (int k = lane; k < kSeg / 16; k += 32) {
        const long long a = g * kSeg + 16LL * k;
        if (a < end) cp_async16(dst + 16 * k, (const void*)(base + a));
      }
      cp_async_wait_all();
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        s_filled = g + 1;
      }
    }
    return;
  }

  if (warp == 1) {  // ---- the front warp: steps 1-3 of every window
    const uint32_t lastbyte = data_len > 0 ? data[last] : 0;
    long long avail = 0, rel = 0, taken = 0, check = 0;
    bool stop = false;
    // release the segments below the window at q; wait for the segment
    // of the last byte it can read (or the walker's end). Both change
    // only where q crosses `check`.
    auto stage = [&](long long q) {
      if (q < check) return;
      const long long seg_lo = (q + shift) / kSeg;
      if (seg_lo != rel) {
        rel = seg_lo;
        if (lane == 0) {
          __threadfence_block();
          s_released = rel;
        }
      }
      long long need = ((q + 35 < hi ? q + 35 : hi) + shift) / kSeg + 1;
      if (need > nseg) need = nseg;  // past the staged bytes: nothing to wait
      if (need > avail) {
        long long f = 0;
        int d = 0;
        if (lane == 0) {
          unsigned spins = 0;
          while ((f = s_filled) < need && !(d = s_done))
            sleep_or_trap(spins);
          __threadfence_block();
        }
        avail = __shfl_sync(kFull, f, 0);
        stop = __shfl_sync(kFull, d, 0);
        __syncwarp();
      }
      check = (rel + 1) * kSeg - shift;
      if (avail < nseg && avail * kSeg - shift - 35 < check)
        check = avail * kSeg - shift - 35;
    };
    // publish windows up to t to the walker
    auto ready_to = [&](long long t) {
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        s_ready = t + 1;
      }
    };
    // hand window t to the walker once its slot is free; tell it every
    // 4 windows, and at the end
    auto publish = [&](const Window& w, long long t, int end) {
      if (t - taken >= kWin) {
        ready_to(t - 1);
        long long f = 0;
        int d = 0;
        if (lane == 0) {
          unsigned spins = 0;
          while (t - (f = s_taken) >= kWin && !(d = s_done))
            sleep_or_trap(spins);
          __threadfence_block();
        }
        taken = __shfl_sync(kFull, f, 0);
        stop = __shfl_sync(kFull, d, 0);
        __syncwarp();
        if (stop) return;
      }
      const int k = (int)(t % kWin);
      s_win[k][0][lane] =
          (uint32_t)w.cnt | (uint32_t)(w.hb + 1) << 8 | w.slot << 16;
      s_win[k][1][lane] = (uint32_t)w.inc;
      s_win[k][2][lane] = w.m;
      s_win[k][3][lane] = w.v;
      if (lane == 0) s_end[k] = end;
      if (end || (t & 3) == 3) ready_to(t);
    };

    // The pipeline: in the iteration of window t at w0 (entry lane e), w
    // is window t, a1 window t + 1's chains (entry e1). The iteration
    // takes window t + 2's chains and t + 1's starts (the chain from its
    // entry), then hands t on. A window's entry is where the chain from
    // the previous window's entry leaves it.
    stage(0);
    const Jumps a0 = jumps_at(ring, 0, last, lastbyte, shift, lane);
    Window w = chunks_of(a0, __shfl_sync(kFull, a0.chain, 0), 0, chunks_len,
                         lane);
    stage(32);
    Jumps a1 = jumps_at(ring, 32, last, lastbyte, shift, lane);
    int e = 0, e1 = __shfl_sync(kFull, a0.j32, 0) - 32;
    for (long long t = 0, w0 = 0; !stop; ++t, w0 += 32) {
      if (w0 + e >= chunks_len) {
        publish(w, t, 1);
        break;
      }
      stage(w0 + 64);
      Jumps a2;
      read_bytes(a2, ring, w0 + 64, last, lastbyte, shift, lane);
      int jump = first_jump(a2, lane);
      a2.chain = 1u << lane;
#pragma unroll
      for (int s = 0; s < 5; ++s) jump_step(a2, jump);
      a2.j32 = jump;
      const Window wn = chunks_of(a1, __shfl_sync(kFull, a1.chain, e1),
                                  w0 + 32, chunks_len, lane);
      const int e2 = __shfl_sync(kFull, a1.j32, e1) - 32;
      publish(w, t, 0);
      if ((t & 15) == 15) {  // the walker may have stopped at n_px
        int d = 0;
        if (lane == 0) d = s_done;
        stop = stop || __shfl_sync(kFull, d, 0);
      }
      w = wn;
      a1 = a2;
      e = e1;
      e1 = e2;
    }
    return;
  }

  // ---- the walker warp: the scan of the maps, steps 4-6
  uint32_t tab_lo = state_in[1 + lane], tab_hi = state_in[33 + lane];
  uint32_t px = state_in[0];
  const unsigned lt = (1u << lane) - 1;
  long long i0 = 0, ready = 0;
  // window t's record, once the front has published it
  auto load = [&](long long t, uint32_t& packed, int& inc, uint32_t& m,
                  uint32_t& v, int& end) {
    if (t >= ready) {
      long long f = 0;
      if (lane == 0) {
        unsigned spins = 0;
        while ((f = s_ready) <= t) sleep_or_trap(spins);
        __threadfence_block();
      }
      ready = __shfl_sync(kFull, f, 0);
      __syncwarp();
    }
    const int k = (int)(t % kWin);
    packed = s_win[k][0][lane];
    inc = (int)s_win[k][1][lane];
    m = s_win[k][2][lane];
    v = s_win[k][3][lane];
    end = s_end[k];
  };
  // window t in (packed, inc, wm, wv, end), its maps scanned; the next
  // window's scan goes beside window t's steps 4-6
  uint32_t packed = 0, wm = 0, wv = 0;
  int inc = 0, end = 1;
  if (n_px > 0) {
    load(0, packed, inc, wm, wv, end);
#pragma unroll
    for (int s = 0; s < 5; ++s)
      scan_step(wm, wv, (int)((packed >> 8) & 0xFF) - 1, 1 << s, lane);
  }
  for (long long t = 0; i0 < n_px && !end; ++t) {
    uint32_t packed1, wm1, wv1;
    int inc1, end1;
    load(t + 1, packed1, inc1, wm1, wv1, end1);
    __syncwarp();
    if ((t & 7) == 7 && lane == 0) {  // slots up to t + 1 are free again
      __threadfence_block();
      s_taken = t + 2;
    }
    const int hb1 = (int)((packed1 >> 8) & 0xFF) - 1;
#pragma unroll
    for (int s = 0; s < 5; ++s) scan_step(wm1, wv1, hb1, 1 << s, lane);
    const int cnt = (int)(packed & 0xFF);
    const int hb = (int)((packed >> 8) & 0xFF) - 1;
    const uint32_t slot = packed >> 16;

    // the n_px cut: the active chunks are a prefix of the candidates
    const long long room = n_px - i0;
    const unsigned act = __ballot_sync(kFull, cnt > 0 && inc - cnt < room);
    const bool a_on = (act >> lane) & 1u;
    const bool is_idx = a_on && hb == lane;

    // 4. INDEX values: fixpoint rounds from the entry table's slots
    const uint32_t t_lo = __shfl_sync(kFull, tab_lo, slot & 31);
    const uint32_t t_hi = __shfl_sync(kFull, tab_hi, slot & 31);
    const uint32_t tabv = slot & 32 ? t_hi : t_lo;
    uint32_t val = tabv, pxl;
    unsigned bl[6];
    auto round = [&]() {
      const uint32_t head = __shfl_sync(kFull, val, hb & 31);
      pxl = apply_map(wm, wv, hb >= 0 ? head : px);
      const uint32_t h = hash64(pxl);
#pragma unroll
      for (int b = 0; b < 6; ++b)
        bl[b] = __ballot_sync(kFull, a_on && ((h >> b) & 1u));
      unsigned wr = act & lt;
#pragma unroll
      for (int b = 0; b < 6; ++b) wr &= (slot >> b) & 1u ? bl[b] : ~bl[b];
      const uint32_t got = __shfl_sync(kFull, pxl, wr ? top_bit(wr) : lane);
      const uint32_t nv = is_idx ? (wr ? got : tabv) : val;
      const bool changed = __any_sync(kFull, nv != val);
      val = nv;
      return changed;
    };
    if (round())
      while (round()) {
      }

    // 5. each slot takes its last writer; the window's exit px
    unsigned w_lo = act, w_hi = act;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const unsigned sel = (lane >> b) & 1 ? bl[b] : ~bl[b];
      w_lo &= sel;
      w_hi &= sel;
    }
    w_lo &= ~bl[5];
    w_hi &= bl[5];
    const uint32_t g_lo = __shfl_sync(kFull, pxl, w_lo ? top_bit(w_lo) : 0);
    const uint32_t g_hi = __shfl_sync(kFull, pxl, w_hi ? top_bit(w_hi) : 0);
    if (w_lo) tab_lo = g_lo;
    if (w_hi) tab_hi = g_hi;
    const int top = top_bit(act);
    px = __shfl_sync(kFull, pxl, top);
    const int end_top = __shfl_sync(kFull, inc, top);

    // 6. each active chunk's lane stores its pixels: a window of single
    // pixels is one coalesced store
    if (a_on) {
      const long long off = inc - cnt;
      const int c = room - off < cnt ? (int)(room - off) : cnt;
      uint32_t* dst = out + i0 + off;
      for (int r = 0; r < c; ++r) dst[r] = pxl;
    }
    i0 += room < end_top ? room : end_top;
    packed = packed1;
    inc = inc1;
    wm = wm1;
    wv = wv1;
    end = end1;
  }
  if (lane == 0) s_done = 1;

  // the tail: the last px repeats, in 16-byte stores where aligned
  const long long al = (i0 + 3) & ~3LL;
  const long long head_end = al < n_px ? al : n_px;
  if (i0 + lane < head_end) out[i0 + lane] = px;
  const long long vend = n_px & ~3LL;
  const uint4 pv = make_uint4(px, px, px, px);
  for (long long f = al + 4LL * lane; f < vend; f += 128)
    *reinterpret_cast<uint4*>(out + f) = pv;
  const long long t0 = vend > head_end ? vend : head_end;
  if (t0 + lane < n_px) out[t0 + lane] = px;

  state_out[1 + lane] = tab_lo;
  state_out[33 + lane] = tab_hi;
  if (lane == 0) state_out[0] = px;
}

__device__ __forceinline__ int s8(int x) { return (int)(int8_t)(uint8_t)x; }

// a table miss's literal chunk (qoi.h:438-474): bytes in o[0..4], length
__device__ __forceinline__ int literal(uint32_t p, uint32_t prev,
                                       uint32_t o[5]) {
  const uint32_t r = p & 0xFF, g = (p >> 8) & 0xFF, b = (p >> 16) & 0xFF,
                 a = p >> 24;
  const int vr = s8((int)r - (int)(prev & 0xFF));
  const int vg = s8((int)g - (int)((prev >> 8) & 0xFF));
  const int vb = s8((int)b - (int)((prev >> 16) & 0xFF));
  const int vg_r = s8(vr - vg), vg_b = s8(vb - vg);
  o[1] = o[2] = o[3] = o[4] = 0;
  if (a != prev >> 24) {
    o[0] = kOpRgba; o[1] = r; o[2] = g; o[3] = b; o[4] = a;
    return 5;
  }
  if (vr >= -2 && vr <= 1 && vg >= -2 && vg <= 1 && vb >= -2 && vb <= 1) {
    o[0] = kOpDiff | (uint32_t)(vr + 2) << 4 | (uint32_t)(vg + 2) << 2 |
           (uint32_t)(vb + 2);
    return 1;
  }
  if (vg >= -32 && vg <= 31 && vg_r >= -8 && vg_r <= 7 && vg_b >= -8 &&
      vg_b <= 7) {
    o[0] = kOpLuma | (uint32_t)(vg + 32);
    o[1] = (uint32_t)(vg_r + 8) << 4 | (uint32_t)(vg_b + 8);
    return 2;
  }
  o[0] = kOpRgb; o[1] = r; o[2] = g; o[3] = b;
  return 4;
}

__global__ void __launch_bounds__(kGroup, 1)
    encode_scan_kernel(const uint32_t* __restrict__ pixels, long long n,
                       uint8_t* __restrict__ staging,
                       int32_t* __restrict__ lens) {
  __shared__ uint32_t s_table[64];
  __shared__ unsigned s_wmask[64];         // warps that wrote each slot
  __shared__ uint32_t s_lastw[kWarps][64];  // a warp's last writer's pixel
  __shared__ int s_wlast[kWarps];  // a warp's last non-run pixel (-1: none)
  __shared__ long long s_carry;    // the last non-run index before a group
  __shared__ __align__(16) uint8_t s_stage[6 * kGroup];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1;
  if (t < 64) {
    s_table[t] = 0;
    s_wmask[t] = 0;
  }
  if (t == 0) s_carry = -1;
  uint32_t p_next = t < n ? __ldg(pixels + t) : 0;
  for (long long g0 = 0; g0 < n; g0 += kGroup) {
    __syncthreads();  // the previous group's table, carry and records
    const long long i = g0 + t;
    const bool valid = i < n;
    const uint32_t p = p_next;
    p_next = i + kGroup < n ? __ldg(pixels + i + kGroup) : 0;
    uint32_t prev = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) prev = i > 0 && valid ? __ldg(pixels + i - 1) : kSeed;
    const bool lit = valid && p != prev;
    const unsigned ball = __ballot_sync(kFull, lit);
    if (lane == 0) s_wlast[warp] = ball ? warp * 32 + top_bit(ball) : -1;
    const uint32_t h = hash64(p);
    const unsigned wm = __match_any_sync(kFull, lit ? h : 64u + lane);
    if (lit && top_bit(wm) == lane) {  // the warp's last writer of slot h
      s_lastw[warp][h] = p;
      atomicOr(&s_wmask[h], 1u << warp);
    }
    const unsigned mw = wm & lt;
    const uint32_t tv_warp = __shfl_sync(kFull, p, mw ? top_bit(mw) : lane);
    __syncthreads();

    // the last non-run index at or before i - 1
    const int wl = __reduce_max_sync(kFull, lane < warp ? s_wlast[lane] : -1);
    const long long carry = s_carry;
    const unsigned m_lt = ball & lt;
    const long long before = m_lt ? g0 + warp * 32 + top_bit(m_lt)
                             : wl >= 0 ? g0 + wl : carry;
    uint32_t o[6] = {0, 0, 0, 0, 0, 0};
    int len = 0;
    if (valid && !lit) {
      // a run member keeps its run byte in byte 0, emitted only at the
      // cap or the last pixel (qoi.h:415-421)
      const uint32_t run = (uint32_t)(i - before - 1) % kRunCap + 1;
      o[0] = kOpRun | (run - 1);
      len = run == kRunCap || i == n - 1;
    } else if (lit) {
      uint32_t tv;
      if (mw) {
        tv = tv_warp;
      } else {
        const unsigned wk = s_wmask[h] & ((1u << warp) - 1);
        tv = wk ? s_lastw[top_bit(wk)][h] : s_table[h];
      }
      uint32_t own[5] = {kOpIndex | h, 0, 0, 0, 0};
      const int own_len = tv == p ? 1 : literal(p, prev, own);
      const uint32_t run_before = (uint32_t)(i - 1 - before) % kRunCap;
      if (run_before) {  // flush the pending run first (qoi.h:425-428)
        o[0] = kOpRun | (run_before - 1);
#pragma unroll
        for (int k = 0; k < 5; ++k) o[1 + k] = own[k];
        len = own_len + 1;
      } else {
#pragma unroll
        for (int k = 0; k < 5; ++k) o[k] = own[k];
        len = own_len;
      }
    }
    uint16_t* st = reinterpret_cast<uint16_t*>(s_stage + 6 * t);
    st[0] = (uint16_t)(o[0] | o[1] << 8);
    st[1] = (uint16_t)(o[2] | o[3] << 8);
    st[2] = (uint16_t)(o[4] | o[5] << 8);
    if (valid) lens[i] = len;
    __syncthreads();

    // the table from each slot's last writer; the carry; records out
    if (t < 64) {
      const unsigned wk = s_wmask[t];
      if (wk) s_table[t] = s_lastw[top_bit(wk)][t];
      s_wmask[t] = 0;
    }
    if (warp == 2) {
      const int all = __reduce_max_sync(kFull, s_wlast[lane]);
      if (lane == 0 && all >= 0) s_carry = g0 + all;
    }
    const long long nb = 6 * (n - g0 < kGroup ? n - g0 : kGroup);
    uint8_t* dst = staging + 6 * g0;
    for (long long k = t; k < nb / 16; k += kGroup)
      reinterpret_cast<uint4*>(dst)[k] =
          reinterpret_cast<const uint4*>(s_stage)[k];
    for (long long k = (nb & ~15LL) + t; k < nb; k += kGroup)
      dst[k] = s_stage[k];
  }
}

}  // namespace

extern "C" int qoi_decode_scan(const void* data, long long data_len,
                               long long chunks_len, long long n_px,
                               const void* state_in, void* out,
                               void* state_out, void* stream) {
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  decode_scan_kernel<<<1, 96, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, data_len, chunks_len, n_px,
      (const uint32_t*)state_in, (uint32_t*)out, (uint32_t*)state_out);
  return (int)cudaGetLastError();
}

extern "C" int qoi_encode_scan(const void* pixels, long long n, void* staging,
                               void* lens, void* stream) {
  if ((uintptr_t)staging & 15) return (int)cudaErrorMisalignedAddress;
  encode_scan_kernel<<<1, kGroup, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pixels, n, (uint8_t*)staging, (int32_t*)lens);
  return (int)cudaGetLastError();
}
