// Inclusive scans of the decoders' associative combines, one pass with a
// decoupled look-back: kernel of the PyTorch/CUDA port.
//
// Replaces qoi_tpu/ops/scans.py::blocked_scan (its lax.scan over
// position-in-block, :142) for the three combines the decode main path
// scans with it and v2's, in six entries:
//   qoi_fsm_scan      the chunk-start FSM (qoi_tpu/ops/fsm.py:82,
//                     _compose_maps): base-8 packed 5-state maps from the
//                     (M,) uint8 bytes; every inclusive map written (int32);
//   qoi_fsm_starts    the same scan applied to state 0, as
//                     chunk_starts_and_state (qoi_tpu/ops/fsm.py:70-89):
//                     (M,) bool starts and (M,) int8 state_before;
//   qoi_initial_scan  _initial_w's affine (alpha, hash) combine
//                     (qoi_tpu/models/decode_v3.py:197) on the 22-bit leaf
//                     [ra:1 | g:1 | t:6 | e:6 | va:8], co-scanned with the
//                     npix sum: every inclusive map (int32) and sum (int64);
//   qoi_initial_w     the same scan from the (M,) bytes and starts: each
//                     leaf is built in registers as _fields (decode_v3.py
//                     :88-127) and the leaf (:155-177) build it, and the scan
//                     is applied to the entry (hash, alpha): w and pix_off,
//                     int64, as _initial_w returns them;
//   qoi_anch_scan     _anch_comb, the anchored rebuild's 7-bit (g, e) leaf
//                     (decode_v3.py:238 over the stream, :266 over the
//                     surgical round's rows), each of R rows on its own;
//   qoi_resolve_scan  v2's per-channel reset-or-add combine
//                     (qoi_tpu/models/decode_v2.py:146, _resolve_scan
//                     :107-147): rflag and val, (4, M) uint8 channel-major,
//                     -> the (4, M) uint8 px after every byte with the seed
//                     epilogue of :147. A position's state is its four
//                     channels' value bytes and reset bytes (0xFF where
//                     set), combined byte-wise: a SWAR add without carries
//                     between bytes, selected by the later reset mask;
//                     a thread's 16 positions come in as four 16-byte
//                     rows of each input, transposed 4x4 bytes at a time.
// The maps are integers, so any grouping of an associative combine gives
// the same bits as JAX's scan. Element 0's map is its leaf unchanged and
// no identity of a combine is assumed (_initial_comb has none for
// arbitrary bit patterns): a thread's fold starts at its first element.
// Two folds start from a map that is an identity for the leaves they see:
// the FSM's (digit s -> s: an identity of _compose_maps), and the bytes
// form's ID leaf (g = 1), a two-sided identity of _initial_comb on leaves
// whose va is 0 unless ra, which every leaf built from bytes is.
//
// Design (one launch, after a memset of the ticket and a status word a tile):
//   1. ticket: each block takes its tile from an atomic counter, so a
//      tile never waits on one that has not started;
//   2. staging: the tile's input bytes (and 16 more: LUMA's second byte
//      and the literals read 4 ahead) as 16-byte cp.async copies into
//      shared memory, zero outside the row; any alignment of the input (a
//      streamed tile is a slice) is a word select and a funnel shift
//      inside the staged window;
//   3. fold once: each thread folds its elements into one map: the FSM's
//      by its digit step (all five digits at once, SWAR) on chunk lengths
//      found four bytes at a time, the bytes form's by a per-op update,
//      the leaf forms' by the combine;
//   4. block scan: warp shuffles, then the warp totals in shared memory;
//   5. look-back: warp 0 publishes the tile's aggregate, reads the status
//      words of the 32 tiles before it (a lane each), folds up to the
//      newest inclusive one, waits while a newer word is unpublished,
//      slides back 32 while all are aggregates, and publishes its own
//      inclusive prefix. A status word is flag | map (| the 40-bit npix
//      sum in the bytes form, whose npix <= 62); the leaf form's int64
//      sum goes to a slot of its own (aggregate or inclusive), written
//      before the word behind a __threadfence(), read after it behind
//      another; reads are volatile;
//   6. apply numerically: the starts and bytes forms apply the thread's
//      exclusive prefix to the entry state (0; the entry hash and alpha)
//      and walk the elements with the plain recurrence (s' = s ? s - 1 :
//      len - 1; h' = g*h + t*a + e, a' = ra ? va : a): one fold's work,
//      not a second one. The maps forms fold again and write every map;
//   7. stores: the byte outputs as 16-byte stores from registers; the
//      int32 and int64 ones through a 1 KB buffer a warp, so that each
//      16-byte store instruction fills whole 32-byte sectors. A ragged
//      last tile (or a row that starts off 16 bytes) stores element by
//      element.
// The resolve scan stages its eight input rows in 64.3 KB of dynamic
// shared memory and reads them again for the apply (fewer registers live
// across the look-back); its status word is flag << 62 | the four reset
// bits << 32 | the four value bytes.
// Tiles of 512 threads: 32 bytes a thread for the FSM and 16 leaves for
// anch (few, long tiles: the look-back costs a tile one to a few round
// trips to L2 while the block waits), 16 bytes for the bytes form and 8
// leaves for the leaf form (their registers), 16 positions for the
// resolve scan; 57-64 registers, no spills (the resolve scan: 20 bytes),
// 16.3-32.3 KB of shared memory (the resolve scan 64.3 KB), two blocks an
// SM.
//
// Bound on the H100: bytes. Each input read once, each output written
// once; at the 4K mixed stream's M = 14,680,064 and 3.35 TB/s: fsm_scan
// 5 B an element (0.022 ms), fsm_starts 3 B (0.013), initial_scan 20 B
// (0.088), initial_w 18 B (0.079), anch_scan 8 B (0.035); resolve_scan
// 12 B a byte of the stream (8 read, 4 written). The folds are 20-60
// integer operations an element, so at 64 integer lanes an SM the FSM and
// bytes forms are bound by issue nearly as much as by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kFsmMaps = 0, kFsmStarts = 1, kInitLeaf = 2, kInitBytes = 3,
            kAnch = 4, kResolve = 5 };

// status word flags: 0 not yet published
constexpr unsigned kAgg = 1u, kInc = 2u;

// the FSM's identity map (digit s holds s) and bit 0 of each digit
constexpr uint32_t kFsmId = (1u << 3) | (2u << 6) | (3u << 9) | (4u << 12);
constexpr uint32_t kDigit0 = 0x1249u;
// the seed px (0, 0, 0, 255): its hash and alpha
constexpr uint32_t kSeedHash = (11u * 255u) & 63u;
constexpr uint32_t kSeedAlpha = 255u;
// the 40-bit npix sum of the bytes form's status word
constexpr unsigned long long kSum40 = (1ull << 40) - 1ull;
// the seed px (0, 0, 0, 255) packed r | g << 8 | b << 16 | a << 24
constexpr uint32_t kSeedPx = 0xFF000000u;

template <int K>
struct Geo {
  static constexpr bool bytes = K == kFsmMaps || K == kFsmStarts ||
                                K == kInitBytes || K == kResolve;
  static constexpr bool sum = K == kInitLeaf || K == kInitBytes;
  // elements a thread: 32 FSM bytes and 16 anch leaves (fewer tiles, and
  // so fewer look-backs, for the light folds); 16 bytes for the bytes
  // form and the resolve scan, 8 initial leaves with their npix
  static constexpr int items = K == kInitLeaf ? 8
                               : (K == kFsmMaps || K == kFsmStarts) ? 32
                                                                    : 16;
  static constexpr int esz = bytes ? 1 : 4;        // input bytes an element
  static constexpr int tile = kThreads * items;
  // staged 16-byte chunks of an input: the tile's, and two for the halo
  // and the shift of an unaligned input
  static constexpr int chunks = kThreads * items * esz / 16 + 2;
  // input rows: the resolve scan's four channels of rflag and of val
  static constexpr int inputs = K == kResolve ? 8 : sum ? 2 : 1;
  // the staging area, reused as 64 chunks a warp for the stores
  static constexpr int smem = inputs * chunks > kWarps * 64
                                  ? inputs * chunks : kWarps * 64;
  // past 48 KB it is dynamic shared memory
  static constexpr bool dyn = smem * 16 > 48 * 1024;
};

struct V {
  uint32_t p;
  unsigned long long s;   // the npix sum (initial forms), the reset bytes
                          // (resolve)
};

struct Args {
  const uint8_t* in0;          // bytes, or int32 leaves
  const uint8_t* in1;          // starts (bytes form), npix (leaf form)
  uint8_t* out0;
  uint8_t* out1;
  const long long* entry;      // bytes form: the 0-d entry px, or null
  unsigned long long* ticket;
  unsigned long long* status;  // a word a tile, rows x nt
  unsigned long long* sums;    // leaf form: two a tile
  long long len;               // elements a row
  long long nt;                // tiles a row
  long long clen;              // starts form: chunks_len
};

__device__ __forceinline__ uint32_t fsm_comb(uint32_t a, uint32_t b) {
  uint32_t c = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const uint32_t as = (a >> (3 * s)) & 7u;
    c |= ((b >> (3 * as)) & 7u) << (3 * s);
  }
  return c;
}

__device__ __forceinline__ uint32_t initial_comb(uint32_t p1, uint32_t p2) {
  const uint32_t ra1 = p1 & 1u, g1 = (p1 >> 1) & 1u, t1 = (p1 >> 2) & 63u;
  const uint32_t e1 = (p1 >> 8) & 63u, va1 = (p1 >> 14) & 0xFFu;
  const uint32_t ra2 = p2 & 1u, g2 = (p2 >> 1) & 1u, t2 = (p2 >> 2) & 63u;
  const uint32_t e2 = (p2 >> 8) & 63u, va2 = (p2 >> 14) & 0xFFu;
  const uint32_t t = (g2 * t1 + (1u - ra1) * t2) & 63u;
  const uint32_t e = (g2 * e1 + e2 + ra1 * t2 * va1) & 63u;
  const uint32_t va = ra2 ? va2 : va1;
  return (ra1 | ra2) | ((g1 & g2) << 1) | (t << 2) | (e << 8) | (va << 14);
}

__device__ __forceinline__ uint32_t anch_comb(uint32_t p1, uint32_t p2) {
  const uint32_t g2 = p2 & 1u;
  return (p1 & g2) | (((g2 * (p1 >> 1) + (p2 >> 1)) & 63u) << 1);
}

// v2's reset-or-add on four channels at once: where the later reset byte
// m2 is set its value, else the sum mod 256
__device__ __forceinline__ uint32_t resolve_comb(uint32_t v1, uint32_t v2,
                                                 uint32_t m2) {
  return (v2 & m2) | (__vadd4(v1, v2) & ~m2);
}

// the reset bytes (each 0 or 0xFF) as four bits, and back
__device__ __forceinline__ uint32_t mask_bits(uint32_t m) {
  return ((m & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t mask_bytes(uint32_t b) {
  return ((b * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// the 4x4 byte transpose: o[k] byte c = x[c] byte k (its own inverse)
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t* o) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t2 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

template <int K>
__device__ __forceinline__ V comb(const V& a, const V& b) {
  V r;
  if constexpr (K == kFsmMaps || K == kFsmStarts) r.p = fsm_comb(a.p, b.p);
  else if constexpr (K == kAnch) r.p = anch_comb(a.p, b.p);
  else if constexpr (K == kResolve)
    r.p = resolve_comb(a.p, b.p, static_cast<uint32_t>(b.s));
  else r.p = initial_comb(a.p, b.p);
  r.s = Geo<K>::sum ? a.s + b.s : K == kResolve ? (a.s | b.s) : 0ull;
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_up(const V& v, int d) {
  V r{__shfl_up_sync(kFull, v.p, d), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_up_sync(kFull, v.s, d);
  if constexpr (K == kResolve)
    r.s = __shfl_up_sync(kFull, static_cast<uint32_t>(v.s), d);
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_down(const V& v, int d) {
  V r{__shfl_down_sync(kFull, v.p, d), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_down_sync(kFull, v.s, d);
  if constexpr (K == kResolve)
    r.s = __shfl_down_sync(kFull, static_cast<uint32_t>(v.s), d);
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_idx(const V& v, int src) {
  V r{__shfl_sync(kFull, v.p, src), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_sync(kFull, v.s, src);
  if constexpr (K == kResolve)
    r.s = __shfl_sync(kFull, static_cast<uint32_t>(v.s), src);
  return r;
}

// chunk_byte_len(b) - 1 of each byte b of x, in its byte: 1 for LUMA
// (bit 7 set, bit 6 clear), 3 for 0xFE, 4 for 0xFF (bits 1-7 all set:
// ~x & 0xFE is a zero byte, found without a borrow), else 0
__device__ __forceinline__ uint32_t fsm_len1x4(uint32_t x) {
  const uint32_t luma = x & ~(x << 1) & 0x80808080u;
  const uint32_t y = ~x & 0xFEFEFEFEu;
  const uint32_t lit = ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u;
  const uint32_t ff = lit & (x << 7);
  return (luma >> 7) + 3u * ((lit ^ ff) >> 7) + (ff >> 5);
}

// map m, then a byte of chunk length l + 1: every digit d -> d ? d - 1 : l
// (the nonzero digits lose 1 without a borrow; the zero ones take l)
__device__ __forceinline__ uint32_t fsm_step(uint32_t m, uint32_t l) {
  const uint32_t nz = (m | (m >> 1) | (m >> 2)) & kDigit0;
  return (m - nz) | ((nz ^ kDigit0) * l);
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// n 16-byte chunks of src into dst: chunk c holds bytes [off - lead + 16c,
// +16) of src (lead = src & 15, so that each chunk is one aligned copy),
// zero outside [0, nbytes). off is a multiple of 16. Whole chunks go by
// cp.async (in the caller's commit group); the row's edge chunks by plain
// loads and stores.
__device__ void stage(uint4* dst, const uint8_t* src, long long off,
                      long long nbytes, int n) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15u);
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const long long b0 = off + 16LL * c - lead;
    if (b0 >= 0 && b0 + 16 <= nbytes) {
      const unsigned sa =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(sa), "l"(src + b0));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b0 + b >= 0 && b0 + b < nbytes)
          w[b >> 2] |= static_cast<uint32_t>(src[b0 + b]) << (8 * (b & 3));
      dst[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// NW words of the staged bytes from byte `lead` of chunk c0 on
template <int NW>
__device__ __forceinline__ void extract(const uint4* sm, int c0, int lead,
                                        uint32_t* o) {
  constexpr int NC = (4 * NW + 15) / 16 + 1;
  uint32_t w[4 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint4 v = sm[c0 + c];
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
  const int q = lead >> 2;
  const uint32_t r = 8u * (lead & 3);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t lo = q == 0 ? w[j] : q == 1 ? w[j + 1]
                        : q == 2 ? w[j + 2] : w[j + 3];
    const uint32_t hi = q == 0 ? w[j + 1] : q == 1 ? w[j + 2]
                        : q == 2 ? w[j + 3] : w[j + 4];
    o[j] = __funnelshift_r(lo, hi, r);
  }
}

// The op of byte x (a chunk start when `start`) with its next four bytes
// lit = b2 | b3 << 8 | b4 << 16 | b5 << 24, packed op | v << 3 | va << 9
// | npix << 17. op 0 keeps h (no start; RUN), 1 adds v (DIFF, LUMA:
// the hash of the mod-256 deltas), 2 sets h = v (INDEX: r6), 3 sets
// h = v + 11 alpha (RGB: v = 3 b2 + 5 b3 + 7 b4), 4 sets h = v and
// alpha = va (RGBA: v = the literal's hash, va = b5).
__device__ __forceinline__ uint32_t chunk_op(uint32_t x, uint32_t lit,
                                             bool start) {
  const uint32_t b2 = lit & 0xFFu, two = x >> 6;
  const uint32_t c3 = __dp4a(lit, 0x00070503u, 0u);     // 3b2 + 5b3 + 7b4
  const uint32_t diff = 3u * ((x >> 4) & 3u) + 5u * ((x >> 2) & 3u)
                        + 7u * (x & 3u) - 30u;
  const uint32_t luma = 15u * (x & 63u) - 560u + 3u * (b2 >> 4)
                        + 7u * (b2 & 15u);
  const bool rgb = x == 0xFEu, rgba = x == 0xFFu;
  const uint32_t op = rgb ? 3u : rgba ? 4u : two == 0u ? 2u
                      : two == 3u ? 0u : 1u;
  const uint32_t v = rgb ? c3 : rgba ? c3 + 11u * (lit >> 24)
                     : two == 0u ? x : two == 1u ? diff : luma;
  const uint32_t npix = two == 3u && !rgb && !rgba ? (x & 63u) + 1u : 1u;
  const uint32_t va = rgba ? lit >> 24 : 0u;
  return start ? op | ((v & 63u) << 3) | (va << 9) | (npix << 17) : 0u;
}

// status word: flag << 32 | map; the bytes form: flag << 62 | map << 40 |
// the 40-bit sum; the resolve scan: flag << 62 | reset bits << 32 |
// values; the leaf form's sum in sums[2 * at + (flag == kInc)]
template <int K>
__device__ __forceinline__ void publish(const Args& a, long long at,
                                        unsigned flag, const V& v) {
  unsigned long long word;
  if constexpr (K == kResolve) {
    word = (static_cast<unsigned long long>(flag) << 62) |
           (static_cast<unsigned long long>(
                mask_bits(static_cast<uint32_t>(v.s))) << 32) | v.p;
  } else if constexpr (K == kInitBytes) {
    word = (static_cast<unsigned long long>(flag) << 62) |
           (static_cast<unsigned long long>(v.p) << 40) | (v.s & kSum40);
  } else {
    if constexpr (K == kInitLeaf) {
      *reinterpret_cast<volatile unsigned long long*>(
          a.sums + 2 * at + (flag == kInc)) = v.s;
      __threadfence();
    }
    word = (static_cast<unsigned long long>(flag) << 32) | v.p;
  }
  *reinterpret_cast<volatile unsigned long long*>(a.status + at) = word;
}

// A status word's flag and map (and the bytes form's sum); the leaf form's
// sum is read from its own slot by the caller.
template <int K>
__device__ __forceinline__ unsigned unpack(unsigned long long word, V& v) {
  if constexpr (K == kResolve) {
    v.p = static_cast<uint32_t>(word);
    v.s = mask_bytes(static_cast<uint32_t>(word >> 32) & 0xFu);
    return static_cast<unsigned>(word >> 62);
  } else if constexpr (K == kInitBytes) {
    v.p = static_cast<uint32_t>(word >> 40) & 0x3FFFFFu;
    v.s = word & kSum40;
    return static_cast<unsigned>(word >> 62);
  } else {
    v.p = static_cast<uint32_t>(word);
    v.s = 0ull;
    return static_cast<unsigned>(word >> 32);
  }
}

// lanes 0..last hold the maps of tiles hi, hi - 1, ..., hi - last: their
// fold, earliest first, on every lane
template <int K>
__device__ __forceinline__ V fold_back(V x, int last) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V y = shfl_down<K>(x, d);
    if (lane + d <= last) x = comb<K>(y, x);
  }
  return shfl_idx<K>(x, 0);
}

// One warp: the exclusive prefix of tile j > 0 of the row whose tile 0
// has status word at0. Lane l reads tile hi - l; the window folds up to
// its first inclusive word, waits while a word before that is
// unpublished, and slides back 32 tiles while all its words are
// aggregates.
template <int K>
__device__ V look_back(const Args& a, long long at0, long long j) {
  const int lane = threadIdx.x & 31;
  long long hi = j - 1;
  V acc{0u, 0ull};
  bool have = false;
  while (true) {
    const long long jj = hi - lane;
    V v{0u, 0ull};
    unsigned flag = kInc;   // before tile 0, which is inclusive: not reached
    if (jj >= 0) {
      flag = unpack<K>(*reinterpret_cast<const volatile unsigned long long*>(
                           a.status + at0 + jj), v);
      if constexpr (K == kInitLeaf) {
        if (flag != 0u) {
          __threadfence();
          v.s = *reinterpret_cast<const volatile unsigned long long*>(
              a.sums + 2 * (at0 + jj) + (flag == kInc));
        }
      }
    }
    const unsigned stop = __ballot_sync(kFull, flag != kAgg);
    if (stop != 0u) {
      const int first = __ffs(stop) - 1;
      if (__shfl_sync(kFull, flag, first) != kInc) {
        __nanosleep(32);
        continue;
      }
      const V w = fold_back<K>(v, first);
      return have ? comb<K>(w, acc) : w;
    }
    const V w = fold_back<K>(v, 31);
    acc = have ? comb<K>(w, acc) : w;
    have = true;
    hi -= 32;
  }
}

// Inclusive scan of one value a thread over the block; wt holds the warp
// totals' inclusive scan afterwards (wt[kWarps - 1]: the tile's fold).
template <int K>
__device__ V block_scan(V x, V* wt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V y = shfl_up<K>(x, d);
    if (lane >= d) x = comb<K>(y, x);
  }
  if (lane == 31) wt[w] = x;
  __syncthreads();
  if (w == 0) {
    V y = wt[lane < kWarps ? lane : kWarps - 1];
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const V z = shfl_up<K>(y, d);
      if (lane >= d) y = comb<K>(z, y);
    }
    if (lane < kWarps) wt[lane] = y;
  }
  __syncthreads();
  if (w > 0) x = comb<K>(wt[w - 1], x);
  return x;
}

// This lane's 32 bytes u: elements of esz (4 or 8) bytes from element e of
// the row at out_row, a thread's `items` elements apart from lane to lane.
// vec (a whole tile, 16-byte aligned rows): staged in the warp's buffer wb,
// they go out as 16-byte stores that fill 16 whole 32-byte sectors an
// instruction; else element by element within the row's len.
__device__ __forceinline__ void put32(uint4* wb, const uint32_t* u,
                                      uint8_t* out_row, long long e,
                                      long long len, int esz, int items,
                                      bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    wb[2 * lane] = make_uint4(u[0], u[1], u[2], u[3]);
    wb[2 * lane + 1] = make_uint4(u[4], u[5], u[6], u[7]);
    __syncwarp();
    uint8_t* d0 = out_row + (e - static_cast<long long>(lane) * items) * esz;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = lane + 32 * h;
      *reinterpret_cast<uint4*>(d0 + static_cast<long long>(x >> 1) * items
                                         * esz + (x & 1) * 16) = wb[x];
    }
    __syncwarp();
    return;
  }
  if (esz == 4) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (e + k < len) reinterpret_cast<uint32_t*>(out_row)[e + k] = u[k];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < len)
        reinterpret_cast<unsigned long long*>(out_row)[e + k] =
            u[2 * k] | (static_cast<unsigned long long>(u[2 * k + 1]) << 32);
  }
}

// row r of the resolve scan's inputs: channel r of rflag (r < 4), then
// channel r - 4 of val
__device__ __forceinline__ const uint8_t* resolve_row(const Args& a, int r) {
  return (r < 4 ? a.in0 : a.in1) + static_cast<long long>(r & 3) * a.len;
}

// the tile of ticket tk: its row, its index in the row
struct Tile {
  long long row, j;
};

__device__ __forceinline__ Tile tile_of(const Args& a, long long tk) {
  const long long row = tk / a.nt;
  return Tile{row, tk - row * a.nt};
}

// Issue the copies of tile tk's inputs into the staging buffer sm.
template <int K>
__device__ void stage_tile(const Args& a, uint4* sm, long long tk) {
  using G = Geo<K>;
  const Tile tl = tile_of(a, tk);
  const long long off = tl.j * G::tile * G::esz, nb = a.len * G::esz;
  if constexpr (K == kResolve) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
      stage(sm + r * G::chunks, resolve_row(a, r), off, nb, G::chunks);
  } else {
    stage(sm, a.in0 + tl.row * nb, off, nb, G::chunks);
    if constexpr (G::inputs == 2)
      stage(sm + G::chunks, a.in1 + tl.row * nb, off, nb, G::chunks);
  }
}

// The resolve scan's leaves of the thread whose 16 positions start at
// byte `lead` of staged chunk c0 of each row: values v (a byte a
// channel) and reset masks m (0xFF where the channel resets)
__device__ __forceinline__ void resolve_leaves(const Args& a,
                                               const uint4* sm, int c0,
                                               uint32_t* v, uint32_t* m) {
  constexpr int NCH = Geo<kResolve>::chunks;
  // one input at a time: its four channel rows, then their transpose
#pragma unroll
  for (int in = 0; in < 2; ++in) {
    uint32_t w[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 4 * in + c;
      const int lead = static_cast<int>(
          reinterpret_cast<uintptr_t>(resolve_row(a, r)) & 15u);
      extract<4>(sm + r * NCH, c0, lead, w[c]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4(w[0][q], w[1][q], w[2][q], w[3][q], (in ? v : m) + 4 * q);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = __vcmpne4(m[k], 0u);
}

// Element k of a leaf form's thread: its leaf and (initial) its npix,
// sign-extended
template <int K>
__device__ __forceinline__ V leaf_elem(const uint32_t* d, const uint32_t* np,
                                       int k) {
  V v{d[k], 0ull};
  if constexpr (K == kInitLeaf)
    v.s = static_cast<unsigned long long>(
        static_cast<long long>(static_cast<int32_t>(np[k])));
  return v;
}

// Tile tk, whose inputs are staged in sm: fold, block scan, look-back,
// apply, store. Every thread of the block calls it.
template <int K>
__device__ void process(const Args& a, uint4* sm, long long tk, V* wt,
                        V* tile_pre) {
  using G = Geo<K>;
  constexpr int IT = G::items, T = G::tile, NCH = G::chunks;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const Tile tl = tile_of(a, tk);
  const long long row = tl.row, j = tl.j;
  const long long first = j * T;        // the tile's first element
  const long long e = first + static_cast<long long>(IT) * t;  // this thread's
  const long long row0 = row * a.len;
  const uint8_t* src0 = a.in0 + row0 * G::esz;
  const uint8_t* src1 = G::inputs == 2 ? a.in1 + row0 * G::esz : nullptr;
  const int lead0 = static_cast<int>(reinterpret_cast<uintptr_t>(src0) & 15u);
  const int c0 = t * IT * G::esz / 16;

  // -- 3. the thread's elements, folded once
  uint32_t d[16];   // the bytes (+ 4 in the bytes form; the FSM's chunk
                    // lengths - 1 in their place), or the leaves (resolve:
                    // their values)
  uint32_t op[16];  // bytes form: each byte's op; leaf form: npix;
                    // resolve: the reset masks
  V x{0u, 0ull};
  if constexpr (K == kFsmMaps || K == kFsmStarts) {
    extract<IT / 4>(sm, c0, lead0, d);
#pragma unroll
    for (int w = 0; w < IT / 4; ++w) d[w] = fsm_len1x4(d[w]);
    uint32_t f = kFsmId;
#pragma unroll
    for (int k = 0; k < IT; ++k) f = fsm_step(f, byte_at(d, k));
    x.p = f;
  } else if constexpr (K == kInitBytes) {
    const int lead1 =
        static_cast<int>(reinterpret_cast<uintptr_t>(src1) & 15u);
    uint32_t s[4];
    extract<5>(sm, c0, lead0, d);
    extract<4>(sm + NCH, c0, lead1, s);
    d[5] = 0u;
    uint32_t g = 1u, tt = 0u, ee = 0u, ra = 0u, va = 0u, ns = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int q = (k + 1) >> 2, r = (k + 1) & 3;
      const uint32_t lit = r ? __funnelshift_r(d[q], d[q + 1], 8 * r) : d[q];
      op[k] = chunk_op(byte_at(d, k), lit, byte_at(s, k) != 0u);
      const uint32_t o = op[k] & 7u, v = (op[k] >> 3) & 63u;
      const bool set = o >= 2u;
      const uint32_t ev = (o == 3u && ra) ? v + 11u * va : v;
      ee = o == 1u ? ee + v : set ? ev : ee;
      tt = o == 3u ? (ra ? 0u : 11u) : set ? 0u : tt;
      g = set ? 0u : g;
      va = o == 4u ? (op[k] >> 9) & 0xFFu : va;
      ra = o == 4u ? 1u : ra;
      ns += op[k] >> 17;
    }
    x.p = ra | (g << 1) | (tt << 2) | ((ee & 63u) << 8) | (va << 14);
    x.s = ns;
  } else if constexpr (K == kResolve) {
    resolve_leaves(a, sm, c0, d, op);
    x = V{d[0], op[0]};
#pragma unroll
    for (int k = 1; k < IT; ++k) x = comb<K>(x, V{d[k], op[k]});
  } else {
    extract<IT>(sm, c0, lead0, d);
    if constexpr (K == kInitLeaf) {
      const int lead1 =
          static_cast<int>(reinterpret_cast<uintptr_t>(src1) & 15u);
      extract<IT>(sm + NCH, c0, lead1, op);
    }
    x = leaf_elem<K>(d, op, 0);
#pragma unroll
    for (int k = 1; k < IT; ++k) x = comb<K>(x, leaf_elem<K>(d, op, k));
  }

  // -- 4. block scan; 5. look-back
  const V inc = block_scan<K>(x, wt);
  V pre = shfl_up<K>(inc, 1);
  if (lane == 0 && wid > 0) pre = wt[wid - 1];
  if (wid == 0) {
    const V agg = wt[kWarps - 1];
    const long long at0 = row * a.nt;
    if (j == 0) {
      if (lane == 0) publish<K>(a, at0, kInc, agg);
    } else {
      if (lane == 0) publish<K>(a, at0 + j, kAgg, agg);
      const V ex = look_back<K>(a, at0, j);
      if (lane == 0) {
        publish<K>(a, at0 + j, kInc, comb<K>(ex, agg));
        *tile_pre = ex;
      }
    }
  }
  __syncthreads();
  bool has = t > 0;   // the thread has elements before it in its row
  if (j > 0) {
    pre = has ? comb<K>(*tile_pre, pre) : *tile_pre;
    has = true;
  }

  // -- 6. apply; 7. store
  const bool full = first + T <= a.len;
  uint4* wb = sm + wid * 64;
  if constexpr (K == kFsmStarts) {
    // the state before each byte, and the starts below chunks_len
    uint32_t s = has ? pre.p & 7u : 0u;
    const long long lim = a.clen - e;
#pragma unroll
    for (int h = 0; h < IT / 16; ++h) {
      uint32_t sw[4] = {0u, 0u, 0u, 0u}, bw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t st = s == 0u && 16 * h + k < lim ? 1u : 0u;
        bw[k >> 2] |= s << (8 * (k & 3));
        sw[k >> 2] |= st << (8 * (k & 3));
        s = s ? s - 1u : byte_at(d, 16 * h + k);
      }
      const long long eh = e + 16 * h;
      if (full) {
        *reinterpret_cast<uint4*>(a.out0 + eh) =
            make_uint4(sw[0], sw[1], sw[2], sw[3]);
        *reinterpret_cast<uint4*>(a.out1 + eh) =
            make_uint4(bw[0], bw[1], bw[2], bw[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (eh + k < a.len) {
            a.out0[eh + k] = static_cast<uint8_t>(byte_at(sw, k));
            a.out1[eh + k] = static_cast<uint8_t>(byte_at(bw, k));
          }
        }
      }
    }
  } else if constexpr (K == kFsmMaps) {
    uint32_t f = has ? pre.p : kFsmId;
#pragma unroll
    for (int r = 0; r < IT / 8; ++r) {
      uint32_t u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        f = fsm_step(f, byte_at(d, 8 * r + k));
        u[k] = f;
      }
      put32(wb, u, a.out0, e + 8 * r, a.len, 4, IT, full);
    }
  } else if constexpr (K == kInitBytes) {
    uint32_t h0 = kSeedHash, a0 = kSeedAlpha;
    if (a.entry != nullptr) {
      const uint32_t px = static_cast<uint32_t>(*a.entry);
      h0 = __dp4a(px, 0x0B070503u, 0u) & 63u;
      a0 = px >> 24;
    }
    uint32_t h = h0, al = a0;
    unsigned long long off = 0ull;
    if (has) {
      const uint32_t p = pre.p;
      h = ((p >> 1) & 1u) * h0 + ((p >> 2) & 63u) * a0 + ((p >> 8) & 63u);
      al = (p & 1u) ? (p >> 14) & 0xFFu : a0;
      off = pre.s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t uw[8], uo[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t o = op[4 * r + k], c = o & 7u, v = (o >> 3) & 63u;
        h = c == 1u ? h + v : c == 3u ? v + 11u * al : c >= 2u ? v : h;
        al = c == 4u ? (o >> 9) & 0xFFu : al;
        uw[2 * k] = h & 63u;
        uw[2 * k + 1] = 0u;
        uo[2 * k] = static_cast<uint32_t>(off);
        uo[2 * k + 1] = static_cast<uint32_t>(off >> 32);
        off += o >> 17;
      }
      put32(wb, uw, a.out0, e + 4 * r, a.len, 8, IT, full);
      put32(wb, uo, a.out1, e + 4 * r, a.len, 8, IT, full);
    }
  } else if constexpr (K == kResolve) {
    // the leaves again from shared memory, each inclusive state with the
    // seed added where no reset came, back to the four channel rows
    resolve_leaves(a, sm, c0, d, op);
    V acc = pre;
    uint32_t o[16];
#pragma unroll
    for (int k = 0; k < IT; ++k) {
      const V v{d[k], op[k]};
      acc = (has || k > 0) ? comb<K>(acc, v) : v;
      o[k] = resolve_comb(kSeedPx, acc.p, static_cast<uint32_t>(acc.s));
    }
    uint32_t w[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c4[4];
      transpose4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3], c4);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c][q] = c4[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint8_t* dst = a.out0 + static_cast<long long>(c) * a.len + e;
      if (e + IT <= a.len && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0u) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
      } else {
#pragma unroll
        for (int k = 0; k < IT; ++k)
          if (e + k < a.len) dst[k] = static_cast<uint8_t>(byte_at(w[c], k));
      }
    }
  } else {
    // the maps: every inclusive one, from the thread's prefix
    const bool vec = full && ((row0 * 4) & 15) == 0;
    uint8_t* out0 = a.out0 + row0 * 4;
    V acc = pre;
#pragma unroll
    for (int r = 0; r < IT / 8; ++r) {
      uint32_t up[8], us[16];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const V v = leaf_elem<K>(d, op, 8 * r + k);
        acc = (has || r > 0 || k > 0) ? comb<K>(acc, v) : v;
        up[k] = acc.p;
        us[2 * k] = static_cast<uint32_t>(acc.s);
        us[2 * k + 1] = static_cast<uint32_t>(acc.s >> 32);
      }
      put32(wb, up, out0, e + 8 * r, a.len, 4, IT, vec);
      if constexpr (K == kInitLeaf) {
        put32(wb, us, a.out1, e + 8 * r, a.len, 8, IT, vec);
        put32(wb, us + 8, a.out1, e + 8 * r + 4, a.len, 8, IT, vec);
      }
    }
  }
}

// One tile a block, the tile taken by ticket.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
one_pass_kernel(Args a) {
  extern __shared__ uint4 dyn_sm[];
  __shared__ uint4 fixed_sm[Geo<K>::dyn ? 1 : Geo<K>::smem];
  uint4* sm = Geo<K>::dyn ? dyn_sm : fixed_sm;
  __shared__ V wt[kWarps];
  __shared__ V tile_pre;
  __shared__ long long tk_s;
  if (threadIdx.x == 0)
    tk_s = static_cast<long long>(atomicAdd(a.ticket, 1ull));
  __syncthreads();
  const long long tk = tk_s;
  stage_tile<K>(a, sm, tk);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  process<K>(a, sm, tk, wt, &tile_pre);
}

// scratch (zeroed by the caller): the ticket, a status word a tile, and
// for the leaf form two sums a tile
template <int K>
int run(Args a, long long rows, void* scratch, void* stream) {
  if (rows <= 0 || a.len <= 0) return 0;
  a.nt = (a.len + Geo<K>::tile - 1) / Geo<K>::tile;
  const long long tiles = rows * a.nt;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  a.ticket = static_cast<unsigned long long*>(scratch);
  a.status = a.ticket + 1;
  a.sums = a.status + tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = 1 + tiles * (K == kInitLeaf ? 3 : 1);
  const size_t dyn = Geo<K>::dyn ? Geo<K>::smem * sizeof(uint4) : 0;
  cudaError_t e;
  if (dyn) {
    e = cudaFuncSetAttribute(one_pass_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaMemsetAsync(scratch, 0, words * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  one_pass_kernel<K><<<static_cast<unsigned>(tiles), kThreads, dyn, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* in0, const void* in1, void* out0, void* out1,
               long long len) {
  Args a{};
  a.in0 = static_cast<const uint8_t*>(in0);
  a.in1 = static_cast<const uint8_t*>(in1);
  a.out0 = static_cast<uint8_t*>(out0);
  a.out1 = static_cast<uint8_t*>(out1);
  a.len = len;
  return a;
}

}  // namespace

extern "C" int qoi_fsm_scan(const void* data, void* out, void* scratch,
                            long long m, void* stream) {
  return run<kFsmMaps>(make_args(data, nullptr, out, nullptr, m), 1,
                       scratch, stream);
}

extern "C" int qoi_fsm_starts(const void* data, void* starts, void* state,
                              void* scratch, long long m, long long clen,
                              void* stream) {
  Args a = make_args(data, nullptr, starts, state, m);
  a.clen = clen;
  return run<kFsmStarts>(a, 1, scratch, stream);
}

extern "C" int qoi_initial_scan(const void* leaf, const void* npix, void* ps,
                                void* inc, void* scratch, long long m,
                                void* stream) {
  return run<kInitLeaf>(make_args(leaf, npix, ps, inc, m), 1, scratch,
                        stream);
}

extern "C" int qoi_initial_w(const void* data, const void* starts,
                             const void* entry, void* w, void* pix_off,
                             void* scratch, long long m, void* stream) {
  Args a = make_args(data, starts, w, pix_off, m);
  a.entry = static_cast<const long long*>(entry);
  return run<kInitBytes>(a, 1, scratch, stream);
}

extern "C" int qoi_anch_scan(const void* leaf, void* out, void* scratch,
                             long long rows, long long len, void* stream) {
  return run<kAnch>(make_args(leaf, nullptr, out, nullptr, len), rows,
                    scratch, stream);
}

extern "C" int qoi_resolve_scan(const void* rflag, const void* val,
                                void* out, void* scratch, long long m,
                                void* stream) {
  return run<kResolve>(make_args(rflag, val, out, nullptr, m), 1, scratch,
                       stream);
}
