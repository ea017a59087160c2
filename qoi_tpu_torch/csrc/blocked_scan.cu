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
//                     epilogue of :147; a kernel of its own,
//                     resolve_kernel (below).
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
// Tiles of 512 threads: 32 bytes a thread for the FSM and 16 leaves for
// anch (few, long tiles: the look-back costs a tile one to a few round
// trips to L2 while the block waits), 16 bytes for the bytes form and 8
// leaves for the leaf form (their registers); 57-64 registers, no spills,
// 16.3-32.3 KB of shared memory, two blocks an SM.
//
// resolve_kernel, v2's scan, keeps the ticket, the status words and the
// look-back (step 5, the same code on its own state) but stages nothing:
// a tile is 256 threads x two lanes of 16 positions, 4096 positions
// apart (8192), two blocks an SM, 124 registers and 144 bytes of shared
// memory (the warp totals).
//   1. loads: in a whole tile whose eight rows (rflag's four channels,
//      then val's) and the output start on 16 bytes, each lane's 16
//      positions of each row are one 16-byte non-caching load, a warp's
//      512 contiguous bytes, all sixteen issued before the first is used;
//      else (a ragged last tile, M % 16 != 0, a view at an offset) the
//      16-byte chunks that hold them, a whole chunk by one load and the
//      row's edge chunks byte by byte, joined by a funnel shift;
//   2. one transpose: the values 4x4 bytes at a time into 16 words
//      (position k's four channels), the flags into 4 bits a position,
//      two words (byte c bit i: channel c at position 8h + i; a nonzero
//      flag byte is set, as JAX's maximum and rb != 0 read it);
//   3. fold and apply over the same registers: a state is four value
//      bytes and four reset bytes; b after a is the byte-wise sum of
//      a & ~mask(b) and b (seven bits added, the top bit by exclusive
//      or), the mask from the flag bits by prmt's sign mode. The apply
//      starts from the seed (0, 0, 0, 255) as a state that resets every
//      channel, so each inclusive state's values are the px;
//   4. stores: the px back to the four channel rows by the same
//      transpose, 16-byte streaming stores, a warp's 512 contiguous bytes
//      a row (byte by byte where a row is not on 16 bytes or past M).
// Its status word is flag << 62 | the four reset bits << 32 | the four
// values.
//
// Bound on the H100: bytes. Each input read once, each output written
// once; at the 4K mixed stream's M = 14,680,064 and 3.35 TB/s: fsm_scan
// 5 B an element (0.022 ms), fsm_starts 3 B (0.013), initial_scan 20 B
// (0.088), initial_w 18 B (0.079), anch_scan 8 B (0.035); resolve_scan
// 12 B a position (8 read, 4 written; 0.0601 ms at the 4K photo stream's
// M = 16,777,216). The folds are 20-60 integer operations an element, so
// at 64 integer lanes an SM the FSM and bytes forms are bound by issue
// nearly as much as by bytes; the resolve scan takes ~30 (the flag bits,
// the transposes, a fold and an apply of ~7 each), about half its bytes'
// time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kFsmMaps = 0, kFsmStarts = 1, kInitLeaf = 2, kInitBytes = 3,
            kAnch = 4 };

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
                                K == kInitBytes;
  static constexpr bool sum = K == kInitLeaf || K == kInitBytes;
  // elements a thread: 32 FSM bytes and 16 anch leaves (fewer tiles, and
  // so fewer look-backs, for the light folds); 16 bytes for the bytes
  // form, 8 initial leaves with their npix
  static constexpr int items = K == kInitLeaf ? 8
                               : (K == kFsmMaps || K == kFsmStarts) ? 32
                                                                    : 16;
  static constexpr int esz = bytes ? 1 : 4;        // input bytes an element
  static constexpr int tile = kThreads * items;
  // staged 16-byte chunks of an input: the tile's, and two for the halo
  // and the shift of an unaligned input
  static constexpr int chunks = kThreads * items * esz / 16 + 2;
  static constexpr int inputs = sum ? 2 : 1;
  // the staging area, reused as 64 chunks a warp for the stores
  static constexpr int smem = inputs * chunks > kWarps * 64
                                  ? inputs * chunks : kWarps * 64;
};

struct V {
  uint32_t p;
  unsigned long long s;   // the npix sum (initial forms)
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

template <int K>
__device__ __forceinline__ V comb(const V& a, const V& b) {
  V r;
  if constexpr (K == kFsmMaps || K == kFsmStarts) r.p = fsm_comb(a.p, b.p);
  else if constexpr (K == kAnch) r.p = anch_comb(a.p, b.p);
  else r.p = initial_comb(a.p, b.p);
  r.s = Geo<K>::sum ? a.s + b.s : 0ull;
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_up(const V& v, int d) {
  V r{__shfl_up_sync(kFull, v.p, d), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_up_sync(kFull, v.s, d);
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_down(const V& v, int d) {
  V r{__shfl_down_sync(kFull, v.p, d), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_down_sync(kFull, v.s, d);
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_idx(const V& v, int src) {
  V r{__shfl_sync(kFull, v.p, src), 0ull};
  if constexpr (Geo<K>::sum) r.s = __shfl_sync(kFull, v.s, src);
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
// the 40-bit sum; the leaf form's sum in sums[2 * at + (flag == kInc)]
template <int K>
__device__ __forceinline__ void publish(const Args& a, long long at,
                                        unsigned flag, const V& v) {
  unsigned long long word;
  if constexpr (K == kInitBytes) {
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
  if constexpr (K == kInitBytes) {
    v.p = static_cast<uint32_t>(word >> 40) & 0x3FFFFFu;
    v.s = word & kSum40;
    return static_cast<unsigned>(word >> 62);
  } else {
    v.p = static_cast<uint32_t>(word);
    v.s = 0ull;
    return static_cast<unsigned>(word >> 32);
  }
}

// The look-back's view of an entry's status words: the state S, a word's
// flag and state (read), the combine (join) and the warp shuffles; the
// one-pass entries' (OnePass<K>) and the resolve scan's (Resolve, below)
template <int K>
struct OnePass {
  using S = V;
  static __device__ __forceinline__ unsigned read(const Args& a, long long at,
                                                  V& v) {
    const unsigned flag = unpack<K>(
        *reinterpret_cast<const volatile unsigned long long*>(a.status + at),
        v);
    if constexpr (K == kInitLeaf) {
      if (flag != 0u) {
        __threadfence();
        v.s = *reinterpret_cast<const volatile unsigned long long*>(
            a.sums + 2 * at + (flag == kInc));
      }
    }
    return flag;
  }
  static __device__ __forceinline__ V join(const V& x, const V& y) {
    return comb<K>(x, y);
  }
  static __device__ __forceinline__ V down(const V& x, int d) {
    return shfl_down<K>(x, d);
  }
  static __device__ __forceinline__ V from(const V& x, int src) {
    return shfl_idx<K>(x, src);
  }
};

// lanes 0..last hold the states of tiles hi, hi - 1, ..., hi - last: their
// fold, earliest first, on every lane
template <class L>
__device__ __forceinline__ typename L::S fold_back(typename L::S x,
                                                   int last) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename L::S y = L::down(x, d);
    if (lane + d <= last) x = L::join(y, x);
  }
  return L::from(x, 0);
}

// One warp: the exclusive prefix of tile j > 0 of the row whose tile 0
// has status word at0. Lane l reads tile hi - l; the window folds up to
// its first inclusive word, waits while a word before that is
// unpublished, and slides back 32 tiles while all its words are
// aggregates.
template <class L>
__device__ typename L::S look_back(const Args& a, long long at0,
                                   long long j) {
  using S = typename L::S;
  const int lane = threadIdx.x & 31;
  long long hi = j - 1;
  S acc{};
  bool have = false;
  while (true) {
    const long long jj = hi - lane;
    S v{};
    unsigned flag = kInc;   // before tile 0, which is inclusive: not reached
    if (jj >= 0) flag = L::read(a, at0 + jj, v);
    const unsigned stop = __ballot_sync(kFull, flag != kAgg);
    if (stop != 0u) {
      const int first = __ffs(stop) - 1;
      if (__shfl_sync(kFull, flag, first) != kInc) {
        __nanosleep(32);
        continue;
      }
      const S w = fold_back<L>(v, first);
      return have ? L::join(w, acc) : w;
    }
    const S w = fold_back<L>(v, 31);
    acc = have ? L::join(w, acc) : w;
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
  stage(sm, a.in0 + tl.row * nb, off, nb, G::chunks);
  if constexpr (G::inputs == 2)
    stage(sm + G::chunks, a.in1 + tl.row * nb, off, nb, G::chunks);
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
                    // lengths - 1 in their place), or the leaves
  uint32_t op[16];  // bytes form: each byte's op; leaf form: npix
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
      const V ex = look_back<OnePass<K>>(a, at0, j);
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
  __shared__ uint4 sm[Geo<K>::smem];
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
  const cudaError_t e = cudaMemsetAsync(scratch, 0, words * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  one_pass_kernel<K><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ resolve scan
//
// v2's reset-or-add scan, a kernel of its own (the header's design): the
// eight input rows go from global memory straight into registers, each
// input is transposed once, and shared memory holds only the warp totals.

// The geometry: 256 threads a block, two 16-position lanes a thread, two
// blocks an SM (up to 128 registers)
constexpr int kRThreads = 256;
constexpr int kRLanes = 2;
constexpr int kRBlocks = 2;
constexpr int kRWarps = kRThreads / 32;
constexpr int kRGroups = kRLanes * kRWarps;   // warps of lanes a tile
constexpr int kRTile = kRThreads * kRLanes * 16;
static_assert(kRThreads % 32 == 0 && kRGroups <= 32 && kRBlocks >= 1,
              "resolve scan geometry");

// v2's reset-or-add on four channels at once: where the later reset byte
// m2 is set its value, else the sum mod 256; that is the byte-wise sum of
// v1 & ~m2 and v2 (the low seven bits of each byte added, the top bits by
// an exclusive or: no carry between bytes)
__device__ __forceinline__ uint32_t resolve_comb(uint32_t v1, uint32_t v2,
                                                 uint32_t m2) {
  const uint32_t a = v1 & ~m2;
  return ((a & 0x7F7F7F7Fu) + (v2 & 0x7F7F7F7Fu)) ^
         ((a ^ v2) & 0x80808080u);
}

// each byte of x replaced by its top bit, replicated (prmt's sign mode)
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %1, 0xBA98;" : "=r"(r) : "r"(x));
  return r;
}

// bit 0 of each byte of x: set where the byte is not 0
__device__ __forceinline__ uint32_t nz_bits(uint32_t x) {
  return ((x | ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu)) >> 7) & 0x01010101u;
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

__device__ __forceinline__ uint32_t word_of(const uint4& x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

// The reset flags of a lane's 16 positions, 4 bits a position: fb[h]
// byte c bit i set where channel c's flag byte at position 8h + i is not
// 0. Channel c's 16-byte flag row f goes into byte c (the multiply
// gathers bit 0 of each byte of two words, bit 8b + 4w to bit 24 + 4w +
// b, carry-free).
__device__ __forceinline__ void flag_row(const uint4& f, int c,
                                         uint32_t* fb) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u = nz_bits(word_of(f, 2 * h)) |
                       nz_bits(word_of(f, 2 * h + 1)) << 4;
    fb[h] |= ((u * 0x01020408u) >> 24) << (8 * c);
  }
}

// position k's values (a byte a channel) from the four 16-byte value rows
__device__ __forceinline__ void value_rows(const uint4* x, uint32_t* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    transpose4(word_of(x[0], q), word_of(x[1], q), word_of(x[2], q),
               word_of(x[3], q), v + 4 * q);
}

// position k's reset bytes (0xFF where its channel resets): its bits
// moved to the top of each byte, replicated
__device__ __forceinline__ uint32_t reset_mask(const uint32_t* fb, int k) {
  return sign_bytes(fb[k >> 3] << (7 - (k & 7)));
}

// a state: four channels' values (a byte each) and reset bytes
struct RS {
  uint32_t v, m;
};

__device__ __forceinline__ RS rcomb(const RS& a, const RS& b) {
  return RS{resolve_comb(a.v, b.v, b.m), a.m | b.m};
}

__device__ __forceinline__ RS rshfl_up(const RS& x, int d) {
  return RS{__shfl_up_sync(kFull, x.v, d), __shfl_up_sync(kFull, x.m, d)};
}

// status word: flag << 62 | the four reset bits << 32 | the values
__device__ __forceinline__ void rpublish(unsigned long long* at,
                                         unsigned flag, const RS& x) {
  *reinterpret_cast<volatile unsigned long long*>(at) =
      (static_cast<unsigned long long>(flag) << 62) |
      (static_cast<unsigned long long>(mask_bits(x.m)) << 32) | x.v;
}

// The resolve scan's status words for look_back
struct Resolve {
  using S = RS;
  static __device__ __forceinline__ unsigned read(const Args& a, long long at,
                                                  RS& x) {
    const unsigned long long w =
        *reinterpret_cast<const volatile unsigned long long*>(a.status + at);
    x = RS{static_cast<uint32_t>(w),
           mask_bytes(static_cast<uint32_t>(w >> 32) & 0xFu)};
    return static_cast<unsigned>(w >> 62);
  }
  static __device__ __forceinline__ RS join(const RS& x, const RS& y) {
    return rcomb(x, y);
  }
  static __device__ __forceinline__ RS down(const RS& x, int d) {
    return RS{__shfl_down_sync(kFull, x.v, d),
              __shfl_down_sync(kFull, x.m, d)};
  }
  static __device__ __forceinline__ RS from(const RS& x, int src) {
    return RS{__shfl_sync(kFull, x.v, src), __shfl_sync(kFull, x.m, src)};
  }
};

// 16 bytes of global memory, not kept in L1
__device__ __forceinline__ uint4 ld_nc16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Bytes [e, e + 16) of a row of len bytes at any alignment, zero from len
// on (e a multiple of 16): the one or two 16-byte chunks of the row that
// hold them, a whole chunk by one load and the row's edge chunks byte by
// byte, joined by a funnel shift.
__device__ uint4 row16(const uint8_t* row, long long e, long long len) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u);
  uint32_t w[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long b0 = e - lead + 16 * h;
    uint32_t cw[4] = {0u, 0u, 0u, 0u};
    if (h == 0 || lead != 0) {
      if (b0 >= 0 && b0 + 16 <= len) {
        const uint4 c = ld_nc16(row + b0);
        cw[0] = c.x, cw[1] = c.y, cw[2] = c.z, cw[3] = c.w;
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (b0 + b >= 0 && b0 + b < len)
            cw[b >> 2] |= static_cast<uint32_t>(__ldg(row + b0 + b))
                          << (8 * (b & 3));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) w[4 * h + k] = cw[k];
  }
  const int q = lead >> 2;
  const uint32_t r = 8u * (lead & 3);
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = q == 0 ? w[k] : q == 1 ? w[k + 1]
                        : q == 2 ? w[k + 2] : w[k + 3];
    const uint32_t hi = q == 0 ? w[k + 1] : q == 1 ? w[k + 2]
                        : q == 2 ? w[k + 3] : w[k + 4];
    o[k] = __funnelshift_r(lo, hi, r);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Tile j's leaves where its rows do not start on 16 bytes or it is the
// ragged last tile: lane r's values v (a byte a channel) and reset flags
// fb from memory at any alignment, a row at a time
__device__ __forceinline__ void leaves_any(const Args& a, long long e,
                                           uint32_t* v, uint32_t* fb) {
  fb[0] = fb[1] = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    flag_row(row16(a.in0 + static_cast<long long>(c) * a.len, e, a.len), c,
             fb);
  uint4 x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    x[c] = row16(a.in1 + static_cast<long long>(c) * a.len, e, a.len);
  value_rows(x, v);
}

// Tile j's loads (a whole tile, rows on 16 bytes): lane r's 16-byte span
// of each of the eight input rows (rflag's four channels, then val's)
__device__ __forceinline__ void load_tile(const Args& a, long long j,
                                          uint4 (*raw)[8]) {
  const long long e0 = j * kRTile + 16LL * threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRLanes; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      raw[r][c] = ld_nc16((c < 4 ? a.in0 : a.in1) +
                          static_cast<long long>(c & 3) * a.len + e0 +
                          16LL * r * kRThreads);
}

// One tile a block, taken by ticket. Lane r of thread t holds positions
// e = 16 (t + r kRThreads) .. e + 15 of the tile, so that a warp's loads
// and stores of a row cover 512 contiguous bytes.
__global__ void __launch_bounds__(kRThreads, kRBlocks)
resolve_kernel(Args a) {
  __shared__ RS wt[kRGroups];
  __shared__ RS tile_pre;
  __shared__ long long tk_s;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const long long len = a.len;
  if (t == 0) tk_s = static_cast<long long>(atomicAdd(a.ticket, 1ull));
  __syncthreads();
  const long long j = tk_s;
  // a whole tile whose rows (and the output's) start on 16 bytes
  const bool whole =
      ((reinterpret_cast<uintptr_t>(a.in0) | reinterpret_cast<uintptr_t>(a.in1)
        | reinterpret_cast<uintptr_t>(a.out0) | static_cast<uintptr_t>(len))
       & 15u) == 0u && (j + 1) * kRTile <= len;

  // -- 1. loads and one transpose: position k's four values in v[r][k],
  // its four reset flags in fb[r] (4 bits a position)
  uint32_t v[kRLanes][16], fb[kRLanes][2];
  if (whole) {
    // every load of the tile issued before the first is used
    uint4 raw[kRLanes][8];
    load_tile(a, j, raw);
#pragma unroll
    for (int r = 0; r < kRLanes; ++r) {
      fb[r][0] = fb[r][1] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) flag_row(raw[r][c], c, fb[r]);
      value_rows(raw[r] + 4, v[r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRLanes; ++r)
      leaves_any(a, j * kRTile + 16LL * (t + r * kRThreads), v[r], fb[r]);
  }

  // -- 2. the lanes' folds; 3. block scan: warp shuffles, then (warp 0)
  // the warp totals' scan
  RS inc[kRLanes];
#pragma unroll
  for (int r = 0; r < kRLanes; ++r) {
    uint32_t x = v[r][0];
#pragma unroll
    for (int k = 1; k < 16; ++k)
      x = resolve_comb(x, v[r][k], reset_mask(fb[r], k));
    inc[r] = RS{x, nz_bits(fb[r][0] | fb[r][1]) * 0xFFu};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const RS y = rshfl_up(inc[r], d);
      if (lane >= d) inc[r] = rcomb(y, inc[r]);
    }
    if (lane == 31) wt[r * kRWarps + wid] = inc[r];
  }
  __syncthreads();

  // -- 4. warp 0: the tile's aggregate, published; the look-back
  const bool look = j > 0;
  if (wid == 0) {
    RS y = wt[lane < kRGroups ? lane : kRGroups - 1];
#pragma unroll
    for (int d = 1; d < kRGroups; d <<= 1) {
      const RS z = rshfl_up(y, d);
      if (lane >= d) y = rcomb(z, y);
    }
    if (lane < kRGroups) wt[lane] = y;
    const RS agg{__shfl_sync(kFull, y.v, kRGroups - 1),
                 __shfl_sync(kFull, y.m, kRGroups - 1)};
    if (!look) {
      if (lane == 0) rpublish(a.status + j, kInc, agg);
    } else {
      if (lane == 0) rpublish(a.status + j, kAgg, agg);
      const RS ex = look_back<Resolve>(a, 0, j);
      if (lane == 0) {
        rpublish(a.status + j, kInc, rcomb(ex, agg));
        tile_pre = ex;
      }
    }
  }
  __syncthreads();

  // -- 5. apply from the seed, a state that resets every channel before
  // the row: each inclusive state's values are the px; back to the four
  // channel rows by the same transpose; 6. stores
#pragma unroll
  for (int r = 0; r < kRLanes; ++r) {
    // the lane's prefix: the tile's, then its own in the tile
    const int g = r * kRWarps + wid;
    const RS up = rshfl_up(inc[r], 1);
    bool h = lane > 0 || g > 0;
    RS p = up;
    if (g > 0) p = lane > 0 ? rcomb(wt[g - 1], up) : wt[g - 1];
    if (look) {
      p = h ? rcomb(tile_pre, p) : tile_pre;
      h = true;
    }
    uint32_t acc = h ? resolve_comb(kSeedPx, p.v, p.m) : kSeedPx;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      acc = resolve_comb(acc, v[r][k], reset_mask(fb[r], k));
      v[r][k] = acc;
    }
    uint32_t o[4][4];   // o[c][q]: channel c's bytes 4q .. 4q + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t c4[4];
      transpose4(v[r][4 * q], v[r][4 * q + 1], v[r][4 * q + 2],
                 v[r][4 * q + 3], c4);
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c][q] = c4[c];
    }
    const long long e = j * kRTile + 16LL * (t + r * kRThreads);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 w4 = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
      uint8_t* dst = a.out0 + static_cast<long long>(c) * len + e;
      if (whole) {
        __stcs(reinterpret_cast<uint4*>(dst), w4);
      } else if (e + 16 <= len &&
                 (reinterpret_cast<uintptr_t>(dst) & 15u) == 0u) {
        *reinterpret_cast<uint4*>(dst) = w4;
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (e + k < len)
            dst[k] = static_cast<uint8_t>(o[c][k >> 2] >> (8 * (k & 3)));
      }
    }
  }
}

// scratch (zeroed here): the ticket and a status word a tile
int run_resolve(Args a, void* scratch, void* stream) {
  if (a.len <= 0) return 0;
  a.nt = (a.len + kRTile - 1) / kRTile;
  if (a.nt > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  a.ticket = static_cast<unsigned long long*>(scratch);
  a.status = a.ticket + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + a.nt) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_kernel<<<static_cast<unsigned>(a.nt), kRThreads, 0, st>>>(a);
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
  return run_resolve(make_args(rflag, val, out, nullptr, m), scratch, stream);
}
