// Encode staging: kernel S of the PyTorch/CUDA port, in three forms on two
// kernels.
//
// Bytes form, qoi_encode_stage (fused_kernel). Replaces the Pallas kernel
// qoi_tpu/kernels/encode_stage.py::encode_stage_pallas (_kernel): encoder
// stages 1-4 in one pass, px4 (N, 4) uint8 -> staging (N, 6) uint8 with
// bytes at or past len zeroed, and lens (N, 1) int32.
//
// Words form, qoi_encode_stage_words (tile_kernel). Replaces, on the encode
// main path, qoi_tpu/models/pipeline.py::encode_stage_chunks(form="words")
// with its tile carries: stages 1-4 whose two TPU-shaped scans are
// qoi_tpu/ops/scans.py:102 blocked_scan -- the cummax of run segmentation
// (run_segmentation :181 <- last_true_index :169 <- cummax :37) and
// table_hit_carry's overwrite scan (qoi_tpu/ops/table.py:216). px4 (N, 4)
// uint8, any N >= 1 -> lo, hi, lens (N,) int32 (u32 bit patterns: record
// bytes 0..3, bytes 4..5, the length) and the outgoing carry.
//
// Planes form, qoi_encode_stage_planes (tile_kernel). Replaces, on the pack
// encode (qoi_tpu/models/pipeline.py::_encode_pack_a), the same function's
// bytes form, encode_stage_chunks(form="bytes") (:209-229), with the carries
// of the words form: the same two blocked_scans, px4 (N, 4) uint8, any
// N >= 1 -> staging (6, N) uint8 plane-major, lens (N,) int32 and the
// outgoing carry. Its planes are JAX's: a record's bytes, 0 past its
// length, except that every eq position (padding and run members that
// emit nothing included) keeps its run byte OP_RUN | (run_pos - 1) % 62
// in plane 0.
//
// The TPU kernel runs its grid in order and carries the previous pixel, the
// run phase and the 64-slot colour table from one block to the next in
// scratch memory (encode_stage.py:93-101, 205-222). Blocks on this card run
// in no order, so both kernels compute those carries in ONE launch, by
// decoupled look-back over 65 columns: the 64 table slots (the pixel its
// last writer left in it) and the last literal (non-eq) pixel (its index).
// A table write is a literal pixel and the last writer wins, so each
// column's carry is what the nearest earlier tile that wrote it left there.
// A tile takes its index from an atomic ticket (in launch order, so every
// tile it waits for is running). Groups of lanes, one a column, publish the
// tile's aggregate as a status word (final or pass, a written bit, value)
// at once: final when the tile wrote the column, or in tile 0 (its inclusive
// prefix over the virtual tile below), else "pass". Then each group looks
// back over its predecessors a lane a tile: the nearest final word is the
// carry; pass words are skipped and a word not yet published (0) is waited
// for. A pass column then publishes its carry as final, so only columns
// that nobody writes walk far. The slot columns carry pixels, so no load
// depends on the look-back.
//
// fused_kernel: 1024-pixel blocks of 256 threads, 32 rows
// of 32 pixels, warp w rows 4w .. 4w + 3, lane l pixel l of each row; per
// row a ballot of its literals and per slot a bitmask of its writer lanes
// (shared atomicOr), a bitmask a slot of the rows that wrote it; each pixel
// then read back from shared memory. It cuts the run to 0 at every block
// start after the one holding last_pos, as the TPU kernel cuts its run
// carry (encode_stage.py:216), and puts two pixels' 12 bytes in shared
// memory as three words, the block's 6 KB leaving as 16-byte stores.
//
// tile_kernel (the words and planes forms): 4096-pixel tiles of 512
// threads, a tile being 1024 "lanes" of FOUR CONSECUTIVE pixels in 32
// warps of lanes; thread t runs lanes t and t + 512 (warps w and w + 16),
// so that each 16-byte load or store of a warp covers 512 contiguous bytes.
//   1. After the ticket both lanes' pixels come in as 16-byte loads (4-byte
//      loads where the view is not 16-byte aligned or the tile is ragged),
//      and lane 0 loads the pixel before its four; the others take it from
//      the lane below (a shuffle). A lane's literals, keys (each hash once)
//      and last literal are computed once. Shared memory gets the pixels
//      and each lane's four key bytes (0xFF for an eq pixel); a bitmask per
//      warp and slot marks the lanes that wrote it (one shared atomicOr a
//      literal); then each warp folds its masks into the value its last
//      writer left in each slot and a bitmask per slot of the warps that
//      wrote it, and a warp ballot gives its last literal.
//   2. The tile's aggregate of a slot is then its last writing warp's
//      value, of the literal column its last warp's last literal: published
//      at once, then the look-back (groups of 4 lanes).
//   3. Each lane's pixels, read back from shared memory (one 16-byte load),
//      against their predecessors: the last literal before the lane comes
//      from the warp's ballot (a shuffle of the lane below's last literal),
//      else the earlier warps' (a bitmask), else the tile's carry; the run
//      phase then walks the four pixels in registers, mod 62 by a compare,
//      a division only once a lane. The last earlier writer of a literal's
//      slot is found in the lane's own earlier pixels (a byte compare of its
//      key bytes); else in the warp (the slot's lane mask below the lane,
//      that lane's key bytes, a pixel load); else the last earlier warp's
//      value for the slot; else the tile's carry. The op tests run on the
//      four channel differences at once (byte-wise SIMD) and the staged
//      record is built as two words with nothing past its length. Stores:
//      the words form's lo, hi and lens as three 16-byte stores a lane;
//      the planes form's lens as one, and its four pixels' bytes of each
//      plane (a 4x4 byte transpose) as six 4-byte stores (byte stores
//      where N is not a multiple of 4); element by element past a ragged
//      end.
// Before tile 0 stands a virtual tile whose words are final: in the fused
// form every slot 0 (an unwritten slot reads as the zero pixel, which makes
// the `before == packed` hit test of encode_stage.py:149-154 exact) and no
// literal; in the words and planes forms the incoming carry -- a slot is
// table_in where written_in is set and 0 elsewhere (table.py:205-209), with
// written_in as its written bit, and the last literal is the index
// -1 - run_in, so that a leading run continues the pending one and
// position 0 flushes it. The previous pixel of position 0 is the seed, or
// prev_in. Padding (index >= n_valid) is forced to eq, and the pending-run
// flush tests prev_run_pos % 62, both as in the TPU kernel. In the words
// and planes forms the last tile writes the outgoing carry from its
// inclusive prefix: the table and its written bits (an RGBA (0, 0, 0, 0)
// literal writes slot 0 with the value 0, so "written" rides in the status
// word and is never read off the value), the pending run mod 62 (0 when
// contains_last is given true) and the last valid pixel. Positions past N
// (the ragged last tile) load nothing and store nothing.
// The C entries zero the ticket and the status words before each launch.
//
// Bound on the H100: memory traffic. Bytes and planes forms: 4 B/px read
// and 10 B/px written (about 117 MB, ~0.035 ms at a 4K frame of 2^23
// pixels). Words form: 4 B/px read and 12 B/px written (134 MB, ~0.040
// ms). Both kernels read the pixels once and add 65 status words (8 B) a
// tile: zeroed, written at most twice and read by the look-back (~1.5 B/px
// for the 1024-pixel blocks, a quarter of that for the 4096-pixel tiles).
// What is left to hide is integer issue and latency: each tile waits for
// its ticket, its pixels and its look-back in turn. The tile kernel cuts
// the issue a pixel (one hash, no per-pixel ballot or shuffle, a run phase
// in registers, the table replay mostly in registers and one warp step),
// keeps 32 bytes of loads a thread in flight and has every load and store
// instruction of a warp fill whole sectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kCols = kSlots + 1;      // the slots, then the last literal
constexpr int kRunCap = 62;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255) packed r|g|b|a
constexpr unsigned kPass = 1u, kFinal = 2u;

// fused_kernel: 1024-pixel blocks of 256 threads
constexpr int kBlock = 1024;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;        // resident: 32 registers a thread
constexpr int kRows = kBlock / 32;     // rows of 32 pixels
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kGroup = 3;              // lanes of a look-back group

// tile_kernel: 4096-pixel tiles of 512 threads; a tile is 1024 lanes of
// 4 consecutive pixels, thread t running lanes t and t + 512
constexpr int kPx = 4;                 // consecutive pixels a lane
constexpr int kTileThreads = 512;
constexpr int kRounds = 2;             // lanes a thread
constexpr int kLanes = kTileThreads * kRounds;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kLaneWarps = kLanes / 32;  // warps of lanes: 32
constexpr int kTile = kLanes * kPx;
constexpr int kTilesPerSm = 3;         // resident: up to 40 registers
constexpr int kTileGroup = 4;          // lanes of a look-back group

// the words and planes forms (tile_kernel), which take the tile carries in
// and write the carry out
enum Form { kWords, kPlanes };

// the words and planes forms' carry in: a header of five values -- n_valid, the
// carry's pixel count, run_in, prev_in packed, contains_last (0 no; 1
// yes; 2 not given: the last pixel is here, yet the run goes out in the
// carry, as the JAX function leaves it) -- each a launch argument or, where
// bit k of from_dev is set, word k of carry_in on the card; then, where bit
// kInTable is set, table_in[64] and written_in[64] in carry_in (else an
// empty table)
constexpr int kInValid = 0, kInCount = 1, kInRun = 2, kInPrev = 3,
              kInLast = 4, kHeader = 5, kInTable = 5,
              kInWritten = 5 + kSlots;
// its carry out: prev_px packed, run, table[64] (64-bit), written[64]
// (bytes)
constexpr int kOutPrev = 0, kOutRun = 1, kOutTable = 2;

// (r * 3 + g * 5 + b * 7 + a * 11) % 64, one byte-wise dot product
__device__ __forceinline__ int hash_px(uint32_t p) {
  return (int)(__dp4a(p, 0x0B070503u, 0u) & 63u);
}

__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// status word: tag (pass 1, final 2) in bits 32-33, the written bit in
// bit 34, the value in bits 0-31; 0 until published
__device__ __forceinline__ unsigned long long status_word(unsigned tag,
                                                          bool written,
                                                          uint32_t value) {
  return (unsigned long long)(tag | (written ? 4u : 0u)) << 32 | value;
}

__device__ __forceinline__ void publish(unsigned long long* w,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(w) = v;
}

// The carry of column `col` into tile blk > 0, by one group of G lanes
// starting at lane g0 (lane g0 + i reads tile hi - i): the nearest final
// word; pass words are skipped, a word still 0 is waited for. Before tile 0
// stands `none`, the virtual tile's final word.
template <int G>
__device__ unsigned long long look_back(const unsigned long long* status,
                                        int blk, int col,
                                        unsigned long long none, int g0) {
  const int i = (threadIdx.x & 31) - g0;
  const unsigned gmask = ((1u << G) - 1u) << g0;
  int hi = blk - 1;
  while (true) {
    const int j = hi - i;
    unsigned long long w = none;
    if (j >= 0)
      w = *reinterpret_cast<const volatile unsigned long long*>(
          status + (size_t)j * kCols + col);
    const unsigned tag = (unsigned)(w >> 32) & 3u;
    const unsigned stop = __ballot_sync(gmask, tag != kPass) & gmask;
    if (stop == 0) {
      hi -= G;
      continue;
    }
    const int first = __ffs(stop) - 1;
    if (__shfl_sync(gmask, (int)(tag != 0u), first))
      return __shfl_sync(gmask, w, first);
    __nanosleep(64);
  }
}

struct StageArgs {
  const uint32_t* px;              // (n,) packed pixels
  int n;
  unsigned long long* scratch;     // the ticket, then 65 words a tile
  int32_t* lens;                   // (n,)
  // fused form
  int n_valid, last_pos;
  uint8_t* stag;                   // (n, 6)
  // words and planes forms
  int hdr[kHeader];                // the carry in's header (kIn*)
  unsigned from_dev;               // ... its fields read from carry_in
  const int32_t* carry_in;
  long long* carry_out;            // kOut*
  uint8_t* written_out;            // (64,)
  uint32_t* lo;                    // words: (n,)
  uint32_t* hi;                    // words: (n,)
  uint8_t* planes;                 // planes: (6, n)
};

// field k of the carry-in header
__device__ __forceinline__ int header(const StageArgs& a, int k) {
  return (a.from_dev >> k) & 1u ? a.carry_in[k] : a.hdr[k];
}

// The record of one pixel, as the TPU kernel stages it (qoi.h:438-474):
// its bytes 0-3 in lo, 4-5 in hi, 0 past len, and len. pk and prev are
// the pixel and its predecessor, before the last earlier writer of pk's
// slot; run_m and prev_m are (run_pos - 1) % 62 of the pixel and of its
// predecessor. `keep_run` keeps an eq position's run byte at len 0 (the
// planes). The op's own bytes are built with nothing past its length,
// so no mask is needed.
__device__ __forceinline__ void record(uint32_t pk, uint32_t prev, int key,
                                       uint32_t before, bool eq, bool flush,
                                       bool emits_run, int run_m,
                                       int prev_m, bool keep_run,
                                       uint32_t& lo, uint32_t& hi,
                                       int& len) {
  if (eq) {  // a run member: a warp whose pixels all are skips the op tests
    lo = emits_run || keep_run ? 0xC0u | (unsigned)run_m : 0u;
    hi = 0u;
    len = emits_run ? 1 : 0;
    return;
  }
  const bool hit = before == pk;
  // d = pk - prev: vr, vg, vb are bytes 0-2 of d as signed chars, alpha
  // equal iff byte 3 is 0
  const uint32_t d = __vsub4(pk, prev);
  const bool alpha_same = (d >> 24) == 0u;
  const uint32_t dd = __vadd4(d, 0x00020202u);  // vr + 2, vg + 2, vb + 2
  const bool is_diff = alpha_same && (dd & 0x00FCFCFCu) == 0u;
  // vr - vg + 8 and vb - vg + 8 in bytes 0 and 2
  const uint32_t dl = __vadd4(__vsub4(d, __byte_perm(d, 0, 0x1111)),
                              0x00080008u);
  const uint32_t gl = ((d >> 8) + 32u) & 0xFFu;  // vg + 32
  const bool is_luma = alpha_same && !is_diff && gl < 64u &&
                       (dl & 0x00F000F0u) == 0u;
  const bool is_rgb = alpha_same && !is_diff && !is_luma;
  const bool small = hit || is_diff;
  const uint32_t own0 =
      hit       ? (uint32_t)key
      : is_diff ? (0x40u | (dd & 3u) << 4 | ((dd >> 8) & 3u) << 2 |
                   ((dd >> 16) & 3u))
      : is_luma ? (0x80u | gl)
      : is_rgb  ? 0xFEu
                : 0xFFu;
  // then r, g, b (a in hi for RGBA); or the luma byte; or nothing
  const uint32_t own1 =
      small ? 0u : is_luma ? ((dl & 0xFu) << 4 | ((dl >> 16) & 0xFu)) : pk;
  const uint32_t olo = own0 | own1 << 8;
  const uint32_t ohi = small || is_luma || is_rgb ? 0u : pk >> 24;
  const int own_len = small ? 1 : is_luma ? 2 : is_rgb ? 4 : 5;
  if (flush) {
    lo = (0xC0u | (unsigned)prev_m) | olo << 8;
    hi = ohi << 8 | olo >> 24;
    len = own_len + 1;
  } else {
    lo = olo;
    hi = ohi;
    len = own_len;
  }
}

// ------------------------------------------------------------ fused form

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_kernel(StageArgs a) {
  constexpr int kGroupsPerWarp = 32 / kGroup;
  __shared__ uint32_t spx[kBlock];
  __shared__ __align__(16) unsigned lmask[kRows][kSlots];  // its writers
  __shared__ unsigned wmask[kSlots];         // per slot: the rows that wrote it
  __shared__ unsigned lrow[kRows];           // per row: its literals
  __shared__ unsigned litmask;               // the rows that hold a literal
  __shared__ unsigned long long none[kCols]; // the virtual block's words
  __shared__ uint32_t inval[kSlots];         // the table entering the block
  __shared__ int lit_in;                     // the last literal before it
  __shared__ uint32_t prev0;                 // the pixel before the block
  // the block's staged bytes, (1024, 6)
  __shared__ __align__(16) uint32_t sst[kBlock * 6 / 4];
  __shared__ int blk_s;
  unsigned long long* ticket = a.scratch;
  unsigned long long* status = a.scratch + 1;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned below_lane = (1u << lane) - 1u;
  const int n_valid = a.n_valid, last_pos = a.last_pos;

  if (t == 0) {
    blk_s = (int)atomicAdd(ticket, 1ull);
    litmask = 0u;
  }
  if (t < kCols)
    none[t] = status_word(kFinal, false, t < kSlots ? 0u : 0xFFFFFFFFu);
  if (t < kSlots) wmask[t] = 0u;
  for (int i = t; i < kRows * kSlots / 4; i += kThreads)
    reinterpret_cast<uint4*>(&lmask[0][0])[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int blk = blk_s;
  const int base = blk * kBlock;

  // -- 1. the pixels, once; literals and slot writers of each row
  uint32_t p[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k)
    p[k] = a.px[base + (wid * kRowsPerWarp + k) * 32 + lane];
  uint32_t before_row = 0u;
  if (lane == 0) {
    const int j = base + wid * kRowsPerWarp * 32 - 1;
    before_row = j < 0 ? kSeed : a.px[j];
  }
  if (t == 0) prev0 = before_row;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = wid * kRowsPerWarp + k;
    const int i = r * 32 + lane;
    uint32_t prev = __shfl_up_sync(kFull, p[k], 1);
    if (lane == 0) prev = before_row;
    const bool eq = p[k] == prev || base + i >= n_valid;
    spx[i] = p[k];
    const unsigned lits = __ballot_sync(kFull, !eq);
    if (lane == 0) {
      lrow[r] = lits;
      if (lits) atomicOr(&litmask, 1u << r);
    }
    // the row's last writer of a slot marks the row
    const int key = hash_px(p[k]);
    if (!eq) atomicOr(&lmask[r][key], 1u << lane);
    __syncwarp();
    if (!eq && (lmask[r][key] >> lane) == 1u) atomicOr(&wmask[key], 1u << r);
    before_row = __shfl_sync(kFull, p[k], 31);
  }
  __syncthreads();

  // -- 2. the block's aggregates, published at once; then the look-back
  const int g = lane / kGroup, col = wid * kGroupsPerWarp + g;
  if (g < kGroupsPerWarp && col < kCols) {
    const int g0 = g * kGroup;
    const unsigned m = col < kSlots ? wmask[col] : litmask;
    uint32_t agg = 0u;
    if (m) {
      const int r = top_bit(m);
      agg = col < kSlots ? spx[r * 32 + top_bit(lmask[r][col])]
                         : (uint32_t)(base + r * 32 + top_bit(lrow[r]));
    }
    unsigned long long* mine = status + (size_t)blk * kCols + col;
    const bool lead = lane == g0;
    unsigned long long in = none[col];
    if (blk == 0) {
      if (lead) publish(mine, m ? status_word(kFinal, true, agg) : in);
    } else {
      if (lead)
        publish(mine, m ? status_word(kFinal, true, agg)
                        : status_word(kPass, false, 0u));
      in = look_back<kGroup>(status, blk, col, none[col], g0);
      if (lead && !m) publish(mine, in);
    }
    if (lead) {
      if (col < kSlots) inval[col] = (uint32_t)in;
      else lit_in = (int)(uint32_t)in;
    }
  }
  __syncthreads();

  // -- 3. each pixel, from shared memory, against the last literal before
  // the block: the run carry as a virtual literal, cut to 0 after a block
  // whose valid region reaches past last_pos, as the TPU kernel cuts it;
  // otherwise the run since the last literal (or the stream start), mod 62
  int run_in = 0;
  if (blk > 0) {
    const int lim = min(max(n_valid, base - kBlock), base);
    if (!(last_pos < lim)) {
      const int e = min(n_valid, base);
      const int l = lit_in;
      run_in = (l >= 0 ? e - 1 - l : e) % kRunCap;
    }
  }
  const int lit_before = base - 1 - run_in;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = wid * kRowsPerWarp + k;
    const int i = r * 32 + lane, gid = base + i;
    const uint32_t pk = spx[i];
    const uint32_t prev = i ? spx[i - 1] : prev0;
    const bool valid = gid < n_valid;
    const bool eq = pk == prev || !valid;
    const int key = hash_px(pk);

    // -- run segmentation (qoi.h:415-428), as scans.run_segmentation
    const unsigned lits = lrow[r];
    const unsigned rl = litmask & ((1u << r) - 1u);  // earlier rows
    const int rlit = rl ? base + top_bit(rl) * 32 + top_bit(lrow[top_bit(rl)])
                        : lit_before;
    const unsigned le = lits & ((2u << lane) - 1u), lt = lits & below_lane;
    const int ln = le ? gid - lane + top_bit(le) : rlit;  // last literal <= i
    const int lp = lt ? gid - lane + top_bit(lt) : rlit;  // last literal < i
    const int run_pos = gid - ln;
    const bool prev_eq = lp != gid - 1;
    const int prev_run_pos = gid - 1 - lp;
    // run bytes: (run_pos - 1) % 62 for an eq pixel (run_pos >= 1), a
    // multiple of 62 iff that is 61; the same for the flushed run
    const int run_m = (run_pos - 1) % kRunCap;
    const int prev_m = (prev_run_pos - 1) % kRunCap;
    const bool emits_run =
        eq && valid && (run_m == kRunCap - 1 || gid == last_pos);
    const bool flush = !eq && prev_eq && prev_m != kRunCap - 1;

    // -- colour-table replay (qoi.h:430-436): the last earlier writer of
    // the slot in this row, else in the earlier rows, else before the block
    uint32_t before;
    const unsigned lw = lmask[r][key] & below_lane;
    if (lw) {
      before = spx[r * 32 + top_bit(lw)];
    } else {
      const unsigned rw = wmask[key] & ((1u << r) - 1u);
      if (rw) {
        const int rr = top_bit(rw);
        before = spx[rr * 32 + top_bit(lmask[rr][key])];
      } else {
        before = inval[key];
      }
    }
    uint32_t lo, hi;
    int len;
    record(pk, prev, key, before, eq, flush, emits_run, run_m, prev_m,
           false, lo, hi, len);
    a.lens[gid] = len;
    // pixels 2m and 2m + 1 fill words 3m .. 3m + 2 of the block's staging
    const uint32_t lo_next = __shfl_down_sync(kFull, lo, 1);
    const int w0 = 3 * (i >> 1);
    if (!(lane & 1)) {
      sst[w0] = lo;
      sst[w0 + 1] = hi | lo_next << 16;
    } else {
      sst[w0 + 2] = lo >> 16 | hi << 16;
    }
  }
  __syncthreads();
  for (int q = t; q < kBlock * 6 / 16; q += kThreads)
    reinterpret_cast<int4*>(a.stag + (size_t)base * 6)[q] =
        reinterpret_cast<const int4*>(sst)[q];
}

// ------------------------------------------------- words and planes forms

// 0x80 in each byte of x that is 0, else 0
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// the index (0-3) of the last of a lane's four key bytes kw equal to key
// (one is)
__device__ __forceinline__ int last_key_byte(unsigned kw, int key) {
  return top_bit(zero_bytes(kw ^ (unsigned)key * 0x01010101u)) >> 3;
}

template <Form F>
__global__ void __launch_bounds__(kTileThreads, kTilesPerSm)
tile_kernel(StageArgs a) {
  constexpr int kGroupsPerWarp = 32 / kTileGroup;
  __shared__ __align__(16) uint32_t spx[kTile];         // the tile's pixels
  __shared__ unsigned skey[kLanes];   // a lane's key bytes, 0xFF where eq
  __shared__ __align__(16) unsigned wm[kLaneWarps][kSlots];  // writer lanes
  __shared__ uint32_t wagg[kLaneWarps][kSlots];  // a warp's last write
  __shared__ unsigned tmask[kSlots];         // per slot: the warps that wrote
  __shared__ int wlast[kLaneWarps];          // a warp's last literal
  __shared__ unsigned litmask;               // the warps that hold a literal
  __shared__ unsigned long long none[kCols]; // the virtual tile's words
  __shared__ uint32_t inval[kSlots];         // the table entering the tile
  __shared__ int lit_in;                     // the last literal before it
  __shared__ uint32_t prev0;                 // the pixel before the tile
  __shared__ int nv_s, last_s;               // n_valid, last_pos
  __shared__ uint32_t seed_s;                // the pixel before pixel 0
  __shared__ int blk_s;
  unsigned long long* ticket = a.scratch;
  unsigned long long* status = a.scratch + 1;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned below_lane = (1u << lane) - 1u;
  const int n = a.n;

  if (t == 0) {
    blk_s = (int)atomicAdd(ticket, 1ull);
    litmask = 0u;
    const int nv = min(max(header(a, kInValid), 0), n);
    nv_s = nv;
    last_s = header(a, kInLast) ? nv - 1 : -1;
    seed_s = (uint32_t)header(a, kInPrev);
  }
  if (t < kCols) {
    unsigned long long w;
    if (t < kSlots) {
      const bool wr = (a.from_dev >> kInTable) & 1u &&
                      a.carry_in[kInWritten + t] != 0;
      w = status_word(kFinal, wr, wr ? (uint32_t)a.carry_in[kInTable + t]
                                     : 0u);
      tmask[t] = 0u;
    } else {
      w = status_word(kFinal, false, (uint32_t)(-1 - header(a, kInRun)));
    }
    none[t] = w;
  }
  __syncthreads();
  const int blk = blk_s;
  const int base = blk * kTile;
  const int n_valid = nv_s, last_pos = last_s;
  const bool aligned = ((uintptr_t)a.px & 15u) == 0u;

  // -- 1. lanes t and t + 512 of the tile (warps wid and wid + 16): four
  // consecutive pixels each, and the pixel before them; all loads first
  uint32_t p[kRounds][kPx], before[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int gid0 = base + (t + r * kTileThreads) * kPx;
    if (aligned && gid0 + kPx <= n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.px + gid0));
      p[r][0] = q.x, p[r][1] = q.y, p[r][2] = q.z, p[r][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        p[r][k] = gid0 + k < n ? __ldg(a.px + gid0 + k) : 0u;
    }
    before[r] = 0u;
    if (lane == 0)
      before[r] = gid0 == 0 ? seed_s
                : gid0 <= n ? __ldg(a.px + gid0 - 1) : 0u;
  }
  // the warps' writer masks, zeroed while the loads are in flight
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    reinterpret_cast<uint2*>(&wm[wid + r * kTileWarps][0])[lane] =
        make_uint2(0u, 0u);
  if (t == 0) prev0 = before[0];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int v = t + r * kTileThreads, vw = wid + r * kTileWarps;
    const int gid0 = base + v * kPx;
    const uint32_t up = __shfl_up_sync(kFull, p[r][kPx - 1], 1);
    if (lane) before[r] = up;
    // literals (a bit each), keys (bytes, 0xFF where eq), last literal
    unsigned lits = 0u, kw = 0u;
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const uint32_t prev = k ? p[r][k - 1] : before[r];
      const bool eq = p[r][k] == prev || gid0 + k >= n_valid;
      const int key = hash_px(p[r][k]);
      if (!eq) lits |= 1u << k;
      kw |= (eq ? 0xFFu : (unsigned)key) << (8 * k);
      if (!eq) atomicOr(&wm[vw][key], 1u << lane);
    }
    reinterpret_cast<uint4*>(spx)[v] =
        make_uint4(p[r][0], p[r][1], p[r][2], p[r][3]);
    skey[v] = kw;
    const unsigned wl = __ballot_sync(kFull, lits != 0u);
    if (wl && lane == top_bit(wl)) {
      wlast[vw] = gid0 + top_bit(lits);
      atomicOr(&litmask, 1u << vw);
    }
  }
  __syncwarp();
  // each warp's last write of each slot, and the warps that wrote it
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int vw = wid + r * kTileWarps;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      const unsigned m = wm[vw][s];
      if (m) {
        const int l = vw * 32 + top_bit(m);
        wagg[vw][s] = spx[l * kPx + last_key_byte(skey[l], s)];
        atomicOr(&tmask[s], 1u << vw);
      }
    }
  }
  __syncthreads();

  // -- 2. the tile's aggregates, published at once; then the look-back
  const int g = lane / kTileGroup, col = wid * kGroupsPerWarp + g;
  if (col < kCols) {
    const int g0 = g * kTileGroup;
    const unsigned m = col < kSlots ? tmask[col] : litmask;
    uint32_t agg = 0u;
    if (m)
      agg = col < kSlots ? wagg[top_bit(m)][col]
                         : (uint32_t)wlast[top_bit(m)];
    unsigned long long* mine = status + (size_t)blk * kCols + col;
    const bool lead = lane == g0;
    const unsigned long long own = status_word(kFinal, true, agg);
    unsigned long long in = none[col];
    if (blk == 0) {
      if (lead) publish(mine, m ? own : in);
    } else {
      if (lead) publish(mine, m ? own : status_word(kPass, false, 0u));
      in = look_back<kTileGroup>(status, blk, col, none[col], g0);
      if (lead && !m) publish(mine, in);
    }
    if (lead) {
      if (col < kSlots) inval[col] = (uint32_t)in;
      else lit_in = (int)(uint32_t)in;
    }
    if (lead && blk == (int)gridDim.x - 1) {
      // the outgoing carry: this tile's inclusive prefix
      const unsigned long long inc = m ? own : in;
      if (col < kSlots) {
        a.carry_out[kOutTable + col] = (uint32_t)inc;
        a.written_out[col] = (uint8_t)((inc >> 34) & 1ull);
      } else {
        // the pixel count of the carry (n_valid, or the JAX package's
        // count when n_valid is not given), and the run since the last
        // literal mod 62, as Python's % takes a negative trail
        const int cn = min(max(header(a, kInCount), 0), n);
        const int trail = cn - 1 - (int)(uint32_t)inc;
        a.carry_out[kOutRun] =
            header(a, kInLast) == 1
                ? 0 : ((trail % kRunCap) + kRunCap) % kRunCap;
        a.carry_out[kOutPrev] = cn > 0 ? a.px[cn - 1] : seed_s;
      }
    }
  }
  __syncthreads();

  // -- 3. each lane's pixels, from shared memory, against their
  // predecessors
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int v = t + r * kTileThreads, vw = wid + r * kTileWarps;
    const int gid0 = base + v * kPx;
    const uint4 q4 = reinterpret_cast<const uint4*>(spx)[v];
    const uint32_t pk4[kPx] = {q4.x, q4.y, q4.z, q4.w};
    const unsigned kw = skey[v];
    // the literal bits: the top bits of the key bytes that are not 0xFF,
    // gathered into bits 28-31 by one multiply
    const unsigned lits = ~(zero_bytes(~kw) * 0x00204081u >> 28) & 15u;
    uint32_t prev = __shfl_up_sync(kFull, pk4[kPx - 1], 1);
    if (lane == 0) prev = v ? spx[v * kPx - 1] : prev0;
    // the last literal before the lane: the lane below's, else an earlier
    // warp's, else the carry (the virtual literal -1 - run_in before the
    // stream)
    const unsigned wl = __ballot_sync(kFull, lits != 0u);
    const unsigned lb = wl & below_lane;
    const int lane_lit = __shfl_sync(kFull, gid0 + (lits ? top_bit(lits) : 0),
                                     lb ? top_bit(lb) : 0);
    int lp0 = lit_in;
    if (lb) {
      lp0 = lane_lit;
    } else {
      const unsigned rl = litmask & ((1u << vw) - 1u);
      if (rl) lp0 = wlast[top_bit(rl)];
    }
    // q: the run position of the pixel before, mod 62 (0 at a literal);
    // prev_lit: that pixel is a literal (or the virtual one)
    int q = (gid0 - 1 - lp0) % kRunCap;
    bool prev_lit = lp0 == gid0 - 1;
    uint32_t lo4[kPx], hi4[kPx];
    int len4[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const int gid = gid0 + k;
      const uint32_t pk = pk4[k];
      const bool lit = lits >> k & 1u;
      const int key = (int)(kw >> (8 * k)) & 63;
      // run segmentation (qoi.h:415-428): run_pos % 62 walks on by one, a
      // literal restarts it; (run_pos - 1) % 62 is 61 where it is 0
      const int qn = lit ? 0 : (q == kRunCap - 1 ? 0 : q + 1);
      const int run_m = qn ? qn - 1 : kRunCap - 1;
      const int prev_m = q ? q - 1 : kRunCap - 1;
      const bool emits_run =
          !lit && gid < n_valid && (qn == 0 || gid == last_pos);
      const bool flush = lit && !prev_lit && q != 0;
      q = qn;
      prev_lit = lit;

      // colour-table replay (qoi.h:430-436): the last earlier writer of
      // the slot among the lane's pixels, else among the warp's lanes,
      // else in an earlier warp, else before the tile
      uint32_t bef = 0u;
      if (lit) {
        const unsigned own = zero_bytes(kw ^ (unsigned)key * 0x01010101u) &
                             ((1u << (8 * k)) - 1u);
        if (own) {
          bef = spx[v * kPx + (top_bit(own) >> 3)];
        } else {
          const unsigned lw = wm[vw][key] & below_lane;
          if (lw) {
            const int l = vw * 32 + top_bit(lw);
            bef = spx[l * kPx + last_key_byte(skey[l], key)];
          } else {
            const unsigned rw = tmask[key] & ((1u << vw) - 1u);
            bef = rw ? wagg[top_bit(rw)][key] : inval[key];
          }
        }
      }
      record(pk, prev, key, bef, !lit, flush, emits_run, run_m, prev_m,
             F == kPlanes, lo4[k], hi4[k], len4[k]);
      prev = pk;
    }
    // stores: 16 bytes of each field a lane (a warp's 512 bytes whole),
    // the planes 4 bytes of each (where N is a multiple of 4, every plane
    // row 4-byte aligned); element by element past a ragged end
    const bool whole = gid0 + kPx <= n;
    if (whole) {
      *reinterpret_cast<int4*>(a.lens + gid0) =
          make_int4(len4[0], len4[1], len4[2], len4[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (gid0 + k < n) a.lens[gid0 + k] = len4[k];
    }
    if constexpr (F == kWords) {
      if (whole) {
        *reinterpret_cast<uint4*>(a.lo + gid0) =
            make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
        *reinterpret_cast<uint4*>(a.hi + gid0) =
            make_uint4(hi4[0], hi4[1], hi4[2], hi4[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kPx; ++k)
          if (gid0 + k < n) {
            a.lo[gid0 + k] = lo4[k];
            a.hi[gid0 + k] = hi4[k];
          }
      }
    } else {
      // plane b of the four pixels: byte b of their records, a 4x4 byte
      // transpose of lo4 (planes 0-3) and of hi4's low half (planes 4-5)
      uint32_t pl[6];
      const uint32_t a01 = __byte_perm(lo4[0], lo4[1], 0x5140),
                     a23 = __byte_perm(lo4[2], lo4[3], 0x5140),
                     b01 = __byte_perm(lo4[0], lo4[1], 0x7362),
                     b23 = __byte_perm(lo4[2], lo4[3], 0x7362),
                     h01 = __byte_perm(hi4[0], hi4[1], 0x5140),
                     h23 = __byte_perm(hi4[2], hi4[3], 0x5140);
      pl[0] = __byte_perm(a01, a23, 0x5410);
      pl[1] = __byte_perm(a01, a23, 0x7632);
      pl[2] = __byte_perm(b01, b23, 0x5410);
      pl[3] = __byte_perm(b01, b23, 0x7632);
      pl[4] = __byte_perm(h01, h23, 0x5410);
      pl[5] = __byte_perm(h01, h23, 0x7632);
      if (whole && (n & 3) == 0) {
#pragma unroll
        for (int b = 0; b < 6; ++b)
          *reinterpret_cast<uint32_t*>(a.planes + (size_t)b * n + gid0) =
              pl[b];
      } else {
#pragma unroll
        for (int b = 0; b < 6; ++b)
#pragma unroll
          for (int k = 0; k < kPx; ++k)
            if (gid0 + k < n)
              a.planes[(size_t)b * n + gid0 + k] =
                  (uint8_t)(pl[b] >> (8 * k));
      }
    }
  }
}

// Zero the ticket and the status words (scratch: 1 + 65 * tiles 64-bit
// words), then launch one block a tile.
int zero_scratch(const StageArgs& a, int tiles, cudaStream_t st) {
  return (int)cudaMemsetAsync(a.scratch, 0, (1 + (size_t)kCols * tiles) * 8,
                              st);
}

template <Form F>
int launch_tiles(StageArgs a, void* stream) {
  const int tiles = (a.n + kTile - 1) / kTile;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = zero_scratch(a, tiles, st);
  if (e) return e;
  tile_kernel<F><<<tiles, kTileThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The words and planes forms' arguments: any N >= 1; the carry in (kIn*
// above): the header n_valid .. last as arguments, the fields marked in
// from_dev and the table read from carry_in (133 int32 on the card; null
// when from_dev is 0); carry_out: 66 64-bit words, written_out: 64 bytes
// (kOut* above); lens: (N,) int32.
StageArgs carry_args(const void* px4, int n, int n_valid, int count,
                     int run_in, int prev_in, int last, unsigned from_dev,
                     const void* carry_in, void* lens, void* carry_out,
                     void* written_out, void* scratch) {
  StageArgs a{};
  a.px = (const uint32_t*)px4;
  a.n = n;
  a.scratch = (unsigned long long*)scratch;
  a.lens = (int32_t*)lens;
  const int hdr[kHeader] = {n_valid, count, run_in, prev_in, last};
  for (int k = 0; k < kHeader; ++k) a.hdr[k] = hdr[k];
  a.from_dev = from_dev;
  a.carry_in = (const int32_t*)carry_in;
  a.carry_out = (long long*)carry_out;
  a.written_out = (uint8_t*)written_out;
  return a;
}

}  // namespace

// N a multiple of 1024; n_valid <= N. scratch: 1 + 65 * N / 1024 words.
extern "C" int qoi_encode_stage(const void* px4, void* stag, void* lens,
                                void* scratch, int n, int n_valid,
                                int last_pos, void* stream) {
  if (n <= 0) return 0;
  if (n % kBlock) return (int)cudaErrorInvalidValue;
  StageArgs a{};
  a.px = (const uint32_t*)px4;
  a.n = n;
  a.scratch = (unsigned long long*)scratch;
  a.lens = (int32_t*)lens;
  a.n_valid = n_valid;
  a.last_pos = last_pos;
  a.stag = (uint8_t*)stag;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = zero_scratch(a, n / kBlock, st);
  if (e) return e;
  fused_kernel<<<n / kBlock, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// lo, hi: (N,) 32-bit. scratch: 1 + 65 * ceil(N / 4096) words.
extern "C" int qoi_encode_stage_words(
    const void* px4, int n, int n_valid, int count, int run_in, int prev_in,
    int last, unsigned from_dev, const void* carry_in, void* lo, void* hi,
    void* lens, void* carry_out, void* written_out, void* scratch,
    void* stream) {
  if (n <= 0 || (from_dev && !carry_in)) return (int)cudaErrorInvalidValue;
  StageArgs a = carry_args(px4, n, n_valid, count, run_in, prev_in, last,
                           from_dev, carry_in, lens, carry_out, written_out,
                           scratch);
  a.lo = (uint32_t*)lo;
  a.hi = (uint32_t*)hi;
  return launch_tiles<kWords>(a, stream);
}

// planes: (6, N) uint8, plane-major. scratch as the words form's.
extern "C" int qoi_encode_stage_planes(
    const void* px4, int n, int n_valid, int count, int run_in, int prev_in,
    int last, unsigned from_dev, const void* carry_in, void* planes,
    void* lens, void* carry_out, void* written_out, void* scratch,
    void* stream) {
  if (n <= 0 || (from_dev && !carry_in)) return (int)cudaErrorInvalidValue;
  StageArgs a = carry_args(px4, n, n_valid, count, run_in, prev_in, last,
                           from_dev, carry_in, lens, carry_out, written_out,
                           scratch);
  a.planes = (uint8_t*)planes;
  return launch_tiles<kPlanes>(a, stream);
}
