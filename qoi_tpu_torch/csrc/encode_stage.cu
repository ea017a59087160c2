// Encode staging: kernel S of the PyTorch/CUDA port, in two forms that
// share one templated kernel.
//
// Bytes form, qoi_encode_stage. Replaces the Pallas kernel
// qoi_tpu/kernels/encode_stage.py::encode_stage_pallas (_kernel): encoder
// stages 1-4 in one pass, px4 (N, 4) uint8 -> staging (N, 6) uint8 with
// bytes at or past len zeroed, and lens (N, 1) int32.
//
// Words form, qoi_encode_stage_words. Replaces, on the encode main path,
// qoi_tpu/models/pipeline.py::encode_stage_chunks(form="words") with its
// tile carries: stages 1-4 whose two TPU-shaped scans are
// qoi_tpu/ops/scans.py:102 blocked_scan -- the cummax of run segmentation
// (run_segmentation :181 <- last_true_index :169 <- cummax :37) and
// table_hit_carry's overwrite scan (qoi_tpu/ops/table.py:216). px4 (N, 4)
// uint8, any N >= 1 -> lo, hi, lens (N,) int32 (u32 bit patterns: record
// bytes 0..3, bytes 4..5, the length) and the outgoing carry.
//
// Blocks are 1024 pixels, as the JAX kernel's default block. A thread
// block of 256 threads takes one of them as 32 rows of 32 pixels: warp w
// holds rows 4w .. 4w + 3, lane l pixel l of each row.
//
// The TPU kernel runs its grid in order and carries the previous pixel, the
// run phase and the 64-slot colour table from one block to the next in
// scratch memory (encode_stage.py:93-101, 205-222). Blocks on this card run
// in no order, so the carries are computed, in ONE launch, by decoupled
// look-back over 65 columns: the 64 table slots (the pixel its last writer
// left in it) and the last literal (non-eq) pixel (its index). A table
// write is a literal pixel and the last writer wins, so each column's carry
// is what the nearest earlier block that wrote it left there.
//   1. A block takes its index from an atomic ticket (in launch order, so
//      every block it waits for is running) and loads its pixels
//      once, four rows a thread in flight. For each row a ballot marks the
//      literals, and a bitmask a slot marks the lanes that wrote it (shared
//      atomicOr); the row's last writer of a slot marks the row in a
//      bitmask a slot, and a bitmask marks the rows that hold a literal.
//      "The last earlier writer of a slot in the block" is then the highest
//      set bit below the lane, else the highest row below and the highest
//      lane of that row: no scan is needed.
//   2. Groups of 3 lanes, one a column, publish the block's aggregate as a
//      status word (final or pass, a written bit, value) at once: final
//      when the block wrote the column, or in block 0 (its inclusive prefix
//      over the virtual block below), else "pass". Then each group looks
//      back over its predecessors 3 at a time: the nearest final word is
//      the carry; pass words are skipped and a word not yet published (0)
//      is waited for. A pass column then publishes its carry as final, so
//      only columns that nobody writes walk far. The slot columns carry
//      pixels, so no load depends on the look-back.
//   3. Each pixel, from shared memory, against the last literal before the
//      block (a virtual one where a run is in flight: run_pos = i - that
//      index). Padding (index >= n_valid) is forced to eq, and the
//      pending-run flush tests prev_run_pos % 62, both as in the TPU
//      kernel. The op tests run on the four channel differences at once
//      (byte-wise SIMD) and the staged record is one 64-bit word masked to
//      the length. The bytes form puts two pixels' 12 bytes in shared
//      memory as three words and the block's 6 KB leave as 16-byte stores;
//      the words form stores each pixel's lo, hi and length (4-byte
//      stores, lanes on neighbouring words).
// Before block 0 stands a virtual block whose words are final: in the
// bytes form every slot 0 (an unwritten slot reads as the zero pixel,
// which makes the `before == packed` hit test of encode_stage.py:149-154
// exact) and no literal; in the words form the incoming carry -- a slot
// is table_in where written_in is set and 0 elsewhere (table.py:205-209),
// with written_in as its written bit, and the last literal is the index
// -1 - run_in, so that a leading run continues the pending one and
// position 0 flushes it. The previous pixel of position 0 is the seed,
// or prev_in. The bytes form then cuts the run to 0 at every block start
// after the one holding last_pos, as the TPU kernel cuts its run carry
// (encode_stage.py:216); the words form does not. In the words form the
// last block writes the outgoing carry from its inclusive prefix: the
// table and its written bits (an RGBA (0, 0, 0, 0) literal writes slot 0
// with the value 0, so "written" rides in the status word and is never
// read off the value), the pending run mod 62 (0 when contains_last is
// given true) and the last valid pixel. Positions past N (the ragged last
// block) load nothing and store nothing.
// The C entries zero the ticket and the status words before each launch.
//
// Bound on the H100: memory traffic. Bytes form: 4 B/px read and 10 B/px
// written (about 117 MB, ~0.035 ms at a 4K frame of 2^23 pixels). Words
// form: 4 B/px read and 12 B/px written (132.7 MB, ~0.040 ms at 8,294,400
// pixels). The design reads the pixels once and adds 65 status words (8 B)
// a block: zeroed, written at most twice and read by the look-back (~1.5
// B/px in all, a tenth of the bound's bytes). What it has to hide is
// latency: each block waits for its ticket, its pixels and its look-back
// in turn, so small blocks (eight resident an SM at 32 registers) with
// four loads a thread in flight keep enough of them going. The rest of its
// time goes to issuing integer instructions, which the byte-wise tests
// and the one-word staging keep down.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;           // pixels per block
constexpr int kThreads = 256;          // threads per block
constexpr int kBlocksPerSm = 8;        // resident: 32 registers a thread
constexpr int kRows = kBlock / 32;     // rows of 32 pixels
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kSlots = 64;
constexpr int kCols = kSlots + 1;      // the slots, then the last literal
constexpr int kGroup = 3;              // lanes of a look-back group
constexpr int kGroupsPerWarp = 32 / kGroup;
constexpr int kRunCap = 62;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255) packed r|g|b|a
constexpr unsigned kPass = 1u, kFinal = 2u;

// the words form's carry in: a header of five values -- n_valid, the
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

// The carry of column `col` into block blk > 0, by one group of kGroup
// lanes starting at lane g0 (lane g0 + i reads block hi - i): the nearest
// final word; pass words are skipped, a word still 0 is waited for. Before
// block 0 stands `none`, the virtual block's final word.
__device__ unsigned long long look_back(const unsigned long long* status,
                                        int blk, int col,
                                        unsigned long long none, int g0) {
  const int i = (threadIdx.x & 31) - g0;
  const unsigned gmask = ((1u << kGroup) - 1u) << g0;
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
      hi -= kGroup;
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
  unsigned long long* scratch;     // the ticket, then 65 words a block
  int32_t* lens;                   // (n,)
  // bytes form
  int n_valid, last_pos;
  uint8_t* stag;                   // (n, 6)
  // words form
  int hdr[kHeader];                // the carry in's header (kIn*)
  unsigned from_dev;               // ... its fields read from carry_in
  const int32_t* carry_in;
  uint32_t* lo;                    // (n,)
  uint32_t* hi;                    // (n,)
  long long* carry_out;            // kOut*
  uint8_t* written_out;            // (64,)
};

// field k of the words form's carry-in header
__device__ __forceinline__ int header(const StageArgs& a, int k) {
  return (a.from_dev >> k) & 1u ? a.carry_in[k] : a.hdr[k];
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stage_kernel(StageArgs a) {
  __shared__ uint32_t spx[kBlock];
  __shared__ __align__(16) unsigned lmask[kRows][kSlots];  // its writers
  __shared__ unsigned wmask[kSlots];         // per slot: the rows that wrote it
  __shared__ unsigned lrow[kRows];           // per row: its literals
  __shared__ unsigned litmask;               // the rows that hold a literal
  __shared__ unsigned long long none[kCols]; // the virtual block's words
  __shared__ uint32_t inval[kSlots];         // the table entering the block
  __shared__ int lit_in;                     // the last literal before it
  __shared__ uint32_t prev0;                 // the pixel before the block
  __shared__ int nv_s, last_s;               // n_valid, last_pos
  __shared__ uint32_t seed_s;                // the pixel before pixel 0
  __shared__ __align__(16) uint32_t sst[kWords ? 4 : kBlock * 6 / 4];
  __shared__ int blk_s;
  unsigned long long* ticket = a.scratch;
  unsigned long long* status = a.scratch + 1;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned below_lane = (1u << lane) - 1u;
  const int n = a.n;

  if (t == 0) {
    blk_s = (int)atomicAdd(ticket, 1ull);
    litmask = 0u;
    if constexpr (kWords) {
      const int nv = min(max(header(a, kInValid), 0), n);
      nv_s = nv;
      last_s = header(a, kInLast) ? nv - 1 : -1;
      seed_s = (uint32_t)header(a, kInPrev);
    } else {
      nv_s = a.n_valid;
      last_s = a.last_pos;
      seed_s = kSeed;
    }
  }
  if (t < kCols) {
    unsigned long long w;
    if constexpr (kWords) {
      if (t < kSlots) {
        const bool wr = (a.from_dev >> kInTable) & 1u &&
                        a.carry_in[kInWritten + t] != 0;
        w = status_word(kFinal, wr, wr ? (uint32_t)a.carry_in[kInTable + t]
                                       : 0u);
      } else {
        w = status_word(kFinal, false, (uint32_t)(-1 - header(a, kInRun)));
      }
    } else {
      w = status_word(kFinal, false, t < kSlots ? 0u : 0xFFFFFFFFu);
    }
    none[t] = w;
  }
  if (t < kSlots) wmask[t] = 0u;
  for (int i = t; i < kRows * kSlots / 4; i += kThreads)
    reinterpret_cast<uint4*>(&lmask[0][0])[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int blk = blk_s;
  const int base = blk * kBlock;
  const int n_valid = nv_s, last_pos = last_s;

  // -- 1. the pixels, once; literals and slot writers of each row
  uint32_t p[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int gid = base + (wid * kRowsPerWarp + k) * 32 + lane;
    p[k] = gid < n ? a.px[gid] : 0u;
  }
  uint32_t before_row = 0u;
  if (lane == 0) {
    const int j = base + wid * kRowsPerWarp * 32 - 1;
    before_row = j < 0 ? seed_s : (j < n ? a.px[j] : 0u);
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
    const unsigned long long own = status_word(kFinal, true, agg);
    unsigned long long in = none[col];
    if (blk == 0) {
      if (lead) publish(mine, m ? own : in);
    } else {
      if (lead) publish(mine, m ? own : status_word(kPass, false, 0u));
      in = look_back(status, blk, col, none[col], g0);
      if (lead && !m) publish(mine, in);
    }
    if (lead) {
      if (col < kSlots) inval[col] = (uint32_t)in;
      else lit_in = (int)(uint32_t)in;
    }
    if constexpr (kWords) {
      if (lead && blk == (int)gridDim.x - 1) {
        // the outgoing carry: this block's inclusive prefix
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
  }
  __syncthreads();

  // -- 3. each pixel, from shared memory, against the last literal before
  // the block: the words form's carry (virtual before the tile, -1 -
  // run_in); the bytes form's run carry as a virtual literal, cut to 0
  // after a block whose valid region reaches past last_pos, as the TPU
  // kernel cuts it; otherwise the run since the last literal (or the
  // stream start), mod 62
  int lit_before;
  if constexpr (kWords) {
    lit_before = lit_in;
  } else {
    int run_in = 0;
    if (blk > 0) {
      const int lim = min(max(n_valid, base - kBlock), base);
      if (!(last_pos < lim)) {
        const int e = min(n_valid, base);
        const int l = lit_in;
        run_in = (l >= 0 ? e - 1 - l : e) % kRunCap;
      }
    }
    lit_before = base - 1 - run_in;
  }
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
    const bool hit = !eq && before == pk;

    // -- classification (qoi.h:438-474) on the byte differences
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
    const uint32_t own0 =
        hit       ? (uint32_t)key
        : is_diff ? (0x40u | (dd & 3u) << 4 | ((dd >> 8) & 3u) << 2 |
                     ((dd >> 16) & 3u))
        : is_luma ? (0x80u | gl)
        : is_rgb  ? 0xFEu
                  : 0xFFu;
    // then r, g, b, a; or the luma byte
    const uint32_t own1 =
        is_luma ? ((dl & 0xFu) << 4 | ((dl >> 16) & 0xFu)) : pk;
    const unsigned long long own = own0 | (unsigned long long)own1 << 8;
    const int own_len = (hit || is_diff) ? 1 : is_luma ? 2 : is_rgb ? 4 : 5;

    unsigned long long st;
    int len;
    if (eq) {
      st = 0xC0u | (unsigned)run_m;
      len = emits_run ? 1 : 0;
    } else if (flush) {
      st = (0xC0u | (unsigned)prev_m) | own << 8;
      len = own_len + 1;
    } else {
      st = own;
      len = own_len;
    }
    st &= (1ull << (8 * len)) - 1ull;
    const uint32_t lo = (uint32_t)st, hi = (uint32_t)(st >> 32);

    if constexpr (kWords) {
      if (gid < n) {
        a.lo[gid] = lo;
        a.hi[gid] = hi;
        a.lens[gid] = len;
      }
    } else {
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
  }
  if constexpr (!kWords) {
    __syncthreads();
    for (int q = t; q < kBlock * 6 / 16; q += kThreads)
      reinterpret_cast<int4*>(a.stag + (size_t)base * 6)[q] =
          reinterpret_cast<const int4*>(sst)[q];
  }
}

// Zero the ticket and the status words (scratch: 1 + 65 * blocks 64-bit
// words), then launch one block a 1024 pixels.
template <bool kWords>
int launch(StageArgs a, void* stream) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(
      a.scratch, 0, (1 + (size_t)kCols * blocks) * 8, st);
  if (e != cudaSuccess) return (int)e;
  stage_kernel<kWords><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// N a multiple of 1024; n_valid <= N.
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
  return launch<false>(a, stream);
}

// Any N >= 1. The carry in (kIn* above): the header n_valid .. last as
// arguments, the fields marked in from_dev and the table read from
// carry_in (133 int32 on the card; null when from_dev is 0); carry_out: 66
// 64-bit words, written_out: 64 bytes (kOut* above); lo, hi, lens: (N,)
// 32-bit.
extern "C" int qoi_encode_stage_words(
    const void* px4, int n, int n_valid, int count, int run_in, int prev_in,
    int last, unsigned from_dev, const void* carry_in, void* lo, void* hi,
    void* lens, void* carry_out, void* written_out, void* scratch,
    void* stream) {
  if (n <= 0 || (from_dev && !carry_in)) return (int)cudaErrorInvalidValue;
  StageArgs a{};
  a.px = (const uint32_t*)px4;
  a.n = n;
  a.scratch = (unsigned long long*)scratch;
  a.lens = (int32_t*)lens;
  const int hdr[kHeader] = {n_valid, count, run_in, prev_in, last};
  for (int k = 0; k < kHeader; ++k) a.hdr[k] = hdr[k];
  a.from_dev = from_dev;
  a.carry_in = (const int32_t*)carry_in;
  a.lo = (uint32_t*)lo;
  a.hi = (uint32_t*)hi;
  a.carry_out = (long long*)carry_out;
  a.written_out = (uint8_t*)written_out;
  return launch<true>(a, stream);
}
