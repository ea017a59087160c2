// Fused encode staging: kernel S of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/encode_stage.py::
// encode_stage_pallas (_kernel): encoder stages 1-4 in one pass, px4 (N, 4)
// uint8 -> staging (N, 6) uint8 with bytes at or past len zeroed, and lens
// (N, 1) int32. Blocks are 1024 pixels, as the JAX kernel's default block.
// A thread block of 256 threads takes one of them as 32 rows of 32 pixels:
// warp w holds rows 4w .. 4w + 3, lane l pixel l of each row.
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
//      status word (final or pass, value) at once: final when the block
//      wrote the column, or in block 0 (an unwritten slot reads as the zero
//      pixel, which makes the `before == packed` hit test of
//      encode_stage.py:149-154 exact), else "pass". Then each group looks
//      back over its predecessors 3 at a time: the nearest final word is
//      the carry; pass words are skipped and a word not yet published (0)
//      is waited for. A pass column then publishes its carry as final, so
//      only columns that nobody writes walk far. The slot columns carry
//      pixels, so no load depends on the look-back.
//   3. Each pixel, from shared memory: the run phase entering the block
//      follows from the last literal before it, and is cut to 0 at every
//      block start after the one holding last_pos, as the TPU kernel cuts
//      its run carry (encode_stage.py:216). Padding (index >= n_valid) is
//      forced to eq, and the pending-run flush tests prev_run_pos % 62,
//      both as in the TPU kernel. The op tests run on the four channel
//      differences at once (byte-wise SIMD), the staged bytes are one
//      64-bit word masked to the length, two pixels' 12 bytes go to shared
//      memory as three words, and the block's 6 KB leave as 16-byte stores.
// The wrapper zeroes the ticket and the status words for every launch.
//
// Bound on the H100: memory traffic, 4 B/px read and 10 B/px written (about
// 117 MB, ~0.035 ms at a 4K frame of 2^23 pixels). This design reads the
// pixels once and adds 65 status words (8 B) a block: zeroed by the
// wrapper, written at most twice and read by the look-back (~1.5 B/px in
// all, a tenth of the bound's bytes). What it has to hide is
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
constexpr int kRows = kBlock / 32;     // rows of 32 pixels
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kSlots = 64;
constexpr int kCols = kSlots + 1;      // the slots, then the last literal
constexpr int kGroup = 3;              // lanes of a look-back group
constexpr int kGroupsPerWarp = 32 / kGroup;
constexpr int kRunCap = 62;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255) packed r|g|b|a

// (r * 3 + g * 5 + b * 7 + a * 11) % 64, one byte-wise dot product
__device__ __forceinline__ int hash_px(uint32_t p) {
  return (int)(__dp4a(p, 0x0B070503u, 0u) & 63u);
}

__device__ __forceinline__ int top_bit(unsigned m) { return 31 - __clz(m); }

// status word: (final ? 2 : 1) << 32 | value; 0 until published
__device__ __forceinline__ void publish(unsigned long long* w, bool is_final,
                                        uint32_t value) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      (unsigned long long)(is_final ? 2u : 1u) << 32 | value;
}

// The carry of column `col` into block blk > 0, by one group of kGroup
// lanes starting at lane g0 (lane g0 + i reads block hi - i): the value of
// the nearest final word; pass words are skipped, a word still 0 is waited
// for. Before block 0 every column is final with `none`.
__device__ uint32_t look_back(const unsigned long long* status, int blk,
                              int col, uint32_t none, int g0) {
  const int i = (threadIdx.x & 31) - g0;
  const unsigned gmask = ((1u << kGroup) - 1u) << g0;
  int hi = blk - 1;
  while (true) {
    const int j = hi - i;
    bool ready = true, is_final = true;
    uint32_t value = none;
    if (j >= 0) {
      const unsigned long long w = *reinterpret_cast<const volatile
          unsigned long long*>(status + (size_t)j * kCols + col);
      const unsigned tag = (unsigned)(w >> 32);
      ready = tag != 0u;
      is_final = tag == 2u;
      value = (uint32_t)w;
    }
    const unsigned stop = __ballot_sync(gmask, !ready || is_final) & gmask;
    if (stop == 0) {
      hi -= kGroup;
      continue;
    }
    const int first = __ffs(stop) - 1;
    if (__shfl_sync(gmask, (int)ready, first))
      return __shfl_sync(gmask, value, first);
    __nanosleep(64);
  }
}

__global__ void __launch_bounds__(kThreads)
encode_stage_kernel(const uint32_t* __restrict__ px,
                    uint8_t* __restrict__ stag, int32_t* __restrict__ lens,
                    unsigned long long* __restrict__ scratch, int n_valid,
                    int last_pos) {
  __shared__ uint32_t spx[kBlock];
  __shared__ __align__(16) unsigned lmask[kRows][kSlots];  // its writers
  __shared__ unsigned wmask[kSlots];         // per slot: the rows that wrote it
  __shared__ unsigned lrow[kRows];           // per row: its literals
  __shared__ unsigned litmask;               // the rows that hold a literal
  __shared__ uint32_t inval[kSlots];         // the table entering the block
  __shared__ int lit_in;                     // the last literal before it
  __shared__ uint32_t prev0;                 // the pixel before the block
  __shared__ __align__(16) uint32_t sst[kBlock * 6 / 4];
  __shared__ int blk_s;
  unsigned long long* ticket = scratch;
  unsigned long long* status = scratch + 1;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned below_lane = (1u << lane) - 1u;

  if (t == 0) {
    blk_s = (int)atomicAdd(ticket, 1ull);
    litmask = 0u;
  }
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
    p[k] = px[base + (wid * kRowsPerWarp + k) * 32 + lane];
  uint32_t before_row = 0u;
  if (lane == 0)
    before_row = wid ? px[base + wid * kRowsPerWarp * 32 - 1]
                     : (base ? px[base - 1] : kSeed);
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
    const uint32_t none = col < kSlots ? 0u : 0xFFFFFFFFu;
    uint32_t agg = none;
    if (m) {
      const int r = top_bit(m);
      agg = col < kSlots ? spx[r * 32 + top_bit(lmask[r][col])]
                         : (uint32_t)(base + r * 32 + top_bit(lrow[r]));
    }
    unsigned long long* mine = status + (size_t)blk * kCols + col;
    const bool lead = lane == g0;
    if (lead) publish(mine, m || blk == 0, agg);
    uint32_t in = none;
    if (blk) {
      in = look_back(status, blk, col, none, g0);
      if (lead && !m) publish(mine, true, in);
    }
    if (lead) {
      if (col < kSlots) inval[col] = in;
      else lit_in = (int)in;
    }
  }
  __syncthreads();

  // -- 3. each pixel, from shared memory
  int run_in = 0;
  if (blk > 0) {
    // the TPU kernel zeroes its run carry after a block whose valid region
    // reaches past last_pos; otherwise the carry is the run since the last
    // literal (or the stream start), mod 62
    const int lim = min(max(n_valid, base - kBlock), base);
    if (!(last_pos < lim)) {
      const int e = min(n_valid, base);
      const int l = lit_in;
      run_in = (l >= 0 ? e - 1 - l : e) % kRunCap;
    }
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
                        : -1;
    const unsigned le = lits & ((2u << lane) - 1u), lt = lits & below_lane;
    const int ln = le ? gid - lane + top_bit(le) : rlit;  // last literal <= i
    const int lp = lt ? gid - lane + top_bit(lt) : rlit;  // last literal < i
    const int run_pos = ln >= 0 ? gid - ln : i + 1 + run_in;
    bool prev_eq;
    int prev_run_pos;
    if (i == 0) {
      prev_eq = run_in > 0;
      prev_run_pos = run_in;
    } else {
      prev_eq = lp != gid - 1;
      prev_run_pos = lp >= 0 ? gid - 1 - lp : i + run_in;
    }
    // run bytes: (run_pos - 1) % 62 for an eq pixel (run_pos >= 1), a
    // multiple of 62 iff that is 61; the same for the flushed run
    const int run_m = (run_pos - 1) % kRunCap;
    const int prev_m = (prev_run_pos - 1) % kRunCap;
    const bool emits_run =
        eq && valid && (run_m == kRunCap - 1 || gid == last_pos);
    const bool flush =
        !eq && prev_eq && prev_run_pos > 0 && prev_m != kRunCap - 1;

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
    lens[gid] = len;

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
    reinterpret_cast<int4*>(stag + (size_t)base * 6)[q] =
        reinterpret_cast<const int4*>(sst)[q];
}

}  // namespace

// scratch: (1 + 65 * N / 1024) 64-bit words, zeroed by the wrapper: the
// ticket, then the status words.
extern "C" int qoi_encode_stage(const void* px4, void* stag, void* lens,
                                void* scratch, int n, int n_valid,
                                int last_pos, void* stream) {
  if (n <= 0) return 0;
  if (n % kBlock) return (int)cudaErrorInvalidValue;
  encode_stage_kernel<<<n / kBlock, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px4, (uint8_t*)stag, (int32_t*)lens,
      (unsigned long long*)scratch, n_valid, last_pos);
  return (int)cudaGetLastError();
}
