// Word compaction of the encode's records: kernel C of the PyTorch/CUDA port.
//
// qoi_compact_words replaces, on the card, the word-sum compaction
// qoi_tpu/ops/compact.py::compact_words6_wordsum with its event slide, the
// Pallas kernel qoi_tpu/kernels/slide.py::slide_val. Records lo, hi, lens
// (N,) 32-bit (bytes 0..3 little-endian, bytes 4..5, the length 0..6) ->
// the stream's bytes packed at the exclusive prefix sum of the lengths, as
// (capacity / 4,) little-endian words, and the total (int64). The word-sum
// route builds two event slots a record, slides them (slide_val), adds the
// rows at their word offsets and differences running sums: ~40 int64 passes
// over the records. Here each record's bytes go straight to their words.
//
// The output equals the word-sum route's word for word, past the stream
// too: words [0, ceil(total / 4)) hold the stream (bytes past total zero),
// the next word, when it lies inside capacity, is (-sum of the stream's
// words) mod 2^32 (the difference form leaves the grand total there), and
// every later word is 0. total == 0 gives all zeros.
//
// Design (one launch, after a memset of the output and the scratch):
//   1. ticket: each block takes its tile of 4096 records from an atomic
//      counter, so a tile never waits on one that has not started;
//   2. loads: thread t holds records 8t .. 8t + 7 of the tile, each array as
//      two 16-byte loads (element loads past N or off 16 bytes); the lengths
//      are kept as 3-bit fields of one register;
//   3. block scan of the threads' byte counts (warp shuffles, the warp
//      totals in shared memory): each thread's offset inside the tile and
//      the tile's byte count T (at most 6 x 4096);
//   4. look-back: warp 0 publishes T as the tile's aggregate, reads the
//      status words of the 32 tiles before it (a lane each), adds up to the
//      newest inclusive one, waits while a newer word is unpublished, slides
//      back 32 while all are aggregates, and publishes its inclusive prefix.
//      A status word is flag << 32 | bytes; offsets stay below 2^32 (the
//      wrapper refuses 6N >= 2^32);
//   5. the tile's words in shared memory (at most 6144 + 4, 24.6 KB): each
//      thread packs its records' bytes through a 64-bit accumulator and
//      stores each finished word; a word it shares with the thread before
//      or after (its first word when it starts inside a word, its last
//      partial word) goes by a shared atomicOr into the zeroed buffer;
//   6. out: the tile's whole words as 16-byte stores (element stores at the
//      edges of the 16-byte run); the words it shares with the tiles before
//      and after -- any number of tiles may share a word, a tile of 0-3
//      bytes lying inside one -- by atomicOr into the zeroed output. Bytes
//      of different tiles never overlap, so the ORs are exact and order-free;
//   7. the trailing word: each tile adds the sum of its words (partial words
//      included: their bytes are disjoint, so the parts add up to the word)
//      to a 64-bit accumulator, then counts itself done behind a
//      __threadfence(); the last tile by ticket writes total first. The tile
//      that finishes last writes -sum at word ceil(total / 4) when it lies
//      inside capacity.
// Bytes at or past a record's length are masked off, and a length is taken
// at most 6: inputs outside the contract cannot write outside the tile's
// shared words. Words at or past capacity are never written.
//
// Bound on the H100: bytes. 12 B a record read (lo, hi, lens as int32) and
// the capacity's 6 B a record written (the memset) plus the stream's words:
// ~165 MB at a 4K frame of 8,294,400 records with a 15 MB stream, ~0.049 ms
// at 3.35 TB/s. The
// packing is ~10 integer operations a byte, and a tile waits for its ticket,
// its loads and its look-back in turn, so the loads of other tiles have to
// be in flight meanwhile: three blocks of 512 threads an SM (40 registers,
// 24.7 KB of shared memory each), ~5 waves of 396 tiles at 4K. At two
// blocks an SM (64 registers) the kernel took 84 us on an H100 80GB HBM3 at
// 700 W, at three 72 us, at four (32 registers, spilling) 73 us.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;               // records a tile
constexpr int kThreads = 512;
constexpr int kPer = kTile / kThreads;    // records a thread
constexpr int kWarps = kThreads / 32;
// the tile's words: 6 x 4096 bytes, 4 of alignment below, 1 partial above
constexpr int kSmWords = kTile * 6 / 4 + 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAgg = 1u, kInc = 2u;  // status flags: 0 not published
// scratch: the ticket, the done counter, the word sum, the total, then a
// status word a tile
constexpr int kHead = 4;

struct Args {
  const uint32_t* lo;
  const uint32_t* hi;
  const uint32_t* lens;
  uint32_t* out;                  // (wcap,) words, zeroed
  long long* total;               // 0-d
  unsigned long long* scratch;    // kHead + tiles, zeroed
  long long n;
  long long tiles;
  unsigned long long wcap;
  bool vec;                       // lo, hi and lens on 16 bytes
};

__device__ __forceinline__ void publish(unsigned long long* w, unsigned flag,
                                        uint32_t v) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      (unsigned long long)flag << 32 | v;
}

// One warp: the bytes of tiles 0 .. j - 1 (j > 0). Lane l reads tile hi - l;
// the window adds up to its first inclusive word, waits while a word before
// that is unpublished, and slides back 32 tiles while all are aggregates.
__device__ uint32_t look_back(const unsigned long long* status, long long j) {
  const int lane = threadIdx.x & 31;
  long long hi = j - 1;
  uint32_t acc = 0;
  while (true) {
    const long long jj = hi - lane;
    unsigned long long w = (unsigned long long)kInc << 32;  // before tile 0
    if (jj >= 0)
      w = *reinterpret_cast<const volatile unsigned long long*>(status + jj);
    const unsigned flag = (unsigned)(w >> 32);
    const unsigned stop = __ballot_sync(kFull, flag != kAgg);
    if (stop != 0u) {
      const int first = __ffs(stop) - 1;
      if (__shfl_sync(kFull, flag, first) != kInc) {
        __nanosleep(32);
        continue;
      }
      return acc + __reduce_add_sync(kFull, lane <= first ? (uint32_t)w : 0u);
    }
    acc += __reduce_add_sync(kFull, (uint32_t)w);
    hi -= 32;
  }
}

// Thread-local packer of a byte stream into the tile's shared words.
struct Packer {
  uint32_t* sw;
  uint32_t w;          // shared index of the word being filled
  int have;            // bits in acc
  bool shared_first;   // the word being filled holds bytes of the thread
                       // before
  unsigned long long acc;

  __device__ __forceinline__ void push(uint32_t bits, int nbits) {
    acc |= (unsigned long long)bits << have;
    have += nbits;
    if (have >= 32) {
      if (shared_first)
        atomicOr(sw + w, (uint32_t)acc);
      else
        sw[w] = (uint32_t)acc;
      shared_first = false;
      ++w;
      acc >>= 32;
      have -= 32;
    }
  }
};

__device__ __forceinline__ uint32_t low_bytes(uint32_t x, int nbytes) {
  return (uint32_t)(x & ((1ull << (8 * nbytes)) - 1ull));
}

__global__ void __launch_bounds__(kThreads, 3) compact_kernel(Args a) {
  __shared__ __align__(16) uint32_t sw[kSmWords];
  __shared__ uint32_t wt[kWarps];
  __shared__ uint32_t red[kWarps];
  __shared__ long long s_tile;
  __shared__ uint32_t s_base;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  unsigned long long* status = a.scratch + kHead;

  // -- 1. ticket; the shared words zeroed meanwhile
  if (t == 0) s_tile = (long long)atomicAdd(a.scratch, 1ull);
  for (int i = t; i < kSmWords / 4; i += kThreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const long long j = s_tile;

  // -- 2. loads
  const long long first = j * kTile + (long long)t * kPer;
  uint32_t lo[kPer], hi[kPer], ln[kPer];
  if (a.vec && first + kPer <= a.n) {
    const uint4* l16 = reinterpret_cast<const uint4*>(a.lens + first);
    const uint4* o16 = reinterpret_cast<const uint4*>(a.lo + first);
    const uint4* h16 = reinterpret_cast<const uint4*>(a.hi + first);
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h) {
      const uint4 l4 = __ldg(l16 + h);
      const uint4 o4 = __ldg(o16 + h);
      const uint4 h4 = __ldg(h16 + h);
      ln[4 * h] = l4.x; ln[4 * h + 1] = l4.y;
      ln[4 * h + 2] = l4.z; ln[4 * h + 3] = l4.w;
      lo[4 * h] = o4.x; lo[4 * h + 1] = o4.y;
      lo[4 * h + 2] = o4.z; lo[4 * h + 3] = o4.w;
      hi[4 * h] = h4.x; hi[4 * h + 1] = h4.y;
      hi[4 * h + 2] = h4.z; hi[4 * h + 3] = h4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool in = first + k < a.n;
      ln[k] = in ? __ldg(a.lens + first + k) : 0u;
      lo[k] = in ? __ldg(a.lo + first + k) : 0u;
      hi[k] = in ? __ldg(a.hi + first + k) : 0u;
    }
  }
  uint32_t mine = 0, lnp = 0;   // lnp: the lengths, 3 bits each
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t l = ln[k] < 6u ? ln[k] : 6u;
    mine += l;
    lnp |= l << (3 * k);
  }

  // -- 3. block scan of the byte counts
  uint32_t inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wt[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    uint32_t v = lane < kWarps ? wt[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += y;
    }
    if (lane < kWarps) wt[lane] = v;
  }
  __syncthreads();
  const uint32_t T = wt[kWarps - 1];
  const uint32_t loc = (wid > 0 ? wt[wid - 1] : 0u) + inc - mine;

  // -- 4. look-back
  if (wid == 0) {
    uint32_t ex = 0;
    if (j == 0) {
      if (lane == 0) publish(status, kInc, T);
    } else {
      if (lane == 0) publish(status + j, kAgg, T);
      ex = look_back(status, j);
      if (lane == 0) publish(status + j, kInc, ex + T);
    }
    if (lane == 0) s_base = ex;
  }
  __syncthreads();
  const uint32_t E = s_base, I = E + T;
  const uint32_t base_w = (E >> 2) & ~3u;   // shared word 0: a 16-byte row

  // -- 5. the tile's words in shared memory
  {
    const uint32_t pos = E + loc;
    Packer p{sw, (pos >> 2) - base_w, (int)(pos & 3u) * 8, (pos & 3u) != 0u,
             0ull};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int l = (int)((lnp >> (3 * k)) & 7u);
      if (l == 0) continue;
      p.push(low_bytes(lo[k], l < 4 ? l : 4), 8 * (l < 4 ? l : 4));
      if (l > 4) p.push(low_bytes(hi[k], l - 4), 8 * (l - 4));
    }
    if (mine > 0 && p.have > 0) atomicOr(sw + p.w, (uint32_t)p.acc);
  }
  __syncthreads();

  // -- 6. out; 7. the sum of the tile's words
  uint32_t part = 0;
  if (T > 0) {
    const unsigned long long wcap = a.wcap;
    const uint32_t g0 = E >> 2, gl = (I - 1) >> 2;   // first, last word
    for (uint32_t g = g0 + t; g <= gl; g += kThreads) part += sw[g - base_w];
    const bool head = (E & 3u) != 0u, tail = (I & 3u) != 0u;
    if (t == 0 && head && g0 < wcap) atomicOr(a.out + g0, sw[g0 - base_w]);
    if (t == 32 && tail && !(head && gl == g0) && gl < wcap)
      atomicOr(a.out + gl, sw[gl - base_w]);
    // whole words [wa, wb): element stores outside [v0, v1), 16-byte inside
    const uint32_t wa = (E + 3u) >> 2;
    const uint32_t wb = (unsigned long long)(I >> 2) < wcap
                            ? (I >> 2) : (uint32_t)wcap;
    const uint32_t a4 = (wa + 3u) & ~3u, b4 = wb & ~3u;
    const uint32_t v0 = a4 < b4 ? a4 : (wb > wa ? wb : wa);
    const uint32_t v1 = a4 < b4 ? b4 : v0;
    for (uint32_t g = v0 / 4 + t; g < v1 / 4; g += kThreads)
      reinterpret_cast<uint4*>(a.out)[g] =
          reinterpret_cast<const uint4*>(sw)[g - base_w / 4];
    if (t >= 64 && t < 72 && wa + (t - 64) < v0)   // at most 6 words
      a.out[wa + (t - 64)] = sw[wa + (t - 64) - base_w];
    if (t >= 96 && t < 100 && v1 + (t - 96) < wb)   // at most 3 words
      a.out[v1 + (t - 96)] = sw[v1 + (t - 96) - base_w];
  }
  part = __reduce_add_sync(kFull, part);
  if (lane == 0) red[wid] = part;
  __syncthreads();
  if (t == 0) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w];
    atomicAdd(a.scratch + 2, (unsigned long long)sum);
    if (j == a.tiles - 1) {
      *a.total = (long long)I;
      *reinterpret_cast<volatile unsigned long long*>(a.scratch + 3) = I;
    }
    __threadfence();
    if (atomicAdd(a.scratch + 1, 1ull) == (unsigned long long)a.tiles - 1) {
      __threadfence();
      const uint32_t all = (uint32_t)atomicAdd(a.scratch + 2, 0ull);
      const unsigned long long tot =
          *reinterpret_cast<volatile unsigned long long*>(a.scratch + 3);
      const unsigned long long wt_ = (tot + 3ull) >> 2;
      if (wt_ < a.wcap) a.out[wt_] = 0u - all;
    }
  }
}

}  // namespace

// lo, hi, lens: (n,) 32-bit, n >= 1, 6n < 2^32; out: (wcap,) 32-bit words on
// 16 bytes; total: one int64; scratch: 4 + ceil(n / 4096) 64-bit words.
extern "C" int qoi_compact_words(const void* lo, const void* hi,
                                 const void* lens, long long n, void* out,
                                 long long wcap, void* total, void* scratch,
                                 void* stream) {
  if (n <= 0 || 6 * n >= (1ll << 32) || wcap < 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.lo = (const uint32_t*)lo;
  a.hi = (const uint32_t*)hi;
  a.lens = (const uint32_t*)lens;
  a.out = (uint32_t*)out;
  a.total = (long long*)total;
  a.scratch = (unsigned long long*)scratch;
  a.n = n;
  a.tiles = (n + kTile - 1) / kTile;
  a.wcap = (unsigned long long)wcap;
  a.vec = ((reinterpret_cast<uintptr_t>(lo) | reinterpret_cast<uintptr_t>(hi) |
            reinterpret_cast<uintptr_t>(lens)) & 15u) == 0u;
  const cudaStream_t st = (cudaStream_t)stream;
  int e = (int)cudaMemsetAsync(out, 0, (size_t)wcap * 4, st);
  if (e) return e;
  e = (int)cudaMemsetAsync(scratch, 0, (size_t)(kHead + a.tiles) * 8, st);
  if (e) return e;
  compact_kernel<<<(unsigned)a.tiles, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
