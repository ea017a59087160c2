// Inclusive scans of the decoder's three associative combines: kernel of
// the PyTorch/CUDA port.
//
// Replaces qoi_tpu/ops/scans.py::blocked_scan (its lax.scan over
// position-in-block, :142) for the three combines the decode main path
// scans with it:
//   qoi_fsm_scan      the chunk-start FSM (qoi_tpu/ops/fsm.py:82,
//                     _compose_maps): base-8 packed 5-state maps,
//                     c[s] = b[a[s]]; the leaf _pack_map(chunk_byte_len(b)
//                     - 1) is built here from the (M,) uint8 bytes;
//   qoi_initial_scan  _initial_w's affine (alpha, hash) combine
//                     (qoi_tpu/models/decode_v3.py:197) on the 22-bit leaf
//                     [ra:1 | g:1 | t:6 | e:6 | va:8], co-scanned with the
//                     npix sum (int32 in, int64 out);
//   qoi_anch_scan     _anch_comb, the anchored rebuild's 7-bit (g, e) leaf
//                     (decode_v3.py:238 over the stream, :266 over the
//                     surgical round's rows), each of R rows on its own.
// Each output is combine(earlier, later) folded from the row's first
// element: element 0 is its leaf unchanged, and no identity element is
// ever assumed (_initial_comb has none for arbitrary bit patterns). The
// maps are integers, so any grouping of an associative combine gives the
// same bits as JAX's scan.
//
// Design: reduce, then scan, over tiles of 4096 elements (256 threads x
// 16 consecutive elements; kernels/blocked_scan.TILE):
//   1. reduce_kernel: each tile but a row's last folds its elements
//      (each thread its 16 in registers, a warp scan of shuffles, the
//      eight warp totals through shared memory) into one aggregate;
//   2. agg_scan_kernel: one block a row scans the row's tile aggregates
//      in place (1024 at a time, carrying the running total);
//   3. scan_kernel: each tile scans again, seeded with the inclusive
//      aggregate of the tiles before it, and writes every element.
// Inputs are staged through shared memory with coalesced loads (any
// alignment; the ragged last tile is masked, not padded), and each
// thread's 16 outputs go back through the same slots to a coalesced
// store; the int64 sums go out from registers. All arithmetic is uint32
// (the sums uint64): no signed shift anywhere.
//
// Bound on the H100: bytes. Each element is read once and written once:
// 5 B (FSM: the byte in, the map out), 20 B (initial: leaf and npix in,
// map and int64 sum out) and 8 B (anch); one combine an element is ~40
// integer operations at most. At the 4K mixed stream's M = 14,680,064:
// 73.4 / 293.6 / 117.4 MB, 0.022 / 0.088 / 0.035 ms at 3.35 TB/s. The
// reduce pass reads the input a second time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096
constexpr int kPadTile = kTile + kTile / 32;
constexpr int kAggThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kFsm = 0, kInitial = 1, kAnch = 2 };

// digits 1..4 of every FSM leaf: state s > 0 goes to s - 1
constexpr uint32_t kFsmConst = (0u << 3) | (1u << 6) | (2u << 9) | (3u << 12);

struct V {
  uint32_t p;
  unsigned long long s;   // the npix sum (kInitial only)
};

struct Args {
  const void* in;              // uint8 bytes (kFsm) or int32 leaves
  const int32_t* npix;         // kInitial
  int32_t* out_p;
  long long* out_s;            // kInitial
  unsigned long long* agg_s;   // (rows, nt - 1) tile aggregates
  uint32_t* agg_p;
  long long len;               // elements a row
  long long nt;                // tiles a row
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
  if constexpr (K == kFsm) r.p = fsm_comb(a.p, b.p);
  else if constexpr (K == kInitial) r.p = initial_comb(a.p, b.p);
  else r.p = anch_comb(a.p, b.p);
  r.s = K == kInitial ? a.s + b.s : 0ull;
  return r;
}

template <int K>
__device__ __forceinline__ V shfl_up(const V& v, int d) {
  V r;
  r.p = __shfl_up_sync(kFull, v.p, d);
  r.s = 0ull;
  if constexpr (K == kInitial) r.s = __shfl_up_sync(kFull, v.s, d);
  return r;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The tile's n elements into shared memory, coalesced: leaves in sp, the
// npix words in sn (kInitial).
template <int K>
__device__ void load_tile(const Args& a, long long base, int n, uint32_t* sp,
                          uint32_t* sn) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    uint32_t p;
    if constexpr (K == kFsm) {
      const uint32_t b = static_cast<const uint8_t*>(a.in)[base + i];
      const uint32_t len = b == 0xFEu ? 4u
                           : b == 0xFFu ? 5u
                           : (b & 0xC0u) == 0x80u ? 2u : 1u;
      p = (len - 1u) | kFsmConst;
    } else {
      p = static_cast<uint32_t>(static_cast<const int32_t*>(a.in)[base + i]);
    }
    sp[pad(i)] = p;
    if constexpr (K == kInitial)
      sn[pad(i)] = static_cast<uint32_t>(a.npix[base + i]);
  }
  __syncthreads();
}

template <int K>
__device__ __forceinline__ V item(const uint32_t* sp, const uint32_t* sn,
                                  int i) {
  V v;
  v.p = sp[pad(i)];
  v.s = 0ull;
  if constexpr (K == kInitial)   // sign-extend the int32 npix
    v.s = static_cast<unsigned long long>(
        static_cast<long long>(static_cast<int32_t>(sn[pad(i)])));
  return v;
}

// This thread's fold of its cnt (>= 1) consecutive elements from `first`.
template <int K>
__device__ __forceinline__ V thread_fold(const uint32_t* sp,
                                         const uint32_t* sn, int first,
                                         int cnt) {
  V x = item<K>(sp, sn, first);
#pragma unroll
  for (int k = 1; k < kItems; ++k)
    if (k < cnt) x = comb<K>(x, item<K>(sp, sn, first + k));
  return x;
}

// Inclusive scan of one value a thread over the block's first `nvalid`
// threads (the others carry anything and get anything). wt holds the warp
// totals' inclusive scan afterwards; *tot the block total.
template <int K, int NT>
__device__ V block_scan(V x, int nvalid, V* wt, V* tot) {
  constexpr int kWarps = NT / 32;
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
  if (threadIdx.x == nvalid - 1) *tot = x;
  __syncthreads();
  return x;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(Args a) {
  __shared__ uint32_t sp[kPadTile];
  __shared__ uint32_t sn[K == kInitial ? kPadTile : 1];
  __shared__ V wt[kThreads / 32];
  __shared__ V tot;
  const long long row = blockIdx.y, j = blockIdx.x;   // j < nt - 1: full
  load_tile<K>(a, row * a.len + j * kTile, kTile, sp, sn);
  const V x = thread_fold<K>(sp, sn, threadIdx.x * kItems, kItems);
  block_scan<K, kThreads>(x, kThreads, wt, &tot);
  if (threadIdx.x == 0) {
    const long long at = row * (a.nt - 1) + j;
    a.agg_p[at] = tot.p;
    if constexpr (K == kInitial) a.agg_s[at] = tot.s;
  }
}

template <int K>
__global__ void __launch_bounds__(kAggThreads)
agg_scan_kernel(Args a) {
  __shared__ V wt[kAggThreads / 32];
  __shared__ V tot;
  const long long ns = a.nt - 1;
  const long long row0 = blockIdx.x * ns;
  V carry{0u, 0ull};
  for (long long c = 0; c < ns; c += kAggThreads) {
    const long long i = c + threadIdx.x;
    const bool valid = i < ns;
    V x{0u, 0ull};
    if (valid) {
      x.p = a.agg_p[row0 + i];
      if constexpr (K == kInitial) x.s = a.agg_s[row0 + i];
    }
    const int nvalid = static_cast<int>(
        ns - c < kAggThreads ? ns - c : kAggThreads);
    x = block_scan<K, kAggThreads>(x, nvalid, wt, &tot);
    if (c > 0) x = comb<K>(carry, x);
    if (valid) {
      a.agg_p[row0 + i] = x.p;
      if constexpr (K == kInitial) a.agg_s[row0 + i] = x.s;
    }
    carry = c > 0 ? comb<K>(carry, tot) : tot;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
scan_kernel(Args a) {
  __shared__ uint32_t sp[kPadTile];
  __shared__ uint32_t sn[K == kInitial ? kPadTile : 1];
  __shared__ V wt[kThreads / 32];
  __shared__ V tot;
  const long long row = blockIdx.y, j = blockIdx.x;
  const long long base = row * a.len + j * kTile;
  const long long rest = a.len - j * kTile;
  const int n = static_cast<int>(rest < kTile ? rest : kTile);
  load_tile<K>(a, base, n, sp, sn);

  const int first = threadIdx.x * kItems;
  const int cnt = n - first < kItems ? n - first : kItems;   // may be <= 0
  const int nvalid = (n + kItems - 1) / kItems;
  V x{0u, 0ull};
  if (cnt > 0) x = thread_fold<K>(sp, sn, first, cnt);
  x = block_scan<K, kThreads>(x, nvalid, wt, &tot);

  // this thread's exclusive prefix: the thread before it, the warp totals
  // before its warp, the tiles before this one
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  V acc = shfl_up<K>(x, 1);
  bool has = true;
  if (lane == 0) {
    if (w > 0) acc = wt[w - 1];
    else has = false;
  }
  if (j > 0) {
    const long long at = row * (a.nt - 1) + j - 1;
    V seed;
    seed.p = a.agg_p[at];
    seed.s = K == kInitial ? a.agg_s[at] : 0ull;
    acc = has ? comb<K>(seed, acc) : seed;
    has = true;
  }
  if (cnt > 0) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < cnt) {
        const V v = item<K>(sp, sn, first + k);
        acc = (has || k > 0) ? comb<K>(acc, v) : v;
        sp[pad(first + k)] = acc.p;   // only this thread reads this slot
        if constexpr (K == kInitial)
          a.out_s[base + first + k] = static_cast<long long>(acc.s);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    a.out_p[base + i] = static_cast<int32_t>(sp[pad(i)]);
}

template <int K>
int run(Args a, long long rows, void* stream) {
  if (rows <= 0 || a.len <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.nt = (a.len + kTile - 1) / kTile;
  cudaError_t e;
  if (a.nt > 1) {
    reduce_kernel<K><<<dim3(static_cast<unsigned>(a.nt - 1),
                            static_cast<unsigned>(rows)), kThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    agg_scan_kernel<K><<<static_cast<unsigned>(rows), kAggThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  scan_kernel<K><<<dim3(static_cast<unsigned>(a.nt),
                        static_cast<unsigned>(rows)), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// scratch: (rows * (nt - 1)) uint64 sums, then as many uint32 maps
Args make_args(const void* in, const void* npix, void* out_p, void* out_s,
               void* scratch, long long rows, long long len) {
  const long long nt = (len + kTile - 1) / kTile;
  const long long na = rows * (nt > 1 ? nt - 1 : 0);
  Args a;
  a.in = in;
  a.npix = static_cast<const int32_t*>(npix);
  a.out_p = static_cast<int32_t*>(out_p);
  a.out_s = static_cast<long long*>(out_s);
  a.agg_s = static_cast<unsigned long long*>(scratch);
  a.agg_p = reinterpret_cast<uint32_t*>(a.agg_s + na);
  a.len = len;
  a.nt = nt;
  return a;
}

}  // namespace

extern "C" int qoi_fsm_scan(const void* data, void* out, void* scratch,
                            long long m, void* stream) {
  return run<kFsm>(make_args(data, nullptr, out, nullptr, scratch, 1, m), 1,
                   stream);
}

extern "C" int qoi_initial_scan(const void* leaf, const void* npix, void* ps,
                                void* inc, void* scratch, long long m,
                                void* stream) {
  return run<kInitial>(make_args(leaf, npix, ps, inc, scratch, 1, m), 1,
                       stream);
}

extern "C" int qoi_anch_scan(const void* leaf, void* out, void* scratch,
                             long long rows, long long len, void* stream) {
  return run<kAnch>(make_args(leaf, nullptr, out, nullptr, scratch, rows,
                              len), rows, stream);
}
