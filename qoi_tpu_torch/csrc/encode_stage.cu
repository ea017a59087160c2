// Fused encode staging: kernel S of the PyTorch/CUDA port.
//
// Replaces the Pallas kernel qoi_tpu/kernels/encode_stage.py::
// encode_stage_pallas (_kernel): encoder stages 1-4 in one pass, px4 (N, 4)
// uint8 -> staging (N, 6) uint8 with bytes at or past len zeroed, and lens
// (N, 1) int32. Blocks are 1024 pixels, as the JAX kernel's default block.
//
// The TPU kernel runs its grid in order and carries the previous pixel, the
// run phase and the 64-slot colour table from one block to the next in
// scratch memory (encode_stage.py:93-101, 205-222). Blocks on this card run
// in no order, so the carries are computed instead, in three launches:
//   1. summary, per block in parallel: the last literal (non-eq) pixel and,
//      for each of the 64 slots, the last pixel that wrote it (global
//      indices, -1 for none). A table write is a literal pixel, so "last
//      writer wins" is "largest index wins".
//   2. carry, one block per summary row: the exclusive prefix max of the
//      65 rows over the blocks, so each block learns the last writer of
//      every slot and the last literal before it.
//   3. emit, per block with its carry-in: the incoming table value of a slot
//      is the pixel at its last writer (0 for none: an unwritten slot reads
//      as the zero pixel, which makes the `before == packed` hit test of
//      encode_stage.py:149-154 exact); the previous pixel is px[base - 1]
//      (the seed (0, 0, 0, 255) for block 0); the run phase entering the
//      block follows from the last literal before it, and is cut to 0 at
//      every block start after the one holding last_pos, as the TPU kernel
//      cuts its run carry (encode_stage.py:216). Inside the block, the last
//      literal at or before a pixel and the last earlier writer of its slot
//      come from bitmasks in shared memory (one 1024-bit mask of literals,
//      one per slot of writers) by a count-leading-zeros search.
// Padding (index >= n_valid) is forced to eq, and the pending-run flush
// tests prev_run_pos % 62, both as in the TPU kernel.
//
// Bound on the H100: memory traffic, 4 B/px read and 10 B/px written (about
// 117 MB, ~0.035 ms at a 4K frame of 2^23 pixels). This design reads the
// pixels twice (launches 1 and 3) and writes each block's 6 KB of staging
// from shared memory as coalesced 32-bit words; launch 2 is a few
// microseconds of scans over 65 x 8192 summaries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;         // pixels per block = threads per block
constexpr int kWords = kBlock / 32;  // 32-bit words of a per-block bitmask
constexpr int kSlots = 64;
constexpr int kRunCap = 62;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255) packed r|g|b|a

__device__ __forceinline__ int hash_px(uint32_t p) {
  return (int)(((p & 0xFFu) * 3u + ((p >> 8) & 0xFFu) * 5u +
                ((p >> 16) & 0xFFu) * 7u + (p >> 24) * 11u) & 63u);
}

// to signed char: (x mod 256) in [-128, 127]
__device__ __forceinline__ int sgn8(int x) { return ((x & 0xFF) ^ 0x80) - 0x80; }

// Highest set bit at or below position i of a kBlock-bit mask, or -1.
__device__ __forceinline__ int last_set_at_or_below(const uint32_t* mask,
                                                    int i) {
  if (i < 0) return -1;
  int w = i >> 5;
  uint32_t m = mask[w] & (kFull >> (31 - (i & 31)));
  while (true) {
    if (m) return (w << 5) + 31 - __clz(m);
    if (--w < 0) return -1;
    m = mask[w];
  }
}

__global__ void __launch_bounds__(kBlock)
stage_summary_kernel(const uint32_t* __restrict__ px,
                     int32_t* __restrict__ summ, int n_valid, int nblk) {
  __shared__ int lastw[kSlots];
  __shared__ int lastlit;
  const int t = threadIdx.x;
  const int blk = blockIdx.x;
  const int gid = blk * kBlock + t;
  if (t < kSlots) lastw[t] = -1;
  if (t == 0) lastlit = -1;
  __syncthreads();
  const uint32_t p = px[gid];
  const uint32_t prev = gid ? px[gid - 1] : kSeed;
  const bool eq = p == prev || gid >= n_valid;
  if (!eq) atomicMax(&lastw[hash_px(p)], gid);
  const int m = __reduce_max_sync(kFull, eq ? -1 : gid);
  if ((t & 31) == 0 && m >= 0) atomicMax(&lastlit, m);
  __syncthreads();
  if (t < kSlots) summ[(size_t)t * nblk + blk] = lastw[t];
  if (t == kSlots) summ[(size_t)kSlots * nblk + blk] = lastlit;
}

// Row blockIdx.x of carry = exclusive prefix max of the same row of summ.
__global__ void __launch_bounds__(kBlock)
stage_carry_kernel(const int32_t* __restrict__ summ,
                   int32_t* __restrict__ carry, int nblk) {
  __shared__ int warp_max[32];
  __shared__ int running;
  const int32_t* in = summ + (size_t)blockIdx.x * nblk;
  int32_t* out = carry + (size_t)blockIdx.x * nblk;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  if (t == 0) running = -1;
  __syncthreads();
  for (int base = 0; base < nblk; base += kBlock) {
    const int i = base + t;
    int v = i < nblk ? in[i] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = max(v, u);
    }
    int ex = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) ex = -1;
    if (lane == 31) warp_max[wid] = v;
    __syncthreads();
    if (wid == 0) {
      int w = warp_max[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w = max(w, u);
      }
      warp_max[lane] = w;
    }
    __syncthreads();
    ex = max(max(ex, wid ? warp_max[wid - 1] : -1), running);
    if (i < nblk) out[i] = ex;
    __syncthreads();
    if (t == 0) running = max(running, warp_max[31]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBlock)
stage_emit_kernel(const uint32_t* __restrict__ px,
                  const int32_t* __restrict__ carry,
                  uint8_t* __restrict__ stag, int32_t* __restrict__ lens,
                  int n_valid, int last_pos, int nblk) {
  __shared__ uint32_t spx[kBlock];
  __shared__ uint32_t wmask[kSlots][kWords + 1];  // +1: slots on distinct banks
  __shared__ uint32_t litmask[kWords];
  __shared__ uint32_t inval[kSlots];
  __shared__ uint32_t sst[kBlock * 6 / 4];
  __shared__ int run_in_s;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int blk = blockIdx.x;
  const int base = blk * kBlock;
  const int gid = base + t;

  const uint32_t p = px[gid];
  const uint32_t prev = gid ? px[gid - 1] : kSeed;
  const bool valid = gid < n_valid;
  const bool eq = p == prev || !valid;
  const int key = hash_px(p);
  spx[t] = p;
  for (int i = t; i < kSlots * (kWords + 1); i += kBlock)
    (&wmask[0][0])[i] = 0u;
  const uint32_t lit = __ballot_sync(kFull, !eq);
  if (lane == 0) litmask[wid] = lit;
  if (t < kSlots) {
    const int idx = carry[(size_t)t * nblk + blk];
    inval[t] = idx >= 0 ? px[idx] : 0u;
  }
  if (t == kSlots) {
    int run_in = 0;
    if (blk > 0) {
      // the TPU kernel zeroes its run carry after a block whose valid
      // region reaches past last_pos; otherwise the carry is the run since
      // the last literal (or the stream start), mod 62
      const int lim = min(max(n_valid, base - kBlock), base);
      if (!(last_pos < lim)) {
        const int e = min(n_valid, base);
        const int l = carry[(size_t)kSlots * nblk + blk];
        run_in = (l >= 0 ? e - 1 - l : e) % kRunCap;
      }
    }
    run_in_s = run_in;
  }
  __syncthreads();
  if (!eq) atomicOr(&wmask[key][wid], 1u << lane);
  __syncthreads();

  // -- run segmentation (qoi.h:415-428), as scans.run_segmentation
  const int run_in = run_in_s;
  const int ln = last_set_at_or_below(litmask, t);
  const int run_pos = ln >= 0 ? t - ln : t + 1 + run_in;
  bool prev_eq;
  int prev_run_pos;
  if (t == 0) {
    prev_eq = run_in > 0;
    prev_run_pos = run_in;
  } else {
    prev_eq = !((litmask[(t - 1) >> 5] >> ((t - 1) & 31)) & 1u);
    const int lp = last_set_at_or_below(litmask, t - 1);
    prev_run_pos = lp >= 0 ? t - 1 - lp : t + run_in;
  }
  const bool emits_run =
      eq && valid && (run_pos % kRunCap == 0 || gid == last_pos);
  const int run_val = (run_pos - 1) % kRunCap + 1;  // used only when eq
  const bool flush = !eq && prev_eq && (prev_run_pos % kRunCap != 0);
  const int flush_val = (prev_run_pos - 1) % kRunCap + 1;

  // -- colour-table replay (qoi.h:430-436): last earlier writer of the slot
  const int lw = last_set_at_or_below(wmask[key], t - 1);
  const uint32_t before = lw >= 0 ? spx[lw] : inval[key];
  const bool hit = !eq && before == p;

  // -- classification (qoi.h:438-474)
  const int r = p & 0xFF, g = (p >> 8) & 0xFF, b = (p >> 16) & 0xFF;
  const int a = p >> 24;
  const int vr = sgn8(r - (int)(prev & 0xFF));
  const int vg = sgn8(g - (int)((prev >> 8) & 0xFF));
  const int vb = sgn8(b - (int)((prev >> 16) & 0xFF));
  const int vg_r = sgn8(vr - vg), vg_b = sgn8(vb - vg);
  const bool alpha_same = a == (int)(prev >> 24);
  const bool is_diff = alpha_same && vr >= -2 && vr <= 1 && vg >= -2 &&
                       vg <= 1 && vb >= -2 && vb <= 1;
  const bool is_luma = alpha_same && !is_diff && vg >= -32 && vg <= 31 &&
                       vg_r >= -8 && vg_r <= 7 && vg_b >= -8 && vg_b <= 7;
  const bool is_rgb = alpha_same && !is_diff && !is_luma;
  const int own0 = hit       ? key
                   : is_diff ? (0x40 | (vr + 2) << 4 | (vg + 2) << 2 | (vb + 2))
                   : is_luma ? (0x80 | (vg + 32))
                   : is_rgb  ? 0xFE
                             : 0xFF;
  const int own1 = is_luma ? ((vg_r + 8) << 4 | (vg_b + 8)) : r;
  const int own_len = (hit || is_diff) ? 1 : is_luma ? 2 : is_rgb ? 4 : 5;

  int s[6];
  if (eq) {
    s[0] = 0xC0 | (run_val - 1);
    s[1] = s[2] = s[3] = s[4] = s[5] = 0;
  } else if (flush) {
    s[0] = 0xC0 | (flush_val - 1);
    s[1] = own0; s[2] = own1; s[3] = g; s[4] = b; s[5] = a;
  } else {
    s[0] = own0; s[1] = own1; s[2] = g; s[3] = b; s[4] = a; s[5] = 0;
  }
  const int len = eq ? (emits_run ? 1 : 0) : own_len + (flush ? 1 : 0);
  uint8_t* sb = reinterpret_cast<uint8_t*>(sst);
#pragma unroll
  for (int c = 0; c < 6; ++c) sb[t * 6 + c] = c < len ? (uint8_t)s[c] : 0;
  lens[gid] = len;
  __syncthreads();
  uint32_t* out32 = reinterpret_cast<uint32_t*>(stag + (size_t)base * 6);
  for (int i = t; i < kBlock * 6 / 4; i += kBlock) out32[i] = sst[i];
}

}  // namespace

extern "C" int qoi_encode_stage(const void* px4, void* stag, void* lens,
                                void* summ, void* carry, int n, int n_valid,
                                int last_pos, void* stream) {
  if (n <= 0) return 0;
  const int nblk = n / kBlock;
  cudaStream_t s = (cudaStream_t)stream;
  stage_summary_kernel<<<nblk, kBlock, 0, s>>>((const uint32_t*)px4,
                                               (int32_t*)summ, n_valid, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_carry_kernel<<<kSlots + 1, kBlock, 0, s>>>(
      (const int32_t*)summ, (int32_t*)carry, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_emit_kernel<<<nblk, kBlock, 0, s>>>(
      (const uint32_t*)px4, (const int32_t*)carry, (uint8_t*)stag,
      (int32_t*)lens, n_valid, last_pos, nblk);
  return (int)cudaGetLastError();
}
