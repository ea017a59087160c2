// The sequential QOI codec: two kernels of the PyTorch/CUDA port.
//
// Replace the two lax.scans of qoi_tpu/models/scan_codec.py: `_encode_scan`
// (the reference encoder, qoi.h:406-478) and `_decode_scan` (the reference
// decoder with an entry state, qoi.h:540-587). They are the codec's
// sequential anchor, the decode ladder's floor without the native build, and
// the streamed decoder's repair of tiles whose fixpoint does not converge.
//
// Each step depends on the previous one through the pixel, the run and the
// 64-slot table, so one thread walks the stream in order: the table lives in
// shared memory, the bytes are read through the read-only cache, and each
// pixel is written once. Bound on the H100: neither bytes nor operations but
// the latency of one dependent step a pixel (tens of cycles), so the kernels
// run far from the bandwidth bound; they exist for streams the parallel
// decoder cannot certify, not for speed.
//
// Pixels are packed u32 (r in the low byte). A decoder state is 65 words:
// the px, then the 64 slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kOpIndex = 0x00, kOpDiff = 0x40, kOpLuma = 0x80,
                   kOpRun = 0xC0, kOpRgb = 0xFE, kOpRgba = 0xFF;
constexpr uint32_t kSeed = 0xFF000000u;  // (0, 0, 0, 255)
constexpr int kRunCap = 62;

__device__ __forceinline__ uint32_t hash64(uint32_t p) {
  return (3u * (p & 0xFF) + 5u * ((p >> 8) & 0xFF) + 7u * ((p >> 16) & 0xFF) +
          11u * (p >> 24)) & 63u;
}

// px + (dr, dg, db, 0) per channel, mod 256
__device__ __forceinline__ uint32_t byte_add(uint32_t px, int dr, int dg,
                                             int db) {
  return ((px + dr) & 0xFF) | (((px >> 8) + dg) & 0xFF) << 8 |
         (((px >> 16) + db) & 0xFF) << 16 | (px & 0xFF000000u);
}

__device__ __forceinline__ int s8(int x) { return (int)(int8_t)(uint8_t)x; }

__global__ void decode_scan_kernel(const uint8_t* __restrict__ data,
                                   long long data_len, long long chunks_len,
                                   long long n_px,
                                   const uint32_t* __restrict__ state_in,
                                   uint32_t* __restrict__ out,
                                   uint32_t* __restrict__ state_out) {
  __shared__ uint32_t table[64];
  if (threadIdx.x < 64) table[threadIdx.x] = state_in[1 + threadIdx.x];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long last = data_len - 1;
  uint32_t px = state_in[0];
  int run = 0;
  long long p = 0;
  for (long long i = 0; i < n_px; ++i) {
    if (run == 0 && p < chunks_len) {
      // a chunk's bytes are read clamped to the buffer, as the JAX scan
      // reads them
      const uint32_t b1 = __ldg(data + (p < last ? p : last));
      const uint32_t b2 = __ldg(data + (p + 1 < last ? p + 1 : last));
      const uint32_t tag = b1 & 0xC0;
      if (b1 == kOpRgb || b1 == kOpRgba) {
        const uint32_t b3 = __ldg(data + (p + 2 < last ? p + 2 : last));
        const uint32_t b4 = __ldg(data + (p + 3 < last ? p + 3 : last));
        if (b1 == kOpRgb) {
          px = b2 | b3 << 8 | b4 << 16 | (px & 0xFF000000u);
          p += 4;
        } else {
          const uint32_t b5 = __ldg(data + (p + 4 < last ? p + 4 : last));
          px = b2 | b3 << 8 | b4 << 16 | b5 << 24;
          p += 5;
        }
      } else if (tag == kOpIndex) {
        px = table[b1 & 63];
        p += 1;
      } else if (tag == kOpDiff) {
        px = byte_add(px, (int)((b1 >> 4) & 3) - 2, (int)((b1 >> 2) & 3) - 2,
                      (int)(b1 & 3) - 2);
        p += 1;
      } else if (tag == kOpLuma) {
        const int vg = (int)(b1 & 0x3F) - 32;
        px = byte_add(px, vg - 8 + (int)(b2 >> 4), vg,
                      vg - 8 + (int)(b2 & 15));
        p += 2;
      } else {  // kOpRun
        run = (int)(b1 & 0x3F);
        p += 1;
      }
      table[hash64(px)] = px;  // after every chunk (qoi.h:577)
    } else if (run > 0) {
      --run;
    }
    out[i] = px;
  }
  state_out[0] = px;
  for (int s = 0; s < 64; ++s) state_out[1 + s] = table[s];
}

__global__ void encode_scan_kernel(const uint32_t* __restrict__ pixels,
                                   long long n, uint8_t* __restrict__ staging,
                                   int32_t* __restrict__ lens) {
  __shared__ uint32_t table[64];
  if (threadIdx.x < 64) table[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t prev = kSeed;
  int run = 0;
  for (long long i = 0; i < n; ++i) {
    const uint32_t p = __ldg(pixels + i);
    uint32_t o[6] = {0, 0, 0, 0, 0, 0};
    int len;
    if (p == prev) {
      // a run member keeps its run byte in byte 0, emitted only at the
      // cap or the last pixel (qoi.h:415-421)
      ++run;
      o[0] = kOpRun | (uint32_t)(run - 1);
      const bool emit = run == kRunCap || i == n - 1;
      len = emit ? 1 : 0;
      if (emit) run = 0;
    } else {
      uint32_t own[5] = {0, 0, 0, 0, 0};
      int own_len;
      const uint32_t slot = hash64(p);
      if (table[slot] == p) {
        own[0] = kOpIndex | slot;
        own_len = 1;
      } else {
        table[slot] = p;  // store on miss before the op choice (qoi.h:436)
        const uint32_t r = p & 0xFF, g = (p >> 8) & 0xFF, b = (p >> 16) & 0xFF,
                       a = p >> 24;
        const int vr = s8((int)r - (int)(prev & 0xFF));
        const int vg = s8((int)g - (int)((prev >> 8) & 0xFF));
        const int vb = s8((int)b - (int)((prev >> 16) & 0xFF));
        const int vg_r = s8(vr - vg), vg_b = s8(vb - vg);
        if (a != prev >> 24) {
          own[0] = kOpRgba; own[1] = r; own[2] = g; own[3] = b; own[4] = a;
          own_len = 5;
        } else if (vr >= -2 && vr <= 1 && vg >= -2 && vg <= 1 && vb >= -2 &&
                   vb <= 1) {
          own[0] = kOpDiff | (uint32_t)(vr + 2) << 4 |
                   (uint32_t)(vg + 2) << 2 | (uint32_t)(vb + 2);
          own_len = 1;
        } else if (vg >= -32 && vg <= 31 && vg_r >= -8 && vg_r <= 7 &&
                   vg_b >= -8 && vg_b <= 7) {
          own[0] = kOpLuma | (uint32_t)(vg + 32);
          own[1] = (uint32_t)(vg_r + 8) << 4 | (uint32_t)(vg_b + 8);
          own_len = 2;
        } else {
          own[0] = kOpRgb; own[1] = r; own[2] = g; own[3] = b;
          own_len = 4;
        }
      }
      if (run > 0) {  // flush the pending run first (qoi.h:425-428)
        o[0] = kOpRun | (uint32_t)(run - 1);
        for (int k = 0; k < 5; ++k) o[1 + k] = own[k];
        len = own_len + 1;
      } else {
        for (int k = 0; k < 5; ++k) o[k] = own[k];
        len = own_len;
      }
      run = 0;
      prev = p;
    }
    uint8_t* dst = staging + 6 * i;
    for (int k = 0; k < 6; ++k) dst[k] = (uint8_t)o[k];
    lens[i] = len;
  }
}

}  // namespace

extern "C" int qoi_decode_scan(const void* data, long long data_len,
                               long long chunks_len, long long n_px,
                               const void* state_in, void* out,
                               void* state_out, void* stream) {
  decode_scan_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, data_len, chunks_len, n_px,
      (const uint32_t*)state_in, (uint32_t*)out, (uint32_t*)state_out);
  return (int)cudaGetLastError();
}

extern "C" int qoi_encode_scan(const void* pixels, long long n, void* staging,
                               void* lens, void* stream) {
  encode_scan_kernel<<<1, 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pixels, n, (uint8_t*)staging, (int32_t*)lens);
  return (int)cudaGetLastError();
}
