// Event slides: kernel A (one value plane) and kernel D (two planes) of the
// PyTorch/CUDA port.
//
// qoi_slide_val replaces the Pallas kernel qoi_tpu/kernels/slide.py::
// slide_val (_slide_kernel), which slides every alive event of a segment row
// left by its distance in log2(sw) in-VMEM shift passes. qoi_slide_val2
// replaces slide_val2 (_slide_kernel2), the same slide carrying two value
// planes (pix_off, px32) through the same moves, for the decoder's chunk
// compaction (models/decode_v3._compact_chunks).
//
// Every event that ops/compact._wordsum_events_words builds has a UNIQUE
// destination i - dist inside its own row (destinations are strictly
// increasing in slot order), so no pass structure is needed on this card:
// each alive event (aux bit 0) is stored straight at i - dist. Dead slots
// stay 0, as the Pallas kernel's alive mask leaves them. An event whose
// distance would leave its row is dropped, as the shift passes drop it.
//
// Kernel A holds each output row in the distributed shared memory of one
// thread-block cluster: the row is cut into k slices of `slice` words, one
// per block of the cluster (k <= 8, the portable cluster size; the wrapper
// picks k and slice from sw, kernels/slide.cluster_shape). Each block
//   1. zero-fills its own slice in shared memory,
//   2. waits at a cluster barrier,
//   3. reads its slice of val and aux (16-byte loads when the row allows)
//      and stores each alive event into the slice of whichever block owns
//      i - dist (map_shared_rank: a store into that block's shared memory),
//   4. waits at a cluster barrier,
//   5. writes its slice out (16-byte stores when the row allows).
// Every output word is written exactly once and nothing is zero-filled in
// device memory, so the traffic is the bound's: read val and aux, write
// out, 12 B a slot (201.5 MB at the 4K shape (410, 40960)). Row and column
// come from the cluster and block indices, so there is no 64-bit division.
//
// Kernel D is a direct placement for two planes into zeroed outputs. In
// _compact_chunks an alive slot is a chunk start and its distance is (index
// in row) - (chunk rank in row), so destinations are again unique and
// increasing. Bound on the H100: memory traffic, 3 planes read and 2
// written, 20 B per slot (about 294 MB for a 4K mixed stream of ~14.7 M
// bytes).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlideThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxSlice = 48 * 1024 / 4;  // words: dynamic shared memory
                                          // without an opt-in

template <bool kVec>
__global__ void __launch_bounds__(kSlideThreads)
slide_val_cluster_kernel(const int32_t* __restrict__ val,
                         const int32_t* __restrict__ aux,
                         int32_t* __restrict__ out, int sw, int slice) {
  extern __shared__ int4 slice4[];
  int32_t* part = reinterpret_cast<int32_t*>(slice4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / cluster.num_blocks();
  const int c0 = rank * slice;
  const int len = max(0, min(slice, sw - c0));
  const size_t off = row * (size_t)sw + c0;

  for (int q = threadIdx.x; q < (slice + 3) / 4; q += blockDim.x)
    slice4[q] = make_int4(0, 0, 0, 0);
  cluster.sync();

  // column i of the row holds (a, v): land v at i - dist in its owner slice
  auto place = [&](int i, int a, int v) {
    if (a & 1) {
      const int dist = a >> 1;
      if (dist >= 0 && dist <= i) {
        const unsigned dst = (unsigned)(i - dist);
        const unsigned owner = dst / (unsigned)slice;
        cluster.map_shared_rank(part, owner)[dst - owner * slice] = v;
      }
    }
  };
  if (kVec) {
    // kUnroll 16-byte loads of each plane in flight before any placement
    const int4* a4 = reinterpret_cast<const int4*>(aux + off);
    const int4* v4 = reinterpret_cast<const int4*>(val + off);
    const int n4 = len / 4;
    for (int q0 = threadIdx.x; q0 < n4; q0 += kUnroll * kSlideThreads) {
      int4 a[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kSlideThreads;
        a[u] = q < n4 ? a4[q] : make_int4(0, 0, 0, 0);  // dead: not placed
        v[u] = q < n4 ? v4[q] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c0 + 4 * (q0 + u * kSlideThreads);
        place(i, a[u].x, v[u].x);
        place(i + 1, a[u].y, v[u].y);
        place(i + 2, a[u].z, v[u].z);
        place(i + 3, a[u].w, v[u].w);
      }
    }
  } else {
    for (int q = threadIdx.x; q < len; q += blockDim.x)
      place(c0 + q, aux[off + q], val[off + q]);
  }
  cluster.sync();

  if (kVec) {
    int4* o4 = reinterpret_cast<int4*>(out + off);
    for (int q = threadIdx.x; q < len / 4; q += blockDim.x) o4[q] = slice4[q];
  } else {
    for (int q = threadIdx.x; q < len; q += blockDim.x) out[off + q] = part[q];
  }
}

__global__ void slide_val2_kernel(const int32_t* __restrict__ val,
                                  const int32_t* __restrict__ val2,
                                  const int32_t* __restrict__ aux,
                                  int32_t* __restrict__ out,
                                  int32_t* __restrict__ out2,
                                  long long total, int sw) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int32_t a = aux[i];
    if (a & 1) {
      int32_t dist = a >> 1;
      if (dist <= (int32_t)(i % sw)) {
        out[i - dist] = val[i];
        out2[i - dist] = val2[i];
      }
    }
  }
}

long long grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return blocks > 65535LL * 16 ? 65535LL * 16 : blocks;  // grid-stride beyond
}

}  // namespace

// One cluster of k blocks a row; vec: sw and slice multiples of 4 and the
// planes 16-byte aligned (the wrapper checks).
extern "C" int qoi_slide_val(const void* val, const void* aux, void* out,
                             long long nseg, int sw, int k, int slice,
                             int vec, void* stream) {
  if (nseg <= 0 || sw <= 0) return 0;
  if (k < 1 || k > kMaxCluster || slice < 1 || slice > kMaxSlice ||
      (long long)k * slice < sw || nseg * k > 0x7FFFFFFFLL ||
      (vec && (sw % 4 || slice % 4)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nseg * k));
  cfg.blockDim = dim3(kSlideThreads);
  cfg.dynamicSmemBytes = (size_t)((slice + 3) / 4) * 16;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, slide_val_cluster_kernel<true>,
                               (const int32_t*)val, (const int32_t*)aux,
                               (int32_t*)out, sw, slice)
          : cudaLaunchKernelEx(&cfg, slide_val_cluster_kernel<false>,
                               (const int32_t*)val, (const int32_t*)aux,
                               (int32_t*)out, sw, slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int qoi_slide_val2(const void* val, const void* val2,
                              const void* aux, void* out, void* out2,
                              long long total, int sw, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  slide_val2_kernel<<<(unsigned)grid_for(total, threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)val, (const int32_t*)val2, (const int32_t*)aux,
      (int32_t*)out, (int32_t*)out2, total, sw);
  return (int)cudaGetLastError();
}
