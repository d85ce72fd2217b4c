// K2: grouped batched patch gather.  For each source s of a group of up to 4
// images that share N, H, W, the cutout and the windows:
//   out_s[n*K + k, i, j, c] = img_s[n, y(i), x(j), c],   c < C_s
//   mode gather: y(i) = clamp(oy + i, 0, H-1), x(j) = clamp(ox + j, 0, W-1)
//                (per-pixel clamp: out-of-bounds windows repeat edge pixels)
//   mode slice:  the window origin is clamped first, oy' = clamp(oy, 0, H-cut),
//                then copied as is (a whole-window shift)
// The origins come from int32 offsets or are decoded from the packed coords
// in the kernel (patch_windows.cuh), so the host computes nothing per call.
//
// Replaces vts_tpu/ops/pallas_gather.py::gather_patches_pallas (slice mode,
// one image) and also covers what it skipped: the per-pixel clamp that the
// eval path uses (vts_tpu/ops/patch.py:63-70) and the (N, K) batched form.
//
// Bound on the H100: bytes, and far below a microsecond at the main path's
// sizes (K = 64 windows of 32 x 32 x 1-3 fp32 per source), so what costs is
// the launch and its host wrapper.  The design cuts launches: one launch
// serves every source of a group (the training step gathers 4 images at the
// batch's coords and 3 at the "more fake T" offsets), and the offsets need
// no host-side ops.
//
// Design: a grid over (window, row part) x source.  Where windows x sources
// would leave SMs idle, a window's rows are split over several blocks.
// Consecutive threads take consecutive elements of a window row (cut*C
// contiguous elements in the output, and in the source where the window is
// in bounds).  Each thread reads 16 bytes' worth of elements at the
// source's own alignment and stores them as one 16-byte vector where the
// output row allows it, else element by element.  It is a copy, so it is
// exact for any element type; the kernel moves raw 1/2/4/8-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_windows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SRC = 4;

struct Group {
  const void* img[MAX_SRC];
  void* out[MAX_SRC];
  int C[MAX_SRC];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_group_kernel(Group grp, Windows win, int K, int H, int W, int cut, int slice_mode,
                    int splits) {
  constexpr int V = 16 / sizeof(T);
  const int p = blockIdx.x / splits;            // window n*K + k
  const int part = blockIdx.x - p * splits;     // which rows of it
  const int s = blockIdx.y;                     // source
  const int n = p / K;
  int ox, oy;
  window_origin(win, p, ox, oy);
  clamp_origin(ox, oy, H, W, cut, slice_mode);
  // this block's source, picked with constant indices so that the group
  // stays in the parameter space (an index by s would copy it to the stack)
  const void* img = grp.img[0];
  void* out = grp.out[0];
  int C = grp.C[0];
#pragma unroll
  for (int t = 1; t < MAX_SRC; ++t) {
    if (s == t) {
      img = grp.img[t];
      out = grp.out[t];
      C = grp.C[t];
    }
  }
  const T* src = static_cast<const T*>(img) + (size_t)n * H * W * C;
  T* dst = static_cast<T*>(out) + (size_t)p * cut * cut * C;
  const int rows = (cut + splits - 1) / splits;
  const int i0 = part * rows;
  const int i1 = min(cut, i0 + rows);
  const int row = cut * C;
  if (row % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vrow = row / V;
    const int total = (i1 - i0) * vrow;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int di = e / vrow;
      const int q = (e - di * vrow) * V;      // first element of the vector in the row
      const int i = i0 + di;
      const T* srow = src + (size_t)clampi(oy + i, 0, H - 1) * W * C;
      int j = q / C;
      int c = q - j * C;
      union {
        uint4 v;
        T w[V];
      } pack;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        pack.w[u] = srow[clampi(ox + j, 0, W - 1) * C + c];
        if (++c == C) {
          c = 0;
          ++j;
        }
      }
      reinterpret_cast<uint4*>(dst + (size_t)i * row)[q / V] = pack.v;
    }
  } else {
    const int total = (i1 - i0) * row;
    for (int e = threadIdx.x; e < total; e += THREADS) {
      const int di = e / row;
      const int q = e - di * row;
      const int i = i0 + di;
      const int j = q / C;
      const int c = q - j * C;
      dst[(size_t)i * row + q] =
          src[((size_t)clampi(oy + i, 0, H - 1) * W + clampi(ox + j, 0, W - 1)) * C + c];
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 132;
  return cached[dev];
}

template <typename T>
int launch(const Group& grp, int nsrc, const Windows& win, int N, int K, int H, int W,
           int cut, int slice_mode, cudaStream_t stream) {
  // split a window's rows until the grid covers the SMs (at most one row a block)
  const long long blocks = (long long)N * K * nsrc;
  const int sms = sm_count();
  int splits = 1;
  while (blocks * splits < sms && splits * 2 <= cut) splits *= 2;
  const dim3 grid((unsigned)(N * K * splits), (unsigned)nsrc);
  gather_group_kernel<T><<<grid, THREADS, 0, stream>>>(grp, win, K, H, W, cut, slice_mode,
                                                       splits);
  return (int)cudaGetLastError();
}

}  // namespace

// img*/out*/c* for sources 0..nsrc-1 (the rest are ignored); the windows are
// off_x/off_y, or coords with mult when off_x is null.  Returns a CUDA error code.
extern "C" int gather_patches_group(const void* img0, const void* img1, const void* img2,
                                    const void* img3, void* out0, void* out1, void* out2,
                                    void* out3, int c0, int c1, int c2, int c3, int nsrc,
                                    const int* off_x, const int* off_y, const float* coords,
                                    int mult, int N, int K, int H, int W, int cut,
                                    int slice_mode, int elem_size, cudaStream_t stream) {
  if (nsrc < 1 || nsrc > MAX_SRC || N * K <= 0 || cut <= 0 || cut > H || cut > W ||
      (off_x == nullptr && coords == nullptr))
    return (int)cudaErrorInvalidValue;
  const Group grp = {{img0, img1, img2, img3}, {out0, out1, out2, out3}, {c0, c1, c2, c3}};
  const Windows win = {off_x, off_y, off_x == nullptr ? coords : nullptr, (float)mult};
  switch (elem_size) {
    case 1: return launch<uint8_t>(grp, nsrc, win, N, K, H, W, cut, slice_mode, stream);
    case 2: return launch<uint16_t>(grp, nsrc, win, N, K, H, W, cut, slice_mode, stream);
    case 4: return launch<uint32_t>(grp, nsrc, win, N, K, H, W, cut, slice_mode, stream);
    case 8: return launch<uint64_t>(grp, nsrc, win, N, K, H, W, cut, slice_mode, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
