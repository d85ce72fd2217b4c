// K2: batched patch gather.  out[n*K + k, i, j, c] = img[n, y(i), x(j), c]
// for N images of (H, W, C) and K windows of cut x cut per image.
//   mode gather: y(i) = clamp(oy + i, 0, H-1), x(j) = clamp(ox + j, 0, W-1)
//                (per-pixel clamp: out-of-bounds windows repeat edge pixels)
//   mode slice:  the window origin is clamped first, oy' = clamp(oy, 0, H-cut),
//                then copied as is (a whole-window shift)
//
// Replaces vts_tpu/ops/pallas_gather.py::gather_patches_pallas (slice mode,
// one image) and also covers what it skipped: the per-pixel clamp that the
// eval path uses (vts_tpu/ops/patch.py:63-70) and the (N, K) batched form.
//
// Bound on the H100: bytes, and at the eval path's size (K = 100 windows of
// 32 x 32 x 2 fp32, 800 KiB out) launch latency dominates both.
//
// Design: one block per (image, window).  The block reads its own offsets
// from the device int32 arrays (no host round trip), then copies the window
// row by row: consecutive threads take consecutive (column, channel) elements
// of a row, so each row is one contiguous cut*C run in the source and in the
// output.  It is a copy, so it is exact for any element type; the kernel
// moves raw 1/2/4/8-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ img, const int* __restrict__ off_x,
              const int* __restrict__ off_y, T* __restrict__ out,
              int K, int H, int W, int C, int cut, int slice_mode) {
  const int p = blockIdx.x;
  const int n = p / K;
  int ox = off_x[p];
  int oy = off_y[p];
  if (slice_mode) {
    ox = min(max(ox, 0), W - cut);
    oy = min(max(oy, 0), H - cut);
  }
  const T* src = img + (size_t)n * H * W * C;
  T* dst = out + (size_t)p * cut * cut * C;
  const int row = cut * C;
  const int total = cut * row;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int i = e / row;
    const int rem = e - i * row;
    const int j = rem / C;
    const int c = rem - j * C;
    const int yy = min(max(oy + i, 0), H - 1);
    const int xx = min(max(ox + j, 0), W - 1);
    dst[e] = src[((size_t)yy * W + xx) * C + c];
  }
}

template <typename T>
int launch(const void* img, const int* ox, const int* oy, void* out, int N, int K,
           int H, int W, int C, int cut, int slice_mode, cudaStream_t stream) {
  gather_kernel<T><<<N * K, THREADS, 0, stream>>>(
      static_cast<const T*>(img), ox, oy, static_cast<T*>(out), K, H, W, C, cut,
      slice_mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_patches(const void* img, const int* off_x, const int* off_y,
                              void* out, int N, int K, int H, int W, int C, int cut,
                              int slice_mode, int elem_size, cudaStream_t stream) {
  switch (elem_size) {
    case 1: return launch<uint8_t>(img, off_x, off_y, out, N, K, H, W, C, cut, slice_mode, stream);
    case 2: return launch<uint16_t>(img, off_x, off_y, out, N, K, H, W, C, cut, slice_mode, stream);
    case 4: return launch<uint32_t>(img, off_x, off_y, out, N, K, H, W, C, cut, slice_mode, stream);
    case 8: return launch<uint64_t>(img, off_x, off_y, out, N, K, H, W, C, cut, slice_mode, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
