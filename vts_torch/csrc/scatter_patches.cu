// K2 backward: scatter-add of patch cotangents into an image-sized canvas,
// the transpose of the batched patch gather of gather_patches.cu.
//
//   canvas[n, y(i), x(j), c] += g[n*K + k, i, j, c]   for every window k
//
// with the forward's index maps:
//   mode gather: y(i) = clamp(oy + i, 0, H-1), x(j) = clamp(ox + j, 0, W-1)
//   mode slice:  the window origin is clamped first, oy' = clamp(oy, 0, H-cut)
// so overlapping windows and the edge pixels that out-of-bounds windows
// repeat all accumulate.
//
// Replaces what the JAX package leaves to XLA: the transpose of the gather in
// vts_tpu/ops/patch.py:41-71 (a scatter-add), through which the G2 L1 and
// LPIPS gradients reach fake_T (vts_tpu/models/sinskit.py:867-887).
//
// Bound on the H100: bytes.  The canvas is zeroed first (cudaMemsetAsync on
// the same stream): at 1536^2 x 2 fp32 that fill is 18.9 MB, against 0.5 MB
// of patch cotangents at K = 64 windows of 32^2 x 2, so the fill dominates.
//
// Design: one block per window.  The block reads its own offsets from the
// device int32 arrays (no host round trip), then walks the window's
// cut*cut*C elements with consecutive threads on consecutive (column,
// channel) elements, reading the cotangent once and atomicAdd-ing fp32 into
// the canvas.  The atomics make the order of the additions vary from run to
// run, so the result is not bit-reproducible where windows overlap; the
// tests state a tolerance for that.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const float* __restrict__ g, const int* __restrict__ off_x,
               const int* __restrict__ off_y, float* __restrict__ canvas,
               int K, int H, int W, int C, int cut, int slice_mode) {
  const int p = blockIdx.x;
  const int n = p / K;
  int ox = off_x[p];
  int oy = off_y[p];
  if (slice_mode) {
    ox = min(max(ox, 0), W - cut);
    oy = min(max(oy, 0), H - cut);
  }
  float* dst = canvas + (size_t)n * H * W * C;
  const float* src = g + (size_t)p * cut * cut * C;
  const int row = cut * C;
  const int total = cut * row;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int i = e / row;
    const int rem = e - i * row;
    const int j = rem / C;
    const int c = rem - j * C;
    const int yy = min(max(oy + i, 0), H - 1);
    const int xx = min(max(ox + j, 0), W - 1);
    atomicAdd(&dst[((size_t)yy * W + xx) * C + c], src[e]);
  }
}

}  // namespace

extern "C" int scatter_patches_f32(const float* g, const int* off_x, const int* off_y,
                                   float* canvas, int N, int K, int H, int W, int C,
                                   int cut, int slice_mode, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(canvas, 0, (size_t)N * H * W * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (N * K == 0) return 0;
  scatter_kernel<<<N * K, THREADS, 0, stream>>>(g, off_x, off_y, canvas, K, H, W, C, cut,
                                                slice_mode);
  return (int)cudaGetLastError();
}
