// Window origins shared by K2 (gather_patches.cu) and K2 bwd
// (scatter_patches.cu).  A window is given either by int32 top-left corners
// (off_x, off_y, one per window) or by the data's packed fp32 coords, 8 per
// window: (ROI_x, ROI_y, ., ., cutout, resize_ratio, crop_x, crop_y).  From
// coords the origin is decoded here, in the kernel, as patch_offsets does it
// on the host (vts_torch/ops/patch.py, vts_tpu/ops/patch.py:32-38):
//   off = round_half_even((c0 + c6 / c5) * mult)
// with every fp32 operation rounded to nearest and none fused, so the
// decoded origins, and the patches cut at them, are bit-exact.  The rounding
// and the conversion to int are one __float2int_rn: half to even, NaN (which
// the all-zero coords of a padded patch give) to 0 and out-of-range values
// saturated, as XLA converts.
#pragma once
#include <cuda_runtime.h>

struct Windows {
  const int* off_x;      // (N*K) int32, or null when coords is given
  const int* off_y;
  const float* coords;   // (N*K, 8) fp32, or null
  float mult;            // the scale multiplier, an integer
};

__device__ __forceinline__ void window_origin(const Windows& w, int p, int& ox, int& oy) {
  if (w.coords != nullptr) {
    const float* c = w.coords + (size_t)p * 8;
    ox = __float2int_rn(__fmul_rn(__fadd_rn(c[0], __fdiv_rn(c[6], c[5])), w.mult));
    oy = __float2int_rn(__fmul_rn(__fadd_rn(c[1], __fdiv_rn(c[7], c[5])), w.mult));
  } else {
    ox = w.off_x[p];
    oy = w.off_y[p];
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Slice mode clamps the origin into the image.  Gather mode clamps every
// pixel; an origin clamped to [-cut, W] (and [-cut, H]) cuts the same pixels
// and keeps origin + index from overflowing.
__device__ __forceinline__ void clamp_origin(int& ox, int& oy, int H, int W, int cut,
                                             int slice_mode) {
  if (slice_mode) {
    ox = clampi(ox, 0, W - cut);
    oy = clampi(oy, 0, H - cut);
  } else {
    ox = clampi(ox, -cut, W);
    oy = clampi(oy, -cut, H);
  }
}
