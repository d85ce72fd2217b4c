// K2 backward: scatter-add of patch cotangents into an image-sized canvas,
// the transpose of the batched patch gather of gather_patches.cu.  Two
// instances: fp32 in and out, and bf16 in and out (the --dtype bfloat16
// step), which sums in fp32 and rounds each canvas element once.
//
//   canvas[n, y(i), x(j), c] = sum over k, i, j of g[n*K + k, i, j, c]
//
// with the forward's index maps:
//   mode gather: y(i) = clamp(oy + i, 0, H-1), x(j) = clamp(ox + j, 0, W-1)
//   mode slice:  the window origin is clamped first, oy' = clamp(oy, 0, H-cut)
// so overlapping windows and the edge pixels that out-of-bounds windows
// repeat all accumulate.  The origins come from int32 offsets or from the
// packed coords, decoded as in the forward (patch_windows.cuh).
//
// Replaces what the JAX package leaves to XLA: the transpose of the gather in
// vts_tpu/ops/patch.py:41-71 (a scatter-add), through which the G2 L1 and
// LPIPS gradients reach fake_T (vts_tpu/models/sinskit.py:867-887).
//
// Bound on the H100: bytes, one write of the canvas (at 1536^2 x 2 fp32,
// 18.9 MB; half that in bf16) against 0.5 MB of patch cotangents at K = 64
// windows of 32^2 x 2.
//
// Design: each block owns a 32 x 32-pixel tile of one image's canvas, all
// channels, and writes every element of it exactly once, so there is no
// zero fill and no atomic.  The block decodes the image's K window origins
// and keeps, in ascending k, those whose footprint meets its tile (a warp
// ballot and a prefix sum over the warps); in gather mode a footprint
// includes the edge rows and columns that a clamped window repeats.  A tile
// that no window meets is stored as zeros in 16-byte vectors (most tiles:
// that part runs at the rate of a plain fill).  Otherwise each thread owns 4
// pixels of the tile, consecutive threads on consecutive columns, and sums
// 2 channels of them at a time in registers, in a fixed order: window
// k ascending, then row i, then column j.  An interior pixel takes at most
// one (i, j) of a window; an edge pixel the whole range of window rows or
// columns that clamp onto it.  The windows are the outer loop, so the loads
// of one window for all of a thread's elements are in flight together; a
// tile that many windows overlap still takes one load latency per window.
// The order is that of a serial index_put_(accumulate=True) over the
// gather's index tensor, so the result is the same bit for bit from run to
// run and equals that serial sum (in bf16: that fp32 sum, rounded once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_windows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;
constexpr int PIX = TILE * TILE / THREADS;   // pixels a thread owns
constexpr int CG = 2;                        // channels a thread sums at a time

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_tile_kernel(const T* __restrict__ g, Windows win, T* __restrict__ canvas,
                    int K, int H, int W, int C, int cut, int slice_mode) {
  extern __shared__ int hits[];           // 3 x K: window, origin x, origin y
  int* hit_k = hits;
  int* hit_x = hits + K;
  int* hit_y = hits + 2 * K;
  __shared__ int warp_hits[WARPS];
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int tw = min(TILE, W - x0);
  const int th = min(TILE, H - y0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the windows that meet the tile, in ascending k (nhit is the same in every thread)
  int nhit = 0;
  for (int base = 0; base < K; base += THREADS) {
    const int k = base + threadIdx.x;
    bool hit = false;
    int ox = 0, oy = 0;
    if (k < K) {
      window_origin(win, n * K + k, ox, oy);
      clamp_origin(ox, oy, H, W, cut, slice_mode);
      hit = clampi(oy, 0, H - 1) < y0 + th && clampi(oy + cut - 1, 0, H - 1) >= y0 &&
            clampi(ox, 0, W - 1) < x0 + tw && clampi(ox + cut - 1, 0, W - 1) >= x0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int slot = nhit + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) slot += warp_hits[w];
      nhit += warp_hits[w];
    }
    if (hit) {
      hit_k[slot] = k;
      hit_x[slot] = ox;
      hit_y[slot] = oy;
    }
    __syncthreads();
  }

  T* dst = canvas + (size_t)n * H * W * C;
  const int rowe = tw * C;                  // elements in one tile row
  if (nhit == 0) {
    constexpr int VEC = 16 / sizeof(T);     // elements in one 16-byte store
    if ((W * C) % VEC == 0 && (reinterpret_cast<uintptr_t>(canvas) & 15) == 0) {
      const int rowv = rowe / VEC;
      for (int e = threadIdx.x; e < th * rowv; e += THREADS) {
        const int r = e / rowv;
        T* p = dst + ((size_t)(y0 + r) * W + x0) * C;
        reinterpret_cast<uint4*>(p)[e - r * rowv] = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = threadIdx.x; e < th * rowe; e += THREADS) {
        const int r = e / rowe;
        dst[((size_t)(y0 + r) * W + x0) * C + (e - r * rowe)] = narrow<T>(0.f);
      }
    }
    return;
  }

  // Each thread owns PIX pixels of the tile (consecutive threads on
  // consecutive columns) and up to CG channels of them at a time, in
  // registers.  Windows are the outer loop, so the loads of one window for
  // all of a thread's elements are independent and in flight together.
  const T* gn = g + (size_t)n * K * cut * cut * C;
  for (int c0 = 0; c0 < C; c0 += CG) {
    float acc[PIX][CG];
#pragma unroll
    for (int p = 0; p < PIX; ++p)
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[p][c] = 0.f;
    for (int h = 0; h < nhit; ++h) {
      const int oy = hit_y[h], ox = hit_x[h];
      const T* gk = gn + (size_t)hit_k[h] * cut * cut * C + c0;
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const int pix = threadIdx.x + p * THREADS;
        const int y = y0 + pix / TILE;
        const int x = x0 + pix % TILE;
        // the window rows i with clamp(oy + i, 0, H-1) == y, and the columns likewise
        int ilo = y - oy, ihi = ilo;
        if (y == 0) ilo = 0;
        if (y == H - 1) ihi = cut - 1;
        ilo = max(ilo, 0);
        ihi = min(ihi, cut - 1);
        int jlo = x - ox, jhi = jlo;
        if (x == 0) jlo = 0;
        if (x == W - 1) jhi = cut - 1;
        jlo = max(jlo, 0);
        jhi = min(jhi, cut - 1);
        if (y >= y0 + th || x >= x0 + tw || ilo > ihi || jlo > jhi) continue;
        if (ilo == ihi && jlo == jhi) {             // an interior pixel: one term
          const T* t = gk + ((size_t)ilo * cut + jlo) * C;
#pragma unroll
          for (int c = 0; c < CG; ++c)
            if (c0 + c < C) acc[p][c] += widen(t[c]);
        } else {                                    // an edge pixel of a clamped window
          for (int i = ilo; i <= ihi; ++i)
            for (int j = jlo; j <= jhi; ++j) {
              const T* t = gk + ((size_t)i * cut + j) * C;
#pragma unroll
              for (int c = 0; c < CG; ++c)
                if (c0 + c < C) acc[p][c] += widen(t[c]);
            }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const int pix = threadIdx.x + p * THREADS;
      const int y = y0 + pix / TILE;
      const int x = x0 + pix % TILE;
      if (y >= y0 + th || x >= x0 + tw) continue;
      T* d = dst + ((size_t)y * W + x) * C + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c0 + c < C) d[c] = narrow<T>(acc[p][c]);
    }
  }
}

template <typename T>
int launch_scatter(const T* g, const int* off_x, const int* off_y, const float* coords, int mult,
                   T* canvas, int N, int K, int H, int W, int C, int cut, int slice_mode,
                   cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K < 0 || cut <= 0 || cut > H || cut > W ||
      (K > 0 && off_x == nullptr && coords == nullptr))
    return (int)cudaErrorInvalidValue;
  const Windows win = {off_x, off_y, off_x == nullptr ? coords : nullptr, (float)mult};
  const size_t smem = (size_t)3 * K * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((W + TILE - 1) / TILE), (unsigned)((H + TILE - 1) / TILE),
                  (unsigned)N);
  scatter_tile_kernel<T><<<grid, THREADS, smem, stream>>>(g, win, canvas, K, H, W, C, cut,
                                                         slice_mode);
  return (int)cudaGetLastError();
}

}  // namespace

// g (N*K, cut, cut, C) → canvas (N, H, W, C), every element written; both
// fp32, or both bf16 (summed in fp32, rounded once).  The windows are
// off_x/off_y, or coords with mult when off_x is null.  Return a CUDA error code.
extern "C" int scatter_patches_f32(const float* g, const int* off_x, const int* off_y,
                                   const float* coords, int mult, float* canvas, int N, int K,
                                   int H, int W, int C, int cut, int slice_mode,
                                   cudaStream_t stream) {
  return launch_scatter(g, off_x, off_y, coords, mult, canvas, N, K, H, W, C, cut, slice_mode,
                        stream);
}

extern "C" int scatter_patches_bf16(const __nv_bfloat16* g, const int* off_x, const int* off_y,
                                    const float* coords, int mult, __nv_bfloat16* canvas, int N,
                                    int K, int H, int W, int C, int cut, int slice_mode,
                                    cudaStream_t stream) {
  return launch_scatter(g, off_x, off_y, coords, mult, canvas, N, K, H, W, C, cut, slice_mode,
                        stream);
}
