// K1: 3x3 / stride 1 / pad 1 convolution + bias (+ ReLU) over NHWC, fp32
// accumulation, fp32 and bf16 storage; and its input gradient (dx), fp32.
//
// Replaces vts_tpu/ops/pallas_conv.py::_pallas_conv3x3 (public conv3x3_relu),
// the fused conv of the LPIPS VGG16 blocks 1-2, forward and backward.  It runs
// conv1_2 (64->64), conv2_1 (64->128) and conv2_2 (128->128): on the eval path
// at the 1536^2 canvas and on 2*K 224^2 tactile patches; on the training path
// at the 1536^2 canvas and on 2*K 32^2 patches, where dx carries the canvas
// and patch LPIPS gradients back through the same three convs.
//
// The backward is the same convolution, as pallas_conv.py:119-127 launches the
// same Pallas kernel for it:
//
//   g       = relu ? gy * [y > 0] : gy              (the ReLU mask, from the saved output)
//   dx[c]   = sum_{dy,dx,k} g[h+dy-1, w+dx-1, k] * w[2-dy][2-dx][c][k]
//
// i.e. a 3x3 conv of g with the forward weight flipped in space and
// transposed in/out, with no bias and no ReLU.
//
// Bound on the H100: operations.  A 64->64 conv does 2*9*64 = 1152 FLOPs per
// output value against ~512 bytes moved per output pixel, so in fp32 on the
// CUDA cores (67 TFLOP/s) it is compute bound by two orders of magnitude; dx
// moves ~4*(2*Co + C) bytes per pixel for the same FLOPs.
//
// Design: a direct convolution as a register-tiled implicit GEMM on the CUDA
// cores, one template for both directions.  A block owns an 8 x 16 pixel tile
// and 64 output channels.  It walks the input channels in chunks of 8: it
// stages the (8+2) x (16+2) x 8 input halo (zero outside the image, so any H,
// W, C works: no padding pass) and the 9 x 8 x 64 weight slice in shared
// memory, then each thread accumulates 8 pixels x 4 output channels in
// registers.  Per (channel, kernel row) a thread loads 10 inputs and 3 float4
// weights for 96 FMAs.  The direction only changes the two load stages and the
// epilogue:
//   forward  halo x;           weight w[tap][ci][co];        bias (+ ReLU)
//   dx       halo gy*[y > 0];  weight w[8-tap][co][ci];      neither
// so the mask costs no pass of its own and no flipped or transposed weight
// copy is made.  Batches larger than the grid's z limit are launched in
// chunks.  No tensor cores (wgmma/TMA) yet: the kernel keeps full fp32
// arithmetic so it matches the fp32 reference; a faster version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 16;         // output cols per block
constexpr int TCO = 64;        // output channels per block
constexpr int CK = 8;          // input channels per shared-memory stage
constexpr int HH = TH + 2;
constexpr int HW = TW + 2;
constexpr int PX = 8;          // output cols per thread
constexpr int PC = 4;          // output channels per thread
constexpr int THREADS = (TH * TW / PX) * (TCO / PC);   // 256
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// in: (N, H, W, Ci); out: (N, H, W, Co).  Forward (DX false): in = x,
// w (3, 3, Ci, Co) HWIO, out = relu?(conv + bias).  DX: in = gy with Ci the
// forward's output channels, mask = the saved forward output y (read when
// relu), w the forward's (3, 3, Co, Ci) HWIO weight, out = dx.
template <typename T, bool DX>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ in, const T* __restrict__ mask,
               const T* __restrict__ w, const float* __restrict__ bias,
               T* __restrict__ out, int H, int W, int Ci, int Co, int co_tiles,
               int relu) {
  __shared__ float s_in[CK][HH][HW];
  __shared__ __align__(16) float s_w[9][CK][TCO];

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * TCO;
  const int cg = tid % (TCO / PC);      // 4 output channels: cg*4 .. cg*4+3
  const int pg = tid / (TCO / PC);      // 8 output pixels of one row
  const int r = pg / (TW / PX);
  const int c0 = (pg % (TW / PX)) * PX;

  const size_t img = (size_t)n * H * W * Ci;
  const T* inn = in + img;
  float acc[PX][PC];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[j][k] = 0.f;

  for (int cb = 0; cb < Ci; cb += CK) {
    for (int i = tid; i < CK * HH * HW; i += THREADS) {
      const int ci = i % CK;
      const int p = i / CK;
      const int hx = p % HW;
      const int hy = p / HW;
      const int gh = h0 - 1 + hy, gw = w0 - 1 + hx, gc = cb + ci;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < Ci) {
        const size_t off = ((size_t)gh * W + gw) * Ci + gc;
        v = to_float(inn[off]);
        if (DX && relu && !(to_float(mask[img + off]) > 0.f)) v = 0.f;
      }
      s_in[ci][hy][hx] = v;
    }
    for (int i = tid; i < 9 * CK * TCO; i += THREADS) {
      const int co = i % TCO;
      const int q = i / TCO;
      const int ci = q % CK;
      const int tap = q / CK;
      const int gc = cb + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < Ci && gco < Co)
        v = to_float(DX ? w[((size_t)(8 - tap) * Co + gco) * Ci + gc]   // flipped, transposed
                        : w[((size_t)tap * Ci + gc) * Co + gco]);
      s_w[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) a[j] = s_in[ci][r + dy][c0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][ci][cg * PC]);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            acc[j][0] = fmaf(a[j + dx], wv.x, acc[j][0]);
            acc[j][1] = fmaf(a[j + dx], wv.y, acc[j][1]);
            acc[j][2] = fmaf(a[j + dx], wv.z, acc[j][2]);
            acc[j][3] = fmaf(a[j + dx], wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oh = h0 + r;
  if (oh >= H) return;
  const int cob = co0 + cg * PC;
  float bv[PC];
#pragma unroll
  for (int k = 0; k < PC; ++k) bv[k] = (!DX && cob + k < Co) ? bias[cob + k] : 0.f;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ow = w0 + c0 + j;
    if (ow >= W) break;
    T* o = out + (((size_t)n * H + oh) * W + ow) * Co + cob;
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      if (cob + k < Co) {
        float v = acc[j][k] + bv[k];
        if (!DX && relu) v = fmaxf(v, 0.f);
        store(o + k, v);
      }
    }
  }
}

template <typename T, bool DX>
int launch(const T* in, const T* mask, const T* w, const float* b, T* out, int N,
           int H, int W, int Ci, int Co, int relu, cudaStream_t stream) {
  const int co_tiles = (Co + TCO - 1) / TCO;
  const int n_chunk = MAX_GRID_Z / co_tiles;
  if (n_chunk < 1) return (int)cudaErrorInvalidConfiguration;
  for (int n0 = 0; n0 < N; n0 += n_chunk) {
    const int nn = N - n0 < n_chunk ? N - n0 : n_chunk;
    const size_t in_off = (size_t)n0 * H * W * Ci;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (unsigned)(nn * co_tiles));
    conv3x3_kernel<T, DX><<<grid, THREADS, 0, stream>>>(
        in + in_off, DX ? mask + in_off : mask, w, b, out + (size_t)n0 * H * W * Co,
        H, W, Ci, Co, co_tiles, relu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int conv3x3_bias_relu_f32(const float* x, const float* w, const float* b,
                                     float* y, int N, int H, int W, int C, int Co,
                                     int relu, cudaStream_t stream) {
  return launch<float, false>(x, nullptr, w, b, y, N, H, W, C, Co, relu, stream);
}

extern "C" int conv3x3_bias_relu_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                      const float* b, __nv_bfloat16* y, int N, int H,
                                      int W, int C, int Co, int relu, cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(x, nullptr, w, b, y, N, H, W, C, Co, relu, stream);
}

// gy, y: (N, H, W, K) with K the forward's output channels; w: (3, 3, C, K)
// the forward HWIO weight; dx: (N, H, W, C).
extern "C" int conv3x3_dx_f32(const float* gy, const float* y, const float* w, float* dx,
                              int N, int H, int W, int C, int K, int relu,
                              cudaStream_t stream) {
  return launch<float, true>(gy, y, w, nullptr, dx, N, H, W, K, C, relu, stream);
}
