// K1: 3x3 / stride 1 / pad 1 convolution + bias (+ ReLU) over NHWC, fp32
// accumulation.  fp32 and bf16 storage.
//
// Replaces vts_tpu/ops/pallas_conv.py::_pallas_conv3x3 (public conv3x3_relu),
// the fused conv of the LPIPS VGG16 blocks 1-2.  On the eval path it runs
// conv1_2 (64->64), conv2_1 (64->128) and conv2_2 (128->128): at the 1536^2
// canvas and on 2*K 224^2 tactile patches.
//
// Bound on the H100: operations.  A 64->64 conv does 2*9*64 = 1152 FLOPs per
// output value against ~512 bytes moved per output pixel, so in fp32 on the
// CUDA cores (67 TFLOP/s) it is compute bound by two orders of magnitude.
//
// Design: a direct convolution as a register-tiled implicit GEMM on the CUDA
// cores.  A block owns an 8 x 16 pixel tile and 64 output channels.  It walks
// the input channels in chunks of 8: it stages the (8+2) x (16+2) x 8 input
// halo (zero outside the image, so any H, W, C works: no padding pass) and the
// 9 x 8 x 64 weight slice in shared memory, then each thread accumulates
// 8 pixels x 4 output channels in registers.  Per (channel, kernel row) a
// thread loads 10 inputs and 3 float4 weights for 96 FMAs.  Bias and ReLU are
// applied in the epilogue.  No tensor cores (wgmma/TMA) yet: the kernel keeps
// full fp32 arithmetic so it matches the fp32 reference; a faster version is
// later work.
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y,
               int H, int W, int C, int Co, int co_tiles, int relu) {
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

  const T* xn = x + (size_t)n * H * W * C;
  float acc[PX][PC];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[j][k] = 0.f;

  for (int cb = 0; cb < C; cb += CK) {
    for (int i = tid; i < CK * HH * HW; i += THREADS) {
      const int ci = i % CK;
      const int p = i / CK;
      const int hx = p % HW;
      const int hy = p / HW;
      const int gh = h0 - 1 + hy, gw = w0 - 1 + hx, gc = cb + ci;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C)
        v = to_float(xn[((size_t)gh * W + gw) * C + gc]);
      s_in[ci][hy][hx] = v;
    }
    for (int i = tid; i < 9 * CK * TCO; i += THREADS) {
      const int co = i % TCO;
      const int q = i / TCO;
      const int ci = q % CK;
      const int tap = q / CK;
      const int gc = cb + ci, gco = co0 + co;
      float v = 0.f;
      if (gc < C && gco < Co) v = to_float(w[((size_t)tap * C + gc) * Co + gco]);
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
  for (int k = 0; k < PC; ++k) bv[k] = (cob + k < Co) ? bias[cob + k] : 0.f;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ow = w0 + c0 + j;
    if (ow >= W) break;
    T* out = y + (((size_t)n * H + oh) * W + ow) * Co + cob;
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      if (cob + k < Co) {
        float v = acc[j][k] + bv[k];
        if (relu) v = fmaxf(v, 0.f);
        store(out + k, v);
      }
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, const float* b, T* y, int N, int H, int W,
           int C, int Co, int relu, cudaStream_t stream) {
  const int co_tiles = (Co + TCO - 1) / TCO;
  const long long gz = (long long)N * co_tiles;
  if (gz > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (unsigned)gz);
  conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(x, w, b, y, H, W, C, Co, co_tiles, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_bias_relu_f32(const float* x, const float* w, const float* b,
                                     float* y, int N, int H, int W, int C, int Co,
                                     int relu, cudaStream_t stream) {
  return launch<float>(x, w, b, y, N, H, W, C, Co, relu, stream);
}

extern "C" int conv3x3_bias_relu_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                      const float* b, __nv_bfloat16* y, int N, int H,
                                      int W, int C, int Co, int relu, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, w, b, y, N, H, W, C, Co, relu, stream);
}
