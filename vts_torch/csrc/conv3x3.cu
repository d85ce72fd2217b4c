// K1: 3x3 / stride 1 / pad 1 convolution + bias (+ ReLU) over NHWC, and its
// input gradient (dx).
//
// Replaces vts_tpu/ops/pallas_conv.py::_pallas_conv3x3 (public conv3x3_relu),
// the fused conv of the LPIPS VGG16 blocks 1-2, forward and backward.  It runs
// conv1_2 (64->64), conv2_1 (64->128) and conv2_2 (128->128): on the eval path
// at the 1536^2 canvas and on 2*K 224^2 tactile patches; on the training path
// at the 1536^2 canvas and on 2*K 32^2 patches, where dx carries the canvas
// and patch LPIPS gradients back through the same three convs.  The backward
// is the same convolution, as pallas_conv.py:119-127 launches the same Pallas
// kernel for it:
//
//   g       = relu ? gy * [y > 0] : gy              (the ReLU mask, from the saved output)
//   dx[c]   = sum_{dy,dx,k} g[h+dy-1, w+dx-1, k] * w[2-dy][2-dx][c][k]
//
// Bound on the H100: operations.  A 64->64 conv does 2*9*64 = 1152 FLOPs per
// output value against ~512 bytes moved per output pixel.  The fp32 path runs
// on the TF32 tensor cores in three passes ("3xTF32"), so its bound is
// 3 * FLOPs / 495 TFLOP/s: 1.05 ms of operations against 0.36 ms of bytes at
// the 1536^2 64->64 shape.
//
// Why three passes.  The port holds K1 to 1e-4 * max|ref| + 1e-5 against the
// exact fp32 product, and the 256^2 training step to 1e-4 of each gradient
// leaf's max.  One TF32 pass (operands cut to 10 mantissa bits) misses that
// limit by 7-9x on the path's convs; splitting each operand a = hi + lo, with
// hi = cvt.rna.tf32(a) and lo = a - hi (exact in fp32), and summing
// lo*hi + hi*lo + hi*hi in fp32 lands at ~0.003 of it, as plain fp32 does
// (tests/test_torch_port_conv_split.py emulates these products on the CPU).
// lo*lo is left out; the tensor core reads the top 19 bits of each word, so
// lo is cut to tf32 on its way in.  The tensor cores also round their fp32
// sums toward zero: one accumulator carried over all of K (9 taps x C)
// shrank the outputs by a few 1e-6 relative on the H100, a bias that adds
// up in a weight gradient summed over pixels (the 256^2 CUDA-vs-CPU
// training step failed G's down2 weight at 1.6x its limit).  So the 27
// wgmmas of one 8-channel chunk sum into a fresh fragment, the small terms
// first, and the chunks are added in registers with fp32 adds that round
// to nearest; chip_smoke.py holds the bias against an fp64 reference under
// 1e-6 and the error under 0.05 of the limit.
//
// Design: an implicit GEMM over the nine taps, transposed so that both
// operands come from shared memory through wgmma descriptors:
//   D[co][pixel] += sum_{tap, k} Wt[tap][co][k] * X[pixel + tap][k]
// M = 64 output channels per warpgroup (A = the weight, K-major), N = the
// 128 pixels of an 8-column x 16-row tile (B = the input halo, K-major as
// NHWC already is), K = the input channels, 8 per step (one tf32 wgmma
// depth).
// The halo of a chunk of 8 channels is stored as [k half][row][col][4 ch]:
// each tile row is one 8-row core matrix of B, so the nine taps are nine
// shifts of the B descriptor's start address inside one halo, and a tap
// costs no data movement at all.
// - Block: two warpgroups (256 threads).  An output with more than 64
//   channels gives each warpgroup its own 64 channels of one 8 x 16 tile
//   (WGM = 2); otherwise both share the weights and take side-by-side 8 x 16
//   tiles of one 18-column x 18-row halo (WGN = 2).  wgmma m64n128k8: the
//   chunk's fragment and the running sum take 2 x 64 registers a thread
//   (at n256 the two alone would need all 255).
// - Weights: a pre-pass kernel (conv3x3_split_weights) writes them once per
//   call, split into hi and lo, zero-padded to 8-channel chunks and 64-row
//   tiles, in the core-matrix order the A descriptor reads.  It also does the
//   transpose: the forward's HWIO weight has Co contiguous, while tf32 wgmma
//   takes A only K-major; dx reads w[8-tap][c][k], flipped and transposed.
// - Loads: cp.async (16 bytes when C % 4 == 0 and aligned, else 4) with zero
//   fill for the pad of 1 and the channel tail, into a ring of two slots:
//   chunk c+1 (its weights and halo) lands while chunk c multiplies.  Route
//   chosen over TMA because every thread copies and computes (no producer
//   warp), the completion is cp.async.wait_group + one barrier, and the zero
//   fill handles any H, W, C with no tensor map.
// - Split: after a chunk lands, the threads split its halo in place (hi) and
//   into one lo buffer, applying dx's ReLU mask gy * [y > 0] in the same
//   pass (dx stages the saved output's halo beside gy's); fence.proxy.async
//   then makes the stores visible to wgmma.
// - Math: per chunk and warpgroup 27 wgmma.mma_async (the 9 taps' lo*hi, then
//   hi*lo, then hi*hi, so fewer roundings fall on a large sum), one commit,
//   one wait, then the fragment is added into the running sum.  Everything
//   stays in registers across the K loop: no split-K, no atomics, so two
//   launches give the same bits.
// - Epilogue: bias + ReLU for the forward, neither for dx; fp32 stores of
//   8 consecutive channels per 4 lanes (full 32-byte sectors).
// - Batches past the grid's z limit are launched in chunks.
// ptxas -v (sm_90a): the four instances use 180-182 registers, no stack and
// no spills; their dynamic shared memory is 105-176 KB (set with
// cudaFuncSetAttribute), so one block runs per SM.  The library holds 108
// HGMMA (4 instances x 27).
//
// bf16 (the --dtype bfloat16 lane) has no instance of its own: the wrappers
// widen x and w (forward) or gy, y and w (dx) to fp32, exactly, and round
// this kernel's output to bf16 once, as the Pallas kernel sums bf16 operands
// in fp32 and writes its output's dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_GRID_Z = 65535;

// ------------------------------------------------------------------------
// fp32: 3xTF32 wgmma implicit GEMM (forward and dx)
// ------------------------------------------------------------------------

constexpr int CK = 8;                  // input channels per K step (tf32 wgmma depth)
constexpr int TC_THREADS = 256;        // two warpgroups
constexpr int A_TILE = 64 * CK;        // floats of one 64 x 8 weight tile (hi or lo)
constexpr int TR = 16;                 // tile rows: a warpgroup's 8 x 16 pixels (wgmma n128)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: the operand is 8-row x 16-byte
// core matrices (128 contiguous bytes each); lbo is the byte step between
// core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 8] * B[8 x 128], tf32 in, fp32 accumulate (scale_d
// 0: D = A * B; 1: D += A * B); A and B read from shared memory through their
// descriptors, both K-major.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}



// Weight pre-pass: ws[chunk][co_tile][tap][hi, lo][512] with each 64 x 8
// tile in core-matrix order (8 rows x 4 channels per 128 bytes; core matrix
// (row group g, k half h) at (2g + h) * 128 bytes).  Forward: row co, k = ci
// of w[tap][ci][co]; dx: row c, k of w[8-tap][c][k].  Zero past Cin and Cout.
__global__ void conv3x3_split_weights(const float* __restrict__ w, float* __restrict__ ws,
                                      int Cin, int Cout, int chunks, int co_tiles, int dx) {
  const int total = chunks * co_tiles * 9 * A_TILE;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int e = idx % A_TILE;
    int q = idx / A_TILE;
    const int tap = q % 9;
    q /= 9;
    const int tile = q % co_tiles;
    const int chunk = q / co_tiles;
    const int cm = e / 32, r = (e % 32) / 4, kk = e % 4;
    const int co = tile * 64 + (cm / 2) * 8 + r;
    const int ci = chunk * CK + (cm % 2) * 4 + kk;
    float v = 0.f;
    if (co < Cout && ci < Cin)
      v = dx ? w[((size_t)(8 - tap) * Cout + co) * Cin + ci]
             : w[((size_t)tap * Cin + ci) * Cout + co];
    const float hi = tf32_rna(v);
    float* o = ws + ((size_t)((chunk * co_tiles + tile) * 9 + tap) * 2) * A_TILE + e;
    o[0] = hi;
    o[A_TILE] = v - hi;
  }
}

// in: (N, H, W, Cin); out: (N, H, W, Cout).  Forward (DX false): in = x,
// ws = the split weight of w (3, 3, Cin, Cout), out = relu?(conv + bias).
// DX: in = gy (Cin = the forward's output channels), mask = the saved forward
// output y (read when relu), ws = the split flipped/transposed weight,
// out = dx.  Block: WGM x WGN warpgroups over 64*WGM channels of an
// (8*WGN) x TR pixel tile.
template <bool DX, int WGM>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3x3_tc_kernel(const float* __restrict__ in, const float* __restrict__ mask,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  float* __restrict__ out, int H, int W, int Cin, int Cout, int tiles_x,
                  int co_tiles, int relu, int vec) {
  constexpr int WGN = 2 / WGM;
  constexpr int N = 8 * TR;                         // pixels per warpgroup
  constexpr int HCOL = 8 * WGN + 2;                 // halo columns
  constexpr int HROW = TR + 2;                      // halo rows
  constexpr int HALO = 2 * HROW * HCOL * 4;         // floats: [k half][row][col][4]
  constexpr int WTS = WGM * 9 * 2 * A_TILE;         // floats of one chunk's weights
  constexpr int SLOT = WTS + (DX ? 2 : 1) * HALO;   // weights, halo (, mask halo)
  constexpr uint32_t B_LBO = HROW * HCOL * 16, B_SBO = HCOL * 16;
  extern __shared__ __align__(128) float smem[];
  float* lo_buf = smem + 2 * SLOT;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int x0 = (blockIdx.x % tiles_x) * 8 * WGN;
  const int y0 = (blockIdx.x / tiles_x) * TR;
  const int cot = blockIdx.y * WGM;                 // first 64-row weight tile
  const int n = blockIdx.z;
  const float* inn = in + (size_t)n * H * W * Cin;
  const float* mn = mask + (size_t)n * H * W * Cin;
  const int chunks = (Cin + CK - 1) / CK;
  const bool masked = DX && relu;

  auto load = [&](int c, float* slot) {
    const float* src = ws + (size_t)(c * co_tiles + cot) * 9 * 2 * A_TILE;
    for (int i = tid; i < WTS / 4; i += TC_THREADS) cp_async16(slot + 4 * i, src + 4 * i, 16);
    float* hx = slot + WTS;
    for (int i = tid; i < HALO / 4; i += TC_THREADS) {
      const int hc = i % HCOL;
      const int q = i / HCOL;
      const int gh = y0 - 1 + q % HROW, gw = x0 - 1 + hc, gc = c * CK + (q / HROW) * 4;
      const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const size_t off = inside ? ((size_t)gh * W + gw) * Cin + gc : 0;
      float* d = hx + 4 * i;
      if (vec) {
        const int bytes = inside && gc < Cin ? 16 : 0;
        cp_async16(d, inn + (bytes ? off : 0), bytes);
        if (masked) cp_async16(d + HALO, mn + (bytes ? off : 0), bytes);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int bytes = inside && gc + k < Cin ? 4 : 0;
          cp_async4(d + k, inn + (bytes ? off + k : 0), bytes);
          if (masked) cp_async4(d + HALO + k, mn + (bytes ? off + k : 0), bytes);
        }
      }
    }
  };

  // The tensor cores round their fp32 sums toward zero; summed over all of
  // K that shrinks the result by ~5e-6 relative (a bias that adds up in a
  // weight gradient).  So each chunk's products go to `part`, and the chunks
  // are summed in `acc` with fp32 adds that round to nearest.
  float acc[N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  load(0, smem);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    float* slot = smem + (c & 1) * SLOT;
    if (c + 1 < chunks) load(c + 1, smem + ((c + 1) & 1) * SLOT);
    cp_async_commit();
    cp_async_wait1();                               // chunk c has landed (this thread's part)
    __syncthreads();

    float4* hx = reinterpret_cast<float4*>(slot + WTS);
    float4* lo4 = reinterpret_cast<float4*>(lo_buf);
    for (int i = tid; i < HALO / 4; i += TC_THREADS) {
      float4 v = hx[i];
      if (masked) {
        const float4 m = hx[i + HALO / 4];
        v.x = m.x > 0.f ? v.x : 0.f;
        v.y = m.y > 0.f ? v.y : 0.f;
        v.z = m.z > 0.f ? v.z : 0.f;
        v.w = m.w > 0.f ? v.w : 0.f;
      }
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      hx[i] = h;
      lo4[i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t a0 = smem_u32(slot) + (WGM == 2 ? wg : 0) * 9 * 2 * A_TILE * 4;
    const uint32_t bcol = (WGM == 1 ? wg : 0) * 8 * 16;
    const uint32_t bhi = smem_u32(slot + WTS) + bcol, blo = smem_u32(lo_buf) + bcol;
    fence_operand(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // the small terms first (lo*hi, hi*lo), then hi*hi, so that fewer of
    // the tensor cores' roundings fall on a large running sum
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t shift = ((tap / 3) * HCOL + tap % 3) * 16;
        const uint32_t a = a0 + (tap * 2 + (pass == 0)) * A_TILE * 4;      // lo in pass 0
        const uint32_t b = (pass == 1 ? blo : bhi) + shift;                 // lo in pass 1
        wgmma_tf32_n128(part, make_desc(a, 128, 256), make_desc(b, B_LBO, B_SBO),
                        pass == 0 && tap == 0 ? 0 : 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operand(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
    __syncthreads();                                // slot and lo_buf free for reuse
  }

  // D fragment: warp w of the warpgroup holds rows 16w + g (+ 8); column
  // pair 2t, 2t+1 of each 8-column group j, i.e. tile row j.
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int co = (cot + (WGM == 2 ? wg : 0)) * 64 + warp * 16 + g;
  const int xb = x0 + (WGM == 1 ? wg : 0) * 8 + 2 * t;
  float b0 = 0.f, b1 = 0.f;
  if (!DX) {
    b0 = co < Cout ? bias[co] : 0.f;
    b1 = co + 8 < Cout ? bias[co + 8] : 0.f;
  }
  float* on = out + (size_t)n * H * W * Cout;
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const int oh = y0 + j;
    if (oh >= H) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ow = xb + e;
      if (ow >= W) continue;
      float v0 = acc[4 * j + e] + b0, v1 = acc[4 * j + 2 + e] + b1;
      if (!DX && relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      float* o = on + ((size_t)oh * W + ow) * Cout;
      if (co < Cout) o[co] = v0;
      if (co + 8 < Cout) o[co + 8] = v1;
    }
  }
}

int co_tiles_of(int Cout) {
  const int t = (Cout + 63) / 64;
  return Cout > 64 ? (t + 1) / 2 * 2 : t;          // a whole number of WGM-tile blocks
}

template <bool DX, int WGM>
int launch_tc(const float* in, const float* mask, const float* ws, const float* bias,
              float* out, int N, int H, int W, int Cin, int Cout, int relu, int vec,
              cudaStream_t stream) {
  constexpr int WGN = 2 / WGM;
  constexpr int HALO = 2 * (TR + 2) * (8 * WGN + 2) * 4;
  constexpr int SLOT = WGM * 9 * 2 * A_TILE + (DX ? 2 : 1) * HALO;
  constexpr int SMEM = (2 * SLOT + HALO) * 4;
  auto kernel = conv3x3_tc_kernel<DX, WGM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + 8 * WGN - 1) / (8 * WGN);
  const int tiles = tiles_x * ((H + TR - 1) / TR);
  const int co_tiles = co_tiles_of(Cout);
  for (int n0 = 0; n0 < N; n0 += MAX_GRID_Z) {
    const int nn = N - n0 < MAX_GRID_Z ? N - n0 : MAX_GRID_Z;
    const size_t in_off = (size_t)n0 * H * W * Cin;
    dim3 grid((unsigned)tiles, (unsigned)(co_tiles / WGM), (unsigned)nn);
    kernel<<<grid, TC_THREADS, SMEM, stream>>>(in + in_off, mask + in_off, ws, bias,
                                               out + (size_t)n0 * H * W * Cout, H, W, Cin,
                                               Cout, tiles_x, co_tiles, relu, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Split the weight into ws, then run the conv.
template <bool DX>
int launch_f32(const float* in, const float* mask, const float* w, const float* bias,
               float* ws, float* out, int N, int H, int W, int Cin, int Cout, int relu,
               cudaStream_t stream) {
  const int chunks = (Cin + CK - 1) / CK;
  const int co_tiles = co_tiles_of(Cout);
  const int total = chunks * co_tiles * 9 * A_TILE;
  conv3x3_split_weights<<<(total + 255) / 256, 256, 0, stream>>>(w, ws, Cin, Cout, chunks,
                                                                 co_tiles, DX ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool masked = DX && relu;
  const int vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                  (!masked || reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  return Cout > 64
             ? launch_tc<DX, 2>(in, mask, ws, bias, out, N, H, W, Cin, Cout, relu, vec, stream)
             : launch_tc<DX, 1>(in, mask, ws, bias, out, N, H, W, Cin, Cout, relu, vec, stream);
}

}  // namespace

// Floats of the split-weight workspace that the fp32 calls take (ws), for a
// conv of Cin input and Cout output channels (dx: Cin = K, Cout = C).
extern "C" long long conv3x3_workspace_floats(int Cin, int Cout) {
  return (long long)((Cin + CK - 1) / CK) * co_tiles_of(Cout) * 9 * 2 * A_TILE;
}

extern "C" int conv3x3_bias_relu_f32(const float* x, const float* w, const float* b, float* ws,
                                     float* y, int N, int H, int W, int C, int Co, int relu,
                                     cudaStream_t stream) {
  return launch_f32<false>(x, x, w, b, ws, y, N, H, W, C, Co, relu, stream);
}

// gy, y: (N, H, W, K) with K the forward's output channels; w: (3, 3, C, K)
// the forward HWIO weight; dx: (N, H, W, C).
extern "C" int conv3x3_dx_f32(const float* gy, const float* y, const float* w, float* ws,
                              float* dx, int N, int H, int W, int C, int K, int relu,
                              cudaStream_t stream) {
  return launch_f32<true>(gy, y, w, nullptr, ws, dx, N, H, W, K, C, relu, stream);
}
