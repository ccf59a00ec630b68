// VGG block 1 fused: conv1_1 (3->64) + bias + ReLU, rounded to bf16, then
// conv1_2 (64->64) + bias + ReLU in f32, then the 2x2/s2 max-pool, one bf16
// store. NHWC bf16 in and out, f32 accumulation, forward only.
//
// Replaces the TPU kernel ron_tensorflow_tpu/kernels/fused_conv_pool.py
// `fused_vgg_block1` (`_fused_vgg_block1_impl` -> `_block1_kernel`).
// Numerics follow that kernel: weights rounded to bf16, f32 sums, conv1_1's
// output rounded to bf16 before conv1_2, SAME zero padding for both convs
// (rows and columns of the conv1_1 map outside the image are 0, not
// relu(b1): fused_conv_pool.py:219-227), the pool on f32, one rounding of
// the pooled value to bf16.
//
// Design: a block owns a 16 x 32 tile of conv1_2 outputs (8 x 16 pooled) of
// one image. It stages in shared memory the input tile with a 2-pixel halo
// (20 x 36 x 3, f32), all of conv1_2's weights (9 x 64 x 64 bf16, 72 KB),
// and computes conv1_1 on the 18 x 34 tile with a 1-pixel halo, kept as
// bf16 planes [64][18][34] (76.5 KB): the full-resolution intermediates
// never reach device memory. Each of the 512 threads then owns a 2 x 4
// pixel patch (two pool windows) x 8 output channels: 64 f32 accumulators
// in registers; per input channel and kernel row it reads 12 activations and
// three 16-byte weight vectors for 192 FMAs. The pool runs in registers and
// each thread stores its 2 x 8 pooled outputs as two 16-byte vectors.
//
// Bound on the H100: operations. At the main path's [32, 320, 320, 3] the
// two convs are ~253 GFLOP (conv1_2 ~242), against ~125 MB of input and
// output. This first version runs on the CUDA cores (f32 FMA), not the
// tensor cores; mma.sync/wgmma is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3;
constexpr int kC = 64;
constexpr int kTileH = 16;            // conv1_2 output rows per block
constexpr int kTileW = 32;            // conv1_2 output cols per block
constexpr int kY1H = kTileH + 2;      // conv1_1 rows kept (1-row halo)
constexpr int kY1W = kTileW + 2;
constexpr int kXH = kTileH + 4;       // input rows staged (2-row halo)
constexpr int kXW = kTileW + 4;
constexpr int kThreads = 512;
constexpr int kChanPerThread = 8;
constexpr int kGroups = kC / kChanPerThread;  // 8 channel groups
constexpr int kPatchCols = kTileW / 4;        // 8 patches of 2 x 4 per row pair

constexpr size_t kW2Bytes = 9 * kC * kC * sizeof(uint16_t);
constexpr size_t kY1Bytes = kC * kY1H * kY1W * sizeof(uint16_t);
constexpr size_t kXBytes = kXH * kXW * kCin * sizeof(float);
constexpr size_t kW1Bytes = 9 * kCin * kC * sizeof(float);
constexpr size_t kSmemBytes = kW2Bytes + kY1Bytes + kXBytes + kW1Bytes + 2 * kC * sizeof(float);

static_assert(kThreads == kGroups * (kTileH / 2) * kPatchCols, "thread layout");
static_assert(kW2Bytes % 16 == 0 && kY1Bytes % 16 == 0 && kXBytes % 16 == 0, "alignment");

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_vgg_block1_kernel(const uint16_t* __restrict__ x,    // [B, H, W, 3] bf16
                        const uint16_t* __restrict__ w1,   // [3, 3, 3, 64] bf16 (HWIO)
                        const float* __restrict__ b1,      // [64]
                        const uint4* __restrict__ w2,      // [3, 3, 64, 64] bf16 (HWIO)
                        const float* __restrict__ b2,      // [64]
                        uint4* __restrict__ out,           // [B, H/2, W/2, 64] bf16
                        int height, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w2s = reinterpret_cast<uint4*>(smem);
  uint16_t* y1s = reinterpret_cast<uint16_t*>(smem + kW2Bytes);
  float* xs = reinterpret_cast<float*>(smem + kW2Bytes + kY1Bytes);
  float* w1s = xs + kXH * kXW * kCin;
  float* b1s = w1s + 9 * kCin * kC;
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;

  // ---- stage weights, biases and the input tile --------------------------
  for (int i = tid; i < static_cast<int>(kW2Bytes / 16); i += kThreads) w2s[i] = w2[i];
  for (int i = tid; i < 9 * kCin * kC; i += kThreads) w1s[i] = bf16_bits_to_float(w1[i]);
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  const uint16_t* ximg = x + static_cast<size_t>(b) * height * width * kCin;
  for (int i = tid; i < kXH * kXW * kCin; i += kThreads) {
    const int r = i / (kXW * kCin);
    const int rem = i - r * (kXW * kCin);
    const int c = rem / kCin;
    const int ch = rem - c * kCin;
    const int gy = y0 - 2 + r;
    const int gx = x0 - 2 + c;
    float v = 0.0f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      v = bf16_bits_to_float(ximg[(static_cast<size_t>(gy) * width + gx) * kCin + ch]);
    }
    xs[i] = v;
  }
  __syncthreads();

  // ---- conv1_1 + bias + ReLU on the haloed tile, rounded to bf16 ---------
  for (int i = tid; i < kC * kY1H * kY1W; i += kThreads) {
    const int co = i / (kY1H * kY1W);
    const int rem = i - co * (kY1H * kY1W);
    const int r = rem / kY1W;
    const int c = rem - r * kY1W;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float y = 0.0f;  // SAME zero padding of conv1_2's input
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) {
            acc = fmaf(xs[((r + dy) * kXW + (c + dx)) * kCin + ci],
                       w1s[((dy * 3 + dx) * kCin + ci) * kC + co], acc);
          }
        }
      }
      y = fmaxf(acc + b1s[co], 0.0f);
    }
    y1s[i] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
  }
  __syncthreads();

  // ---- conv1_2 on a 2 x 4 patch x 8 channels per thread ------------------
  const int cg = tid % kGroups;
  const int patch = tid / kGroups;
  const int pr = patch / kPatchCols;  // row pair 0..7
  const int pc = patch % kPatchCols;  // column quad 0..7
  float acc[2][4][kChanPerThread];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int kk = 0; kk < kChanPerThread; ++kk) acc[rr][jj][kk] = 0.0f;

#pragma unroll 1
  for (int ci = 0; ci < kC; ++ci) {
    const uint16_t* plane = y1s + ci * (kY1H * kY1W);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float v[2][6];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int jj = 0; jj < 6; ++jj)
          v[rr][jj] = bf16_bits_to_float(plane[(2 * pr + rr + dy) * kY1W + 4 * pc + jj]);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 wv = w2s[((dy * 3 + dx) * kC + ci) * kGroups + cg];
        const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
        float w[kChanPerThread];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[2 * q] = __uint_as_float(wp[q] << 16);
          w[2 * q + 1] = __uint_as_float(wp[q] & 0xffff0000u);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int kk = 0; kk < kChanPerThread; ++kk)
              acc[rr][jj][kk] = fmaf(v[rr][jj + dx], w[kk], acc[rr][jj][kk]);
      }
    }
  }

  // ---- bias + ReLU + 2x2 max-pool, one bf16 store per pool window --------
  const int gy = y0 + 2 * pr;
  if (gy >= height) return;
  const int out_w = width / 2;
  const int co0 = cg * kChanPerThread;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int gx = x0 + 4 * pc + 2 * q;
    if (gx >= width) continue;
    float m[kChanPerThread];
#pragma unroll
    for (int kk = 0; kk < kChanPerThread; ++kk) {
      const float bias = b2s[co0 + kk];
      float best = 0.0f;  // ReLU floor: max(relu(a_i)) == max(0, a_i...)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int jj = 2 * q; jj < 2 * q + 2; ++jj)
          best = fmaxf(best, acc[rr][jj][kk] + bias);
      m[kk] = best;
    }
    const size_t pixel = (static_cast<size_t>(b) * (height / 2) + gy / 2) * out_w + gx / 2;
    out[pixel * kGroups + cg] = make_uint4(pack_bf16x2(m[0], m[1]), pack_bf16x2(m[2], m[3]),
                                           pack_bf16x2(m[4], m[5]), pack_bf16x2(m[6], m[7]));
  }
}

}  // namespace

extern "C" int fused_vgg_block1(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int batch, int height, int width,
                                cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 2 != 0 || width % 2 != 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_vgg_block1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, batch);
  fused_vgg_block1_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1),
      static_cast<const float*>(b1), static_cast<const uint4*>(w2),
      static_cast<const float*>(b2), static_cast<uint4*>(out), height, width);
  return static_cast<int>(cudaGetLastError());
}
