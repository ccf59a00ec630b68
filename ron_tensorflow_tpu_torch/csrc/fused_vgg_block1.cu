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
// the pooled value to bf16. The TPU kernel runs conv1_2 on the MXU, bf16 x
// bf16 into f32; so does this one, on the tensor cores.
//
// Design: a persistent grid, one block of 512 threads per SM, walks 16 x 32
// tiles of conv outputs. Each block stages conv1_2's weights once, in the
// swizzled [tap][co][ci] layout of conv3x3_mma.cuh. Per tile it stages the
// input with a 2-pixel halo (20 x 36 x 3, f32), computes conv1_1 on the
// 18 x 34 tile with a 1-pixel halo on the CUDA cores (one thread per
// vertical pixel pair and 8 channels, fmaf over (dy, dx, ci) in that order;
// a warp shares one channel chunk, so weight reads broadcast) and writes it as
// bf16 straight into the pixel-major A tile of the shared mainloop: the
// full-resolution intermediates never reach device memory. conv1_2, bias,
// ReLU, pool and the store are the mainloop's (conv3x3_mma.cuh), which the
// stem kernel K-D shares, so K-D on the same conv1_1 map gives these bits.
//
// Bound on the H100: operations. At the main path's [32, 320, 320, 3] the
// two convs are ~253 GFLOP (conv1_2 ~242, on the tensor cores), against
// ~125 MB of input and output. conv1_1 (about 5% of the FLOPs with its
// halo) runs on the CUDA cores and is not overlapped with conv1_2's MMAs.

#include "conv3x3_mma.cuh"

namespace {

using namespace conv_mma;

constexpr int kCin = 3;
constexpr int kXH = kTileH + 4;  // input rows staged (2-row halo)
constexpr int kXW = kTileW + 4;

constexpr int kPairGroups = ((kInH / 2) * kInW + 31) / 32;  // 32 vertical pixel pairs each
constexpr int kXBytes = kXH * kXW * kCin * 4;
constexpr int kW1Bytes = 9 * kCin * kC * 4;
constexpr int kSmemBytes = kWBytes + kABytes + kXBytes + kW1Bytes + 2 * kC * 4 + 1024;  // + alignment

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) { return __uint_as_float(bits << 16); }

__global__ void __launch_bounds__(kThreads, 1)
fused_vgg_block1_kernel(const uint16_t* __restrict__ x,    // [B, H, W, 3] bf16
                        const uint16_t* __restrict__ w1,   // [3, 3, 3, 64] bf16 (HWIO)
                        const float* __restrict__ b1,      // [64]
                        const uint4* __restrict__ w2,      // [9, 64 co, 64 ci] bf16
                        const float* __restrict__ b2,      // [64]
                        uint16_t* __restrict__ out,        // [B, H/2, W/2, 64] bf16
                        int batch, int height, int width) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ws = smem;                 // B operand, 1024-aligned
  unsigned char* as = smem + kWBytes;       // A operand, then the pooled tile
  float* xs = reinterpret_cast<float*>(as + kABytes);
  float* w1s = xs + kXH * kXW * kCin;
  float* b1s = w1s + 9 * kCin * kC;
  float* b2s = b1s + kC;
  const uint32_t w_smem = smem_u32(ws), a_smem = smem_u32(as);
  const int tid = threadIdx.x;

  // ---- once per block: conv1_2's weights (swizzled), conv1_1's, biases ---
  for (int i = tid; i < 9 * kC * 8; i += kThreads) {
    const int c = i & 7, co = (i >> 3) % kC, t = i / (kC * 8);
    *reinterpret_cast<uint4*>(ws + w_offset(t, co, c)) = w2[i];
  }
  for (int i = tid; i < 9 * kCin * kC; i += kThreads) w1s[i] = bf16_bits_to_float(w1[i]);
  if (tid < kC) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }

  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const int tiles = tiles_x * tiles_y * batch;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const int x0 = tx * kTileW, y0 = ty * kTileH;
    __syncthreads();  // the weights are staged; the last tile's pooled values are stored

    // ---- the input tile with a 2-pixel zero halo, f32 --------------------
    const uint16_t* ximg = x + static_cast<size_t>(b) * height * width * kCin;
    for (int i = tid_here(); i < kXH * kXW * kCin; i += kThreads) {
      const int r = i / (kXW * kCin);
      const int rem = i - r * (kXW * kCin);
      const int c = rem / kCin;
      const int ch = rem - c * kCin;
      const int gy = y0 - 2 + r, gx = x0 - 2 + c;
      float v = 0.0f;
      if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
        v = bf16_bits_to_float(ximg[(static_cast<size_t>(gy) * width + gx) * kCin + ch]);
      }
      xs[i] = v;
    }
    __syncthreads();

    // ---- conv1_1 + bias + ReLU on the haloed tile, bf16, into A ----------
    // A thread computes 8 channels (chunk c) of a vertical pixel pair; the 32
    // lanes of a warp take 32 pairs and one chunk, so every weight read is a
    // broadcast and the 3 x 4 x 3 inputs of a pair serve both its pixels.
    for (int i = tid_here(); i < kPairGroups * 32 * 8; i += kThreads) {
      const int c = (i >> 5) & 7;
      const int q = (i >> 8) * 32 + (i & 31);  // pixel pair: rows 2 (q / kInW) + {0, 1}
      if (q >= (kInH / 2) * kInW) continue;
      const int r = 2 * (q / kInW), col = q % kInW;
      float xv[4][3][kCin];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) xv[rr][dx][ci] = xs[((r + rr) * kXW + (col + dx)) * kCin + ci];
      float acc[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[h][k] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < kCin; ++ci) {
            const float4* wv = reinterpret_cast<const float4*>(w1s + ((dy * 3 + dx) * kCin + ci) * kC + 8 * c);
            const float4 wa = wv[0], wb = wv[1];
            const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[h][k] = fmaf(xv[dy + h][dx][ci], wk[k], acc[h][k]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 - 1 + r + h, gx = x0 - 1 + col;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);  // SAME zero padding of conv1_2's input
        if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
          float y[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) y[k] = fmaxf(acc[h][k] + b1s[8 * c + k], 0.0f);
          v = make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]), pack_bf16x2(y[4], y[5]),
                         pack_bf16x2(y[6], y[7]));
        }
        *reinterpret_cast<uint4*>(as + a_offset((r + h) * kInW + col, c)) = v;
      }
    }
    __syncthreads();

    // ---- conv1_2 on the tensor cores, then bias + ReLU + pool -----------
    float acc[2][32];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[i][k] = 0.0f;
    conv_tile_mma(acc, a_smem, w_smem);
    __syncthreads();  // every warpgroup is done reading A
    pool_tile_to_staging(acc, b2s, reinterpret_cast<uint16_t*>(as));
    __syncthreads();
    store_staging(reinterpret_cast<const uint16_t*>(as), out + static_cast<size_t>(b) * (height / 2) * (width / 2) * kC,
                  y0 / 2, x0 / 2, height / 2, width / 2, 0, kC);
  }
}

}  // namespace

extern "C" int fused_vgg_block1_smem_bytes() { return kSmemBytes; }

extern "C" int fused_vgg_block1(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int batch, int height, int width,
                                cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 2 != 0 || width % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(batch) * ((height + kTileH - 1) / kTileH) *
                          ((width + kTileW - 1) / kTileW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_vgg_block1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  fused_vgg_block1_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1),
      static_cast<const float*>(b1), static_cast<const uint4*>(w2),
      static_cast<const float*>(b2), static_cast<uint16_t*>(out), batch, height, width);
  return static_cast<int>(cudaGetLastError());
}
