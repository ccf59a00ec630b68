// Fused 3x3 SAME conv + bias + ReLU + 2x2/s2 max-pool, NHWC, Ci -> Co.
// bf16 input and weights, f32 sums, bias, ReLU and pool; the pooled value is
// stored as bf16 or as f32 (the template argument).
//
// Replaces two TPU kernels of ron_tensorflow_tpu/kernels/fused_conv_pool.py
// that compute the same function up to the output rounding:
//   `fused_stem_conv_relu_pool2` (`_stem_kernel`, C -> C): the pooled value
//       is always rounded to bf16 (its identity-matmul pool runs in bf16);
//       launcher `fused_stem_conv_relu_pool2` stores bf16.
//   `fused_conv3x3_relu_pool2` (`_kernel`, Ci -> Co): the f32 value is only
//       cast to x's dtype; launcher `fused_conv3x3_relu_pool2` stores bf16
//       for a bf16 x and f32 for an f32 x.
// The TPU kernels' merged-column layout, lane rolls with boundary masks and
// identity-matmul pool serve the MXU's 128 lanes and are not carried over.
//
// Design (a direct convolution on the CUDA cores, like fused_vgg_block1.cu's
// conv1_2): a block owns a 16 x 32 tile of conv outputs (8 x 16 pooled) of
// one image and one chunk of 64 output channels. It loops over the input
// channels in chunks of 32; for each chunk it stages the input tile with a
// 1-pixel zero halo as bf16 planes [32][18][34] (39 KB) and the chunk's
// weights [9][32][64] bf16 (36 KB) in shared memory. The whole 3x3 x Ci x 64
// slice cannot stay resident: at Ci = Co = 512 a 32-channel slice alone is
// 295 KB, over the 227 KB a block may use. Each of the 512 threads owns a
// 2 x 4 pixel patch (two pool windows) x 8 output channels: 64 f32
// accumulators in registers; per input channel and kernel row it reads 12
// activations and three 16-byte weight vectors for 192 FMAs. Bias, ReLU and
// the pool run in registers, and each thread stores its 2 x 8 pooled values
// with 16-byte vectors. Channels beyond Ci or Co within a chunk are zeros.
//
// Bound on the H100: operations. At [32, 320, 320, 64] -> 64 (and at the
// VGG block-2 and block-3 tails, [32, 160, 160, 128] -> 128 and
// [32, 80, 80, 256] -> 256) the conv is ~242 GFLOP against ~0.5 GB of input
// and output. This first version runs on the CUDA cores (f32 FMA), not the
// tensor cores; mma.sync/wgmma is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;  // conv output rows per block
constexpr int kTileW = 32;  // conv output cols per block
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;
constexpr int kCiChunk = 32;
constexpr int kCoChunk = 64;
constexpr int kThreads = 512;
constexpr int kChanPerThread = 8;
constexpr int kGroups = kCoChunk / kChanPerThread;  // 8 channel groups
constexpr int kPatchCols = kTileW / 4;              // 8 patches of 2 x 4 per row pair
constexpr int kWVecs = 9 * kCiChunk * kGroups;      // uint4 vectors of 8 bf16

constexpr size_t kWBytes = kWVecs * sizeof(uint4);
constexpr size_t kXBytes = kCiChunk * kInH * kInW * sizeof(uint16_t);
constexpr size_t kSmemBytes = kWBytes + kXBytes + kCoChunk * sizeof(float);

static_assert(kThreads == kGroups * (kTileH / 2) * kPatchCols, "thread layout");
static_assert(kWBytes % 16 == 0 && kXBytes % 16 == 0, "alignment");

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

template <bool kOutBf16>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_relu_pool2_kernel(const uint16_t* __restrict__ x,  // [B, H, W, Ci] bf16
                          const uint16_t* __restrict__ w,  // [3, 3, Ci, Co] bf16 (HWIO)
                          const float* __restrict__ bias,  // [Co]
                          void* __restrict__ out,          // [B, H/2, W/2, Co]
                          int height, int width, int cin, int cout, int co_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ws = reinterpret_cast<uint4*>(smem);                       // [9][kCiChunk][kGroups]
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + kWBytes);       // [kCiChunk][kInH][kInW]
  float* bs = reinterpret_cast<float*>(smem + kWBytes + kXBytes);   // [kCoChunk]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / co_chunks;
  const int co0 = (blockIdx.z % co_chunks) * kCoChunk;

  if (tid < kCoChunk) bs[tid] = co0 + tid < cout ? bias[co0 + tid] : 0.0f;

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

  const uint16_t* ximg = x + static_cast<size_t>(b) * height * width * cin;
  const uint4* wvec = reinterpret_cast<const uint4*>(w);  // cout % 8 == 0

#pragma unroll 1
  for (int ci0 = 0; ci0 < cin; ci0 += kCiChunk) {
    __syncthreads();  // the previous chunk's planes and weights are consumed
    // ---- stage this chunk's weights and input tile (1-pixel zero halo) ---
    for (int i = tid; i < kWVecs; i += kThreads) {
      const int g = i % kGroups;
      const int ci = (i / kGroups) % kCiChunk;
      const int tap = i / (kGroups * kCiChunk);
      const int gci = ci0 + ci;
      const int gco = co0 + g * kChanPerThread;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gci < cin && gco < cout) {
        v = wvec[(static_cast<size_t>(tap) * cin + gci) * (cout / kChanPerThread) + gco / kChanPerThread];
      }
      ws[i] = v;
    }
    for (int i = tid; i < kInH * kInW * kCiChunk; i += kThreads) {
      const int ci = i % kCiChunk;
      const int pix = i / kCiChunk;
      const int r = pix / kInW;
      const int c = pix - r * kInW;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      const int gci = ci0 + ci;
      uint16_t v = 0;
      if (gci < cin && gy >= 0 && gy < height && gx >= 0 && gx < width) {
        v = ximg[(static_cast<size_t>(gy) * width + gx) * cin + gci];
      }
      xs[ci * (kInH * kInW) + pix] = v;
    }
    __syncthreads();

    // ---- accumulate: 2 x 4 pixels x 8 channels per thread ----------------
    const int nci = min(kCiChunk, cin - ci0);
#pragma unroll 1
    for (int ci = 0; ci < nci; ++ci) {
      const uint16_t* plane = xs + ci * (kInH * kInW);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[2][6];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int jj = 0; jj < 6; ++jj)
            v[rr][jj] = bf16_bits_to_float(plane[(2 * pr + rr + dy) * kInW + 4 * pc + jj]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 wv = ws[((dy * 3 + dx) * kCiChunk + ci) * kGroups + cg];
          const uint32_t wp[4] = {wv.x, wv.y, wv.z, wv.w};
          float wf[kChanPerThread];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wf[2 * q] = __uint_as_float(wp[q] << 16);
            wf[2 * q + 1] = __uint_as_float(wp[q] & 0xffff0000u);
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int kk = 0; kk < kChanPerThread; ++kk)
                acc[rr][jj][kk] = fmaf(v[rr][jj + dx], wf[kk], acc[rr][jj][kk]);
        }
      }
    }
  }

  // ---- bias + ReLU + 2x2 max-pool, one store per pool window -------------
  const int gy = y0 + 2 * pr;
  const int co = co0 + cg * kChanPerThread;
  if (gy >= height || co >= cout) return;
  const int out_w = width / 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int gx = x0 + 4 * pc + 2 * q;
    if (gx >= width) continue;
    float m[kChanPerThread];
#pragma unroll
    for (int kk = 0; kk < kChanPerThread; ++kk) {
      const float bk = bs[cg * kChanPerThread + kk];
      float best = 0.0f;  // ReLU floor: max(relu(a_i)) == max(0, a_i...)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int jj = 2 * q; jj < 2 * q + 2; ++jj) best = fmaxf(best, acc[rr][jj][kk] + bk);
      m[kk] = best;
    }
    const size_t pixel = (static_cast<size_t>(b) * (height / 2) + gy / 2) * out_w + gx / 2;
    const size_t at = pixel * cout + co;  // a multiple of 8
    if (kOutBf16) {
      reinterpret_cast<uint4*>(out)[at / 8] =
          make_uint4(pack_bf16x2(m[0], m[1]), pack_bf16x2(m[2], m[3]),
                     pack_bf16x2(m[4], m[5]), pack_bf16x2(m[6], m[7]));
    } else {
      float4* o = reinterpret_cast<float4*>(out) + at / 4;
      o[0] = make_float4(m[0], m[1], m[2], m[3]);
      o[1] = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
}

template <bool kOutBf16>
int launch(const void* x, const void* w, const void* b, void* out, int batch, int height,
           int width, int cin, int cout, cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  const int co_chunks = (cout + kCoChunk - 1) / kCoChunk;
  if (height % 2 != 0 || width % 2 != 0 || cin <= 0 || cout <= 0 || cout % kChanPerThread != 0 ||
      static_cast<long long>(batch) * co_chunks > 65535 || (height + kTileH - 1) / kTileH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_relu_pool2_kernel<kOutBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, batch * co_chunks);
  conv3x3_relu_pool2_kernel<kOutBf16><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(b), out, height, width, cin, cout, co_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K-D: C -> C, the pooled value always stored as bf16.
extern "C" int fused_stem_conv_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                          int batch, int height, int width, int cin, int cout,
                                          cudaStream_t stream) {
  if (cin != cout) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, w, b, out, batch, height, width, cin, cout, stream);
}

// K-E: Ci -> Co, stored as bf16 when out_bf16 (a bf16 x), else as f32.
extern "C" int fused_conv3x3_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                        int batch, int height, int width, int cin, int cout,
                                        int out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<true>(x, w, b, out, batch, height, width, cin, cout, stream)
                  : launch<false>(x, w, b, out, batch, height, width, cin, cout, stream);
}
