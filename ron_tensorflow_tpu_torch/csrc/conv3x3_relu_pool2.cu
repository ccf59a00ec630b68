// Fused 3x3 SAME conv + bias + ReLU + 2x2/s2 max-pool, NHWC, Ci -> Co.
// bf16 input and weights, f32 sums, bias, ReLU and pool; the pooled value is
// stored as bf16 or as f32.
//
// Replaces two TPU kernels of ron_tensorflow_tpu/kernels/fused_conv_pool.py
// that compute the same function up to the output rounding:
//   `fused_stem_conv_relu_pool2` (`_stem_kernel`, C -> C): the pooled value
//       is always rounded to bf16 (its identity-matmul pool runs in bf16);
//       launcher `fused_stem_conv_relu_pool2`, kernel `stem_conv_mma_kernel`.
//   `fused_conv3x3_relu_pool2` (`_kernel`, Ci -> Co): the f32 value is only
//       cast to x's dtype; launcher `fused_conv3x3_relu_pool2`, kernel
//       `conv3x3_relu_pool2_kernel`, which stores bf16 for a bf16 x and f32
//       for an f32 x.
// The TPU kernels' merged-column layout, lane rolls with boundary masks and
// identity-matmul pool serve the MXU's 128 lanes and are not carried over.
//
// Stem (K-D): the tensor-core mainloop of conv3x3_mma.cuh, which fused block
// 1 (K-B) shares. A persistent grid, one block of 512 threads per SM, walks
// (16 x 32 output tile, 64-output-channel chunk) units; each unit sums over
// 64-input-channel chunks, one stage each. The weights of a (co, ci) chunk
// pair, [9][64][64] bf16 in the swizzled B layout, stay resident while the
// pair does not change: at C <= 64, for the block's whole life. Each stage's
// input tile with its 1-pixel halo (18 x 34 x 64 bf16, zero outside the
// image and past C) is loaded with cp.async into one of two A buffers while
// the previous stage's MMAs run. Bound on the H100 at [32, 320, 320, 64]:
// operations (241.6 GFLOP against 0.52 GB), near the ridge, so the loads
// must overlap the MMAs.
//
// General (K-E): a direct convolution on the CUDA cores. A block owns a
// 16 x 32 tile of conv outputs (8 x 16 pooled) of one image and one chunk of
// 64 output channels. It loops over the input channels in chunks of 32; for
// each chunk it stages the input tile with a 1-pixel zero halo as bf16
// planes [32][18][34] (39 KB) and the chunk's weights [9][32][64] bf16
// (36 KB) in shared memory. Each of the 512 threads owns a 2 x 4 pixel patch
// (two pool windows) x 8 output channels: 64 f32 accumulators in registers.
// Bias, ReLU and the pool run in registers, and each thread stores its
// 2 x 8 pooled values with 16-byte vectors. Channels beyond Ci or Co within
// a chunk are zeros. Bound: operations (the VGG block-2 and block-3 tails
// are ~242 GFLOP each); it runs on the CUDA cores, not the tensor cores.

#include "conv3x3_mma.cuh"

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

namespace cm = conv_mma;

constexpr int kStemSmemBytes = cm::kWBytes + 2 * cm::kABytes + cm::kC * 4 + 1024;  // + alignment

// Asynchronous copies to shared memory; an invalid one writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(cm::kThreads, 1)
stem_conv_mma_kernel(const uint16_t* __restrict__ x,   // [B, H, W, C] bf16
                     const uint16_t* __restrict__ w,   // [9, C co, C ci] bf16
                     const float* __restrict__ bias,   // [C]
                     uint16_t* __restrict__ out,       // [B, H/2, W/2, C] bf16
                     int batch, int height, int width, int channels) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t w_smem = cm::smem_u32(smem);  // B operand, 1024-aligned
  auto abuf = [&](int buf) { return smem + cm::kWBytes + buf * cm::kABytes; };  // two A buffers
  float* bs = reinterpret_cast<float*>(smem + cm::kWBytes + 2 * cm::kABytes);
  const int tid = threadIdx.x;

  const int nk = (channels + cm::kC - 1) / cm::kC;  // 64-channel chunks of K and of N
  const int tiles_x = (width + cm::kTileW - 1) / cm::kTileW;
  const int tiles_y = (height + cm::kTileH - 1) / cm::kTileH;
  const int tiles = tiles_x * tiles_y * batch;
  const int units = tiles * nk;  // (tile, output-channel chunk), the chunk outermost
  const int my_units = blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = my_units * nk;  // one per input-channel chunk of each unit

  // Input tile of stage i (1-pixel zero halo, channels past C zero) into buf.
  auto load_tile = [&](int i, int buf) {
    const int unit = blockIdx.x + (i / nk) * gridDim.x, kc = i % nk;
    const int tile = unit % tiles;
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const uint32_t dst = cm::smem_u32(abuf(buf));
    for (int v = cm::tid_here(); v < cm::kInH * cm::kInW * 8; v += cm::kThreads) {
      const int p = v >> 3, c = v & 7;
      const int r = p / cm::kInW, col = p - r * cm::kInW;
      const int gy = ty * cm::kTileH - 1 + r, gx = tx * cm::kTileW - 1 + col;
      const int ch = kc * cm::kC + 8 * c;
      const bool valid = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < channels;
      const uint16_t* src = valid ? x + ((static_cast<size_t>(b) * height + gy) * width + gx) * channels + ch : x;
      cp_async16(dst + cm::a_offset(p, c), src, valid);
    }
  };

  if (stages > 0) load_tile(0, 0);
  cp_async_commit();
  int resident = -1;  // the (co, ci) chunk pair whose weights are staged
  float acc[2][32];
  for (int i = 0; i < stages; ++i) {
    const int unit = blockIdx.x + (i / nk) * gridDim.x, kc = i % nk;
    const int co_chunk = unit / tiles, tile = unit % tiles;
    const int co0 = co_chunk * cm::kC, ci0 = kc * cm::kC;
    if (co_chunk * nk + kc != resident) {  // the last stage ended at a barrier: the old weights are free
      resident = co_chunk * nk + kc;
      for (int v = cm::tid_here(); v < 9 * cm::kC * 8; v += cm::kThreads) {
        const int c = v & 7, co = (v >> 3) % cm::kC, t = v / (cm::kC * 8);
        const bool valid = co0 + co < channels && ci0 + 8 * c < channels;
        const uint16_t* src = valid ? w + (static_cast<size_t>(t) * channels + co0 + co) * channels + ci0 + 8 * c : w;
        cp_async16(w_smem + cm::w_offset(t, co, c), src, valid);
      }
      if (tid < cm::kC) bs[tid] = co0 + tid < channels ? bias[co0 + tid] : 0.0f;
      cp_async_commit();
    }
    if (i + 1 < stages) {  // the next stage's tile loads while this one computes
      load_tile(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[m][k] = 0.0f;
    }
    cm::conv_tile_mma(acc, cm::smem_u32(abuf(i & 1)), w_smem);
    if (kc == nk - 1) {
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
      __syncthreads();  // every warpgroup is done reading this A buffer
      cm::pool_tile_to_staging(acc, bs, reinterpret_cast<uint32_t*>(abuf(i & 1)));
      __syncthreads();
      cm::store_staging(reinterpret_cast<const uint4*>(abuf(i & 1)),
                        out + static_cast<size_t>(b) * (height / 2) * (width / 2) * channels,
                        ty * cm::kTileH / 2, tx * cm::kTileW / 2, height / 2, width / 2, co0, channels);
    }
    __syncthreads();  // this A buffer and the weights may be overwritten
  }
}

int launch_stem(const void* x, const void* w, const void* b, void* out, int batch, int height, int width,
                int channels, cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 2 != 0 || width % 2 != 0 || channels <= 0 || channels % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = static_cast<long long>(batch) * ((height + cm::kTileH - 1) / cm::kTileH) *
                          ((width + cm::kTileW - 1) / cm::kTileW) * ((channels + cm::kC - 1) / cm::kC);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = cm::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t attr = cudaFuncSetAttribute(
      stem_conv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStemSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = static_cast<int>(units < sms ? units : sms);
  stem_conv_mma_kernel<<<grid, cm::kThreads, kStemSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), static_cast<const float*>(b),
      static_cast<uint16_t*>(out), batch, height, width, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_stem_conv_relu_pool2_smem_bytes() { return kStemSmemBytes; }

// K-D: C -> C, the pooled value always stored as bf16; w [9][C co][C ci].
extern "C" int fused_stem_conv_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                          int batch, int height, int width, int cin, int cout,
                                          cudaStream_t stream) {
  if (cin != cout) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stem(x, w, b, out, batch, height, width, cin, stream);
}

// K-E: Ci -> Co, w [3][3][Ci][Co] (HWIO); stored as bf16 when out_bf16 (a bf16 x), else as f32.
extern "C" int fused_conv3x3_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                        int batch, int height, int width, int cin, int cout,
                                        int out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<true>(x, w, b, out, batch, height, width, cin, cout, stream)
                  : launch<false>(x, w, b, out, batch, height, width, cin, cout, stream);
}
