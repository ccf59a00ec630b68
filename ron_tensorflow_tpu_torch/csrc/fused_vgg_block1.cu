// A VGG double-conv block fused: conv A (Ci -> C) + bias + ReLU, rounded to
// bf16, then conv B (C -> C) + bias + ReLU in f32, then the 2x2/s2 max-pool,
// one bf16 store. NHWC bf16 in and out, f32 accumulation, forward only. Two
// kernels, one launch each: `fused_vgg_block1_kernel` for VGG block 1 (Ci = 3,
// C = 64; conv1_1 on the CUDA cores) and `fused_vgg_block2_kernel` for every
// other width (VGG block 2 is Ci = 64, C = 128; both convs on the tensor
// cores). The wrapper pads narrower widths with zero channels up to theirs.
//
// Replaces the TPU kernel ron_tensorflow_tpu/kernels/fused_conv_pool.py
// `fused_vgg_block1` (`_fused_vgg_block1_impl` -> `_block1_kernel`), which
// covers block 1 and block 2. Numerics follow that kernel: weights rounded
// to bf16, f32 sums, conv A's output rounded to bf16 before conv B, SAME
// zero padding for both convs (rows and columns of the conv A map outside
// the image are 0, not relu(b1): fused_conv_pool.py:219-227), the pool on
// f32, one rounding of the pooled value to bf16. The TPU kernel runs conv B
// on the MXU, bf16 x bf16 into f32; so do these, on the tensor cores.
//
// Block 1. A persistent grid, one block of 512 threads per SM, walks 16 x 32
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
//
// Every other width (`fused_vgg_block2_kernel`). At block 2's [32, 160, 160,
// 64] -> 128 the convs are 362.4 GFLOP (0.366 ms at 989 TFLOP/s) against
// ~158 MB of input and output (0.047 ms): bound by operations. Block 1's
// 16 x 32 tile does not fit here: at C = 128 its conv A map with halo
// (18 x 34 x 128 bf16, 156 672 B) and the input with its 2-pixel halo
// (20 x 36 x 64, 92 160 B) exceed the 232 448 B a block may have, and conv
// B's accumulators for 512 pixels x 128 channels would fill the register
// file. So a tile is 8 x 32 conv outputs, and per tile:
// - X: the input tile with its 2-pixel halo, 12 x 36 pixels x one 64-channel
//   chunk (55 296 B; zero outside the image and past Ci), by cp.async; loaded
//   once a tile when Ci <= 64, else once per use of each chunk.
// - conv A on the tensor cores (the mainloop with a 36-pixel-wide A tile):
//   its 10 x 34 = 340 output pixels are 6 M-tiles of 64 rows, each lane's
//   ldmatrix row address that of its pixel; warpgroup g takes M-tiles g and
//   g + 4. Bias, ReLU (0 outside the image), bf16, written straight into
//   Y, a 10 x 34 A tile of conv B per 64-channel chunk of C (43 520 B).
// - conv B: the mainloop on Y, one 64-pixel M-tile (2 conv rows) a
//   warpgroup and one 64-channel chunk of outputs at a time (32 f32
//   accumulators a thread, 32 more for conv A), summed over the chunks of
//   C; bias, ReLU, pool and the store as block 1's, from a staging buffer
//   of its own.
// - Y holds two chunks: where C <= 128 (block 2), conv A runs once a tile
//   and the outputs' chunks reuse it; a wider C recomputes conv A's chunks
//   for each chunk of outputs (C / 64 times), so any C fits.
// - B: each (conv, chunk pair)'s [9][64][64] weights (72 KB) are loaded
//   whole, by cp.async with K-E's `load_slab`, where the previous use was
//   another pair: the copies do not overlap the MMAs (6 loads a tile at
//   C = 128). Overlapping them, and balancing conv A's 6 M-tiles over 4
//   warpgroups, is work for a later version.
// Shared memory: 73 728 (B) + 55 296 (X) + 2 x 43 520 (Y) + 8 192 (staging)
// + 1 024 (alignment) = 225 280 B.

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

// --------------------------------------------------------------------------
// Every other width: both convs on the tensor cores.

constexpr int kRows2 = 8;                  // conv output rows per tile (kTileW = 32 cols)
constexpr int kYW = kInW;                   // conv A's output (conv B's A tile): 10 x 34
constexpr int kYPixels = (kRows2 + 2) * kYW;
constexpr int kX2H = kRows2 + 4, kX2W = kTileW + 4;  // conv A's input: 12 x 36
constexpr int kAMTiles = (kYPixels + 63) / 64;     // conv A's M-tiles
constexpr int kX2Bytes = kX2H * kX2W * kC * 2;
constexpr int kYBytes = kYPixels * kC * 2;         // one 64-channel chunk
constexpr int kYSlots = 2;                          // chunks of C that Y keeps
constexpr int kStage2Bytes = (kRows2 / 2) * (kTileW / 2) * kC * 2;
constexpr int kSmem2Bytes = kWBytes + kX2Bytes + kYSlots * kYBytes + kStage2Bytes + 1024;  // + alignment
static_assert(kAMTiles <= 8, "conv A's M-tiles: two a warpgroup at most");
static_assert(kRows2 / 2 == kThreads / 128, "conv B: one M-tile (two conv rows) a warpgroup");
static_assert(kX2Bytes % 1024 == 0 && kYBytes % 128 == 0, "A tiles keep their 128-byte rows aligned");

// The weights of one (conv, chunk pair) in B, [9][64 co][64 ci] from w [9][cout][cin]: the copy only
// where the block holds another pair (`loaded`, the same in every thread).
__device__ __forceinline__ void use_weights(int id, int& loaded, uint32_t w_smem, const uint16_t* w, int cin,
                                            int cout, int co0, int ci0) {
  if (id == loaded) return;
  __syncthreads();  // every warpgroup's MMAs on the old pair have retired
  for (int dy = 0; dy < 3; ++dy) load_slab(w_smem, w, cin, cout, dy, co0, ci0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  loaded = id;
}

// Input channels ci0.. of the tile's 12 x 36 input pixels from (y0 - 2, x0 - 2) into X; zero outside the
// image and past cin.
__device__ __forceinline__ void load_x(uint32_t x_smem, const uint16_t* ximg, const uint16_t* x, int y0, int x0,
                                       int height, int width, int cin, int ci0) {
  __syncthreads();  // no warpgroup reads X any more
  for (int v = tid_here(); v < kX2H * kX2W * 8; v += kThreads) {
    const int p = v >> 3, c = v & 7;
    const int r = p / kX2W, col = p - r * kX2W;
    const int gy = y0 - 2 + r, gx = x0 - 2 + col, ch = ci0 + 8 * c;
    const bool valid = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < cin;
    cp_async16(x_smem + a_offset(p, c), valid ? ximg + (static_cast<size_t>(gy) * width + gx) * cin + ch : x,
               valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// This lane's X pixel (at tap (0, 0)) for conv A's M-tile mt: its row's conv A output pixel, 10 x 34 from
// (y0 - 1, x0 - 1), shifted into the 36-wide X tile; rows past the 340 pixels read pixel 0, unused.
__device__ __forceinline__ int conv_a_pixel(int mt) {
  const int tid = tid_here();
  int m = 64 * mt + 16 * ((tid >> 5) & 3) + lane_row(tid & 31);
  if (m >= kYPixels) m = 0;
  const int r = m / kYW;
  return r * kX2W + (m - r * kYW);
}

// Bias, ReLU and bf16 of conv A's M-tile mt into Y (channels 8j + 2q, 8j + 2q + 1 of accumulator rows
// lane / 4 and lane / 4 + 8); pixels outside the image are conv B's zero padding.
__device__ __forceinline__ void conv_a_to_y(const float (&acc)[1][32], int mt, const float* bias,
                                            unsigned char* y, int y0, int x0, int height, int width) {
  const int tid = tid_here(), lane = tid & 31, q = lane & 3;
  const int base = 64 * mt + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = base + 8 * h;
    if (m >= kYPixels) continue;
    const int r = m / kYW, col = m - r * kYW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + col;
    const bool inside = gy >= 0 && gy < height && gx >= 0 && gx < width;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = 8 * j + 2 * q;
      const float lo = inside ? fmaxf(acc[0][4 * j + 2 * h] + bias[co], 0.0f) : 0.0f;
      const float hi = inside ? fmaxf(acc[0][4 * j + 2 * h + 1] + bias[co + 1], 0.0f) : 0.0f;
      *reinterpret_cast<uint32_t*>(y + a_offset(m, j) + 4 * q) = pack_bf16x2(lo, hi);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_vgg_block2_kernel(const uint16_t* __restrict__ x,   // [B, H, W, Ci] bf16, Ci a multiple of 8
                        const uint16_t* __restrict__ w1,  // [9, C, Ci] bf16
                        const float* __restrict__ b1,     // [C]
                        const uint16_t* __restrict__ w2,  // [9, C, C] bf16
                        const float* __restrict__ b2,     // [C]
                        uint16_t* __restrict__ out,       // [B, H/2, W/2, C] bf16, C a multiple of 64
                        int batch, int height, int width, int cin, int c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t w_smem = smem_u32(smem);  // B operand, 1024-aligned
  const uint32_t x_smem = w_smem + kWBytes;
  unsigned char* ys = smem + kWBytes + kX2Bytes;  // Y's slots
  uint16_t* staging = reinterpret_cast<uint16_t*>(ys + kYSlots * kYBytes);

  const int nci = (cin + kC - 1) / kC, nc = c / kC;
  const bool resident = nc <= kYSlots;  // conv A once a tile
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kRows2 - 1) / kRows2;
  const int tiles = tiles_x * tiles_y * batch;
  int loaded = -1;  // the (conv, chunk pair) in B: 2 (k nci + j) for conv A, 2 (n nc + k) + 1 for conv B
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const int x0 = tx * kTileW, y0 = ty * kRows2;
    const uint16_t* ximg = x + static_cast<size_t>(b) * height * width * cin;
    if (nci == 1) load_x(x_smem, ximg, x, y0, x0, height, width, cin, 0);

    for (int n = 0; n < nc; ++n) {  // a 64-channel chunk of conv B's outputs
      float acc[1][32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[0][k] = 0.0f;
      for (int k = 0; k < nc; ++k) {  // a 64-channel chunk of C: conv A's outputs, conv B's inputs
        unsigned char* y = ys + (resident ? k : 0) * kYBytes;
        if (!resident || n == 0) {
          __syncthreads();  // no warpgroup reads this Y slot any more
          const int group = tid_here() >> 7;
          for (int round = 0; round < 2; ++round) {
            const int mt = group + 4 * round;
            float acc_a[1][32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc_a[0][i] = 0.0f;
            for (int j = 0; j < nci; ++j) {
              if (nci > 1) load_x(x_smem, ximg, x, y0, x0, height, width, cin, j * kC);
              use_weights(2 * (k * nci + j), loaded, w_smem, w1, cin, c, k * kC, j * kC);
              if (mt < kAMTiles) {
                const int p[1] = {conv_a_pixel(mt)};
                conv_chunk_mma<kX2W>(acc_a, x_smem, w_smem, p);
              }
            }
            if (mt < kAMTiles) conv_a_to_y(acc_a, mt, b1 + k * kC, y, y0, x0, height, width);
          }
          __syncthreads();  // Y's chunk k is written
        }
        use_weights(2 * (n * nc + k) + 1, loaded, w_smem, w2, c, c, n * kC, k * kC);
        const int tid = tid_here();
        const int p[1] = {lane_pixel(tid >> 7, (tid >> 5) & 3, tid & 31)};
        conv_chunk_mma<kYW>(acc, smem_u32(y), w_smem, p);
      }
      __syncthreads();  // the last tile's pooled values are stored
      pool_tile_to_staging(acc, b2 + n * kC, staging);
      __syncthreads();
      store_staging<uint16_t, kRows2 / 2>(staging, out + static_cast<size_t>(b) * (height / 2) * (width / 2) * c,
                                          y0 / 2, x0 / 2, height / 2, width / 2, n * kC, c);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int fused_vgg_block1_smem_bytes() { return kSmemBytes; }
extern "C" int fused_vgg_block2_smem_bytes() { return kSmem2Bytes; }

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

// Any Ci (a multiple of 8) and C (a multiple of 64): x [B, H, W, Ci], w1 [9][C][Ci], w2 [9][C][C] bf16;
// b1, b2 [C] f32; out [B, H/2, W/2, C] bf16.
extern "C" int fused_vgg_block2(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, int batch, int height, int width, int cin, int c,
                                cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 2 != 0 || width % 2 != 0 || cin <= 0 || cin % 8 != 0 || c <= 0 || c % kC != 0 ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>(batch) * ((height + kRows2 - 1) / kRows2) *
                          ((width + kTileW - 1) / kTileW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_vgg_block2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem2Bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  fused_vgg_block2_kernel<<<grid, kThreads, kSmem2Bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1), static_cast<const float*>(b1),
      static_cast<const uint16_t*>(w2), static_cast<const float*>(b2), static_cast<uint16_t*>(out), batch,
      height, width, cin, c);
  return static_cast<int>(cudaGetLastError());
}
