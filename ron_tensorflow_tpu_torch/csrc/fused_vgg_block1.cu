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
// ~158 MB of input and output (0.047 ms): bound by operations. A tile is
// 8 x 32 conv outputs (block 1's 16 x 32 does not fit: its conv A map at
// C = 128 with halo, 18 x 34 x 128 bf16, is 156 672 B). Per tile:
// - X: the input with its 2-pixel halo, 12 x 36 pixels x one 64-channel
//   chunk of Ci (55 296 B, zero outside the image and past Ci);
// - conv A (Ci -> C) on its 10 x 34 = 340 output pixels, 6 M-tiles of 64
//   rows, each lane's ldmatrix row address that of its pixel; bias, ReLU
//   (0 outside the image: conv B's SAME padding), bf16, by stmatrix into
// - Y: conv B's A tile, 10 x 34 pixels x two 64-channel chunks (87 040 B);
// - conv B (C -> C) on its 4 M-tiles (2 conv rows each), then bias, ReLU,
//   the 2 x 2 pool in registers and a 16-byte store from a staging buffer.
// Bound in practice: the tensor cores' busy time is ~32 300 cycles a tile
// (6 M-tiles of conv A, 4 of conv B, 36 K-steps each) against ~45 000
// measured (`tools/time_conv.py --trace`): conv A's passes run at ~85% of
// the tensor rate (their ldmatrix and B reads need ~128 B a cycle of
// shared memory), the consumers wait on the weight ring ~12% of the time
// (the same with a 25% deeper ring and on half the SMs: neither latency
// nor L2 bandwidth), and conv A's epilogue (~5%) and the pool and store
// (~5%) keep both consumers off the tensor cores.
// The design, warp-specialised on a persistent grid (one 384-thread block
// per SM walking the tiles):
// - Warpgroup 0 is the producer (`setmaxnreg` down to 40). Its warp 0 (one
//   thread) streams the weights; its warps 1-3 load X by cp.async (zero-fill
//   at the halo and past Ci), counted into an mbarrier
//   (`cp.async.mbarrier.arrive.noinc`). X is handed back by both consumers
//   after the tile's last conv A pass, so the next tile's input loads under
//   this tile's conv B, pool and store.
// - The weights stream as slabs, one tap of one (Ci chunk, output group),
//   [co][64 ci], through a ring of kUnits 8 KB units: a conv A slab (64 co)
//   takes one unit, a 128-wide conv B slab two. The wrapper lays w1 and w2
//   out as the exact image of the slabs in order (the 128-byte swizzle of
//   `w_offset`, `_block2_weight_image`; kept until the weights change), so
//   a slab is one
//   `cp.async.bulk` with `complete_tx` on its first unit's full mbarrier;
//   each consumer warp hands a unit back on its empty mbarrier once
//   `wgmma.wait_group` has retired the last MMA that reads it. Both
//   consumers read each slab, so a tile streams it once: at C = 128, 36
//   slabs, 442 368 B.
// - Warpgroups 1 and 2 are the consumers (`setmaxnreg` up to 232). Conv A:
//   M-tiles 3g..3g+2 of consumer g, 3 + 3 (no warpgroup idle; 44 of the 384
//   rows are padding), at N = 64, one 64-channel chunk of its output a pass
//   (bias, ReLU and bf16 in one `cvt.rn.relu.bf16x2`, stored by stmatrix);
//   conv B: M-tiles 2g, 2g+1, and at C = 128 `wgmma.m64n128k16`, all 128
//   outputs from one fetch of each A fragment (128 accumulators a thread,
//   born after conv A's die). Conv A at N = 128 (192 accumulators) spills
//   even at 240 registers and serialises its wgmmas: measured slower; so
//   did a 2-CTA cluster multicasting each slab (the pair runs at the pace
//   of its slower CTA). Two named barriers a Y filling between the
//   consumers: Y free (both have read the last filling) before the first
//   write, Y written before conv B.
// - Every other C takes the general instantiation, conv B at N = 64: Y
//   holds two 64-channel chunks of conv A's map, so for C > 128 conv A is
//   recomputed, a pair of chunks at a time, for each 64-channel output
//   group (conv B's 64 accumulators live across it). Ci > 64: X holds one
//   Ci chunk, loaded once per (conv A pass, chunk).
// What this does about the first version's four costs: (1) the weights were
// reloaded whole, 6 x 72 KB a tile with every tensor core idle: now they
// stream under the MMAs; (2) conv A's 6 M-tiles ran on 4 warpgroups in two
// rounds: now 3 + 3; (3) conv B ran at N = 64 and read each A fragment
// twice: now N = 128, once; (4) every stage sat behind a __syncthreads and
// the next tile's input loaded after the last store: now two named barriers
// between two warpgroups, and the input loads ahead.
// Shared memory: 8 x 8 192 (ring) + 55 296 (X) + 87 040 (Y) + 16 384
// (pooled staging, 8 KB a consumer) + 160 (mbarriers, a junk row for
// stmatrix) + 1 024 (alignment) = 225 440 B.

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
// Every other width: both convs on the tensor cores, warp-specialised.

constexpr int kRows2 = 8;                            // conv output rows per tile (kTileW = 32 cols)
constexpr int kYW = kInW;                            // conv A's output (conv B's A tile): 10 x 34
constexpr int kYPixels = (kRows2 + 2) * kYW;
constexpr int kX2H = kRows2 + 4, kX2W = kTileW + 4;  // conv A's input: 12 x 36
constexpr int kX2Bytes = kX2H * kX2W * kC * 2;
constexpr int kYBytes = kYPixels * kC * 2;           // one 64-channel chunk
constexpr int kYSlots = 2;                           // chunks of C that Y keeps
constexpr int kThreads2 = 384;                       // the producer warpgroup and two consumers
constexpr int kXLoaders = 96;                        // the producer's warps 1-3
constexpr int kConsumerWarps = 8;
constexpr int kUnits = 8;                            // the weight ring: 8 units of 8 KB
constexpr int kUnitBytes = 64 * kC * 2;              // a slab: one tap x 64 or 128 co x 64 ci, 1 or 2 units
constexpr int kAMT = 3;                              // conv A's M-tiles a consumer (6 in all)
constexpr int kBMT = 2;                              // conv B's M-tiles a consumer (4 in all)
constexpr int kPoolBytes = 2 * kBMT * (kTileW / 2) * 128 * 2;  // both consumers' pooled rows at N = 128, 8 KB each
constexpr int kXOff = kUnits * kUnitBytes;
constexpr int kYOff = kXOff + kX2Bytes;
constexpr int kPoolOff = kYOff + kYSlots * kYBytes;
constexpr int kBarOff = kPoolOff + kPoolBytes;       // full[kUnits], empty[kUnits], X full, X empty
constexpr int kJunkOff = kBarOff + 16 * kUnits + 16;  // 16 bytes that stmatrix rows past conv A's map go to
constexpr int kSmem2Bytes = kJunkOff + 16 + 1024;     // + alignment
static_assert(2 * kAMT * 64 >= kYPixels && (2 * kAMT - 1) * 64 < kYPixels, "conv A: 6 M-tiles, 3 a consumer");
static_assert(2 * kBMT * 64 == kRows2 * kTileW, "conv B: 4 M-tiles of 2 conv rows, 2 a consumer");
static_assert(kXOff % 1024 == 0 && kYOff % 1024 == 0 && kYBytes % 128 == 0 && kUnitBytes % 1024 == 0,
              "B stages keep the swizzle's 1024-byte alignment, A tiles their 128-byte rows");
static_assert(kSmem2Bytes <= 232448, "a block's shared memory on the H100");
static_assert((kUnits & (kUnits - 1)) == 0 && kJunkOff % 16 == 0, "ring index arithmetic; an aligned junk row");

#ifdef RON_KB2_TRACE
// clock64() split of where a tile's time goes, for `tools/time_conv.py --trace`: per block, per role
// (consumer 0, consumer 1, weight producer, X loader), cycles summed over the block's tiles.
constexpr int kTraceBlocks = 256, kTraceSlots = 10;
__device__ long long kb2_trace[kTraceBlocks][4][kTraceSlots];
#define KB2_T(var) const long long var = clock64()
#define KB2_ADD(slot, since) (trace[slot] += clock64() - (since))
#define KB2_TRACE_DECL long long trace[kTraceSlots] = {}
#define KB2_TRACE_SAVE(role)                                                                     \
  if ((threadIdx.x & 127) == 0 || threadIdx.x == 32) {                                           \
    for (int i = 0; i < kTraceSlots; ++i) kb2_trace[blockIdx.x % kTraceBlocks][role][i] = trace[i]; \
  }
#else
#define KB2_T(var)
#define KB2_ADD(slot, since)
#define KB2_TRACE_DECL
#define KB2_TRACE_SAVE(role)
#endif

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Returns once the phase of the barrier with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// `bytes` from global src to shared dst by the bulk-copy engine, counted into bar's transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// bar receives this thread's arrival once all of its earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d += A (64 x 16, registers) * B (16 x 128, shared memory by descriptor).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// d += A * B at N = 2 kAcc (64 or 128).
template <int kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (kAcc == 32) {
    wgmma_m64n64k16(d, a, desc);
  } else {
    static_assert(kAcc == 64, "N = 64 or 128");
    wgmma_m64n128k16(d, a, desc);
  }
}

template <int kMT, int kAcc>
__device__ __forceinline__ void fence_accs(float (&acc)[kMT][kAcc]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int k = 0; k < kAcc; ++k) asm volatile("" : "+f"(acc[i][k])::"memory");
}

template <int kMT, int kAcc>
__device__ __forceinline__ void zero_accs(float (&acc)[kMT][kAcc]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[i][k] = 0.0f;
}

// A consumer's view of the weight ring: slabs arrive in the order the producer sends them, a slab in
// 1 or 2 consecutive units (never across the ring's end: every run of 2-unit slabs starts at an even
// unit); `idx` is the first unit of the oldest slab this consumer still reads. Each unit has a full and
// an empty barrier; the producer completes every unit's full barrier once a lap (a slab's first unit by
// its bytes, the second by an arrival), and each consumer warp arrives on each unit's empty one.
struct Ring {
  uint32_t base;  // unit 0
  uint32_t bars;  // full barrier of unit 0; unit u's at + 8 u, its empty barrier at + 8 (kUnits + u)
  int idx;
#ifdef RON_KB2_TRACE
  long long waited;
#endif
  __device__ __forceinline__ uint32_t unit(int d) const { return base + ((idx + d) & (kUnits - 1)) * kUnitBytes; }
  // Waits for the slab whose first unit is idx + d to have landed.
  __device__ __forceinline__ void wait_full(int d) {
    KB2_T(t0);
    const int i = idx + d;
    mbar_wait(bars + 8 * (i & (kUnits - 1)), (i / kUnits) & 1);
#ifdef RON_KB2_TRACE
    waited += clock64() - t0;
#endif
  }
  // Hands the oldest slab's kU units back to the producer: every MMA of this warp that reads it has retired.
  template <int kU>
  __device__ __forceinline__ void release() {
    if ((tid_here() & 31) == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) mbar_arrive(bars + 8 * (kUnits + ((idx + u) & (kUnits - 1))));
    }
    idx += kU;
  }
};

// Step S of the 36 K-steps (9 taps x 4 of 16 channels) of one conv pass; tap S / 4's slab is the
// (S / 4)-th slab from the ring. Slab q - 1 is released once step 4q's wait has retired its last MMA.
template <int S, int kStride, int kMT, int kAcc>
__device__ __forceinline__ void ring_steps(float (&acc)[kMT][kAcc], uint32_t (&a)[2][kMT][4], uint32_t a_smem,
                                           const int (&p)[kMT], int khalf, Ring& ring) {
  if constexpr (S < kSteps) {
    constexpr int buf = S & 1, kk = S % 4, kU = kAcc / 32;  // units a slab
    constexpr int d = (S > 0 && kk == 0) ? kU : 0;          // the slab's distance from the oldest held
    if constexpr (kk == 0) ring.wait_full(d);
    wgmma_fence();
    const uint64_t desc = b_desc(ring.unit(d), 0, kk);
#pragma unroll
    for (int i = 0; i < kMT; ++i) wgmma_rs(acc[i], a[buf][i], desc);
    wgmma_commit();
    if constexpr (S + 1 < kSteps) {
      wgmma_wait<1>();  // step S - 1 is done: its A registers may be refilled, its slab released
      if constexpr (d > 0) ring.release<kU>();
      load_a<S + 1, kStride>(a[buf ^ 1], a_smem, p, khalf);
    }
    ring_steps<S + 1, kStride>(acc, a, a_smem, p, khalf, ring);
  }
}

// acc[i] += one conv pass (9 taps x one 64-channel chunk of A) for this warpgroup's M-tile i, whose
// lanes' pixels (at tap (0, 0)) are p[i] in an A tile at a_smem kStride pixels wide; B from the ring,
// 9 slabs. Returns with every MMA retired and the 9 slabs released.
template <int kStride, int kMT, int kAcc>
__device__ __forceinline__ void ring_conv(float (&acc)[kMT][kAcc], uint32_t a_smem, const int (&p)[kMT],
                                          Ring& ring) {
  const int khalf = (tid_here() & 31) >> 4;
  uint32_t a[2][kMT][4];
  load_a<0, kStride>(a[0], a_smem, p, khalf);
  fence_accs(acc);
  ring_steps<0, kStride>(acc, a, a_smem, p, khalf, ring);
  wgmma_wait<0>();
  ring.release<kAcc / 32>();
  fence_accs(acc);
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

// relu(lo), relu(hi) rounded to bf16 and packed, lo in the low half: one instruction. The rounding keeps
// the sign, so this is the rounding of max(x, 0).
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

// Bias, ReLU and bf16 of this consumer's conv A M-tiles (M-tile kAMT g + i in acc[i]; kAcc / 4 groups j of
// 8 channels from the bias pointer's channel 0, channels 8j + 2q, 8j + 2q + 1 of accumulator rows lane / 4
// and lane / 4 + 8) into Y, whose 64-channel chunks lie kYBytes apart: stmatrix, 8 pixels x 8 channels a
// matrix, four a store (rows h = 0, 1 of two groups j). Pixels outside the image are conv B's zero
// padding; rows past the map's 340 pixels go to the junk row. The bias is read once a group.
template <int kAcc>
__device__ __forceinline__ void conv_a_to_y(const float (&acc)[kAMT][kAcc], int g, const float* __restrict__ bias,
                                            uint32_t y, uint32_t junk, int y0, int x0, int height, int width) {
  const int tid = tid_here(), lane = tid & 31, q = lane & 3, wig = (tid >> 5) & 3;
  uint32_t inside = 0;  // bit 2i + h: the pixel of this lane's accumulator row of M-tile i, half h
#pragma unroll
  for (int i = 0; i < kAMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * (kAMT * g + i) + 16 * wig + 8 * h + (lane >> 2);
      const int r = m / kYW, col = m - r * kYW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + col;
      inside |= static_cast<uint32_t>(m < kYPixels && gy >= 0 && gy < height && gx >= 0 && gx < width) << (2 * i + h);
    }
#pragma unroll
  for (int jp = 0; jp < kAcc / 8; ++jp) {
    const float2 bj[2] = {__ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 2 * q)),
                          __ldg(reinterpret_cast<const float2*>(bias + 16 * jp + 8 + 2 * q))};
#pragma unroll
    for (int i = 0; i < kAMT; ++i) {
      uint32_t v[4];  // matrices (h, j) = (0, 2jp), (1, 2jp), (0, 2jp + 1), (1, 2jp + 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = k & 1, j = 2 * jp + (k >> 1);
        const float2 b = bj[k >> 1];
        const uint32_t bits = relu_bf16x2(acc[i][4 * j + 2 * h] + b.x, acc[i][4 * j + 2 * h + 1] + b.y);
        v[k] = (inside >> (2 * i + h)) & 1u ? bits : 0u;
      }
      // this lane's row address: matrix lane / 8, row lane % 8
      const int m = 64 * (kAMT * g + i) + 16 * wig + 8 * ((lane >> 3) & 1) + (lane & 7);
      const int chunk = 2 * jp + (lane >> 4);
      const uint32_t addr = m < kYPixels ? y + (chunk >> 3) * kYBytes + a_offset(m, chunk & 7) : junk;
      stmatrix_x4(addr, v[0], v[1], v[2], v[3]);
    }
  }
}

// Bias, ReLU and the 2x2 max of conv B's kBMT M-tiles of this consumer (N = 2 kAcc channels from the bias
// pointer's channel 0) into its staging, [kBMT pooled rows][16 cols][N ch] bf16: the layout of
// `pool_tile_to_staging`, a consumer's warps numbered within it.
template <int kAcc>
__device__ __forceinline__ void pool_to_staging2(const float (&acc)[kBMT][kAcc], const float* __restrict__ bias,
                                                 uint16_t* staging) {
  constexpr int kN = 2 * kAcc;
  const int tid = tid_here(), wig = (tid >> 5) & 3, lane = tid & 31;
  const int r = lane >> 2, q = lane & 3;
  const int px = 4 * wig + (r >> 1);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * q));
#pragma unroll
    for (int i = 0; i < kBMT; ++i) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = fmaxf(acc[i][4 * j + e], acc[i][4 * j + 2 + e]);  // rows y, y+1
        m[e] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));           // cols x, x+1
      }
      if ((r & 1) == 0) {
        reinterpret_cast<uint32_t*>(staging)[((i * (kTileW / 2) + px) * kN + 8 * j + 2 * q) >> 1] =
            relu_bf16x2(m[0] + b.x, m[1] + b.y);
      }
    }
  }
}

// A consumer's staged pooled rows ([kBMT][16][kN]) to pooled rows py0.., cols px0.., channels co0.. of
// out_img ([out_h, out_w, cout]), 16-byte vectors by the consumer's 128 threads; past the map dropped.
template <int kN>
__device__ __forceinline__ void store_pooled(const uint16_t* staging, uint16_t* out_img, int py0, int px0,
                                             int out_h, int out_w, int co0, int cout) {
  constexpr int kPixVecs = kN / 8;
  constexpr int kVecs = kBMT * (kTileW / 2) * kPixVecs;
  for (int v = tid_here() & 127; v < kVecs; v += 128) {
    const int c = v % kPixVecs, pix = v / kPixVecs;
    const int py = py0 + pix / (kTileW / 2), px = px0 + pix % (kTileW / 2);
    if (py < out_h && px < out_w) {
      *reinterpret_cast<uint4*>(out_img + (static_cast<size_t>(py) * out_w + px) * cout + co0 + 8 * c) =
          reinterpret_cast<const uint4*>(staging)[v];
    }
  }
}

// The block-2 kernel. kNB: conv B's N, 128 at C = 128 (one output group), else 64 (C / 64 groups); conv A
// runs at N = 64, one 64-channel chunk of its output a pass. w1 and w2 are the slab images of
// `_block2_weight_image`: w1 [C / 64][ceil(Ci / 64)][9][64][64], w2 [C / kNB][C / 64][9][kNB][64], each
// [co][64 ci] slab in the 128-byte swizzle of `w_offset`, Ci zero-padded to whole chunks.
template <int kNB>
__global__ void __launch_bounds__(kThreads2, 1)
fused_vgg_block2_kernel(const uint16_t* __restrict__ x,   // [B, H, W, Ci] bf16, Ci a multiple of 8
                        const uint16_t* __restrict__ w1,  // slab image of conv A's weights, bf16
                        const float* __restrict__ b1,     // [C]
                        const uint16_t* __restrict__ w2,  // slab image of conv B's weights, bf16
                        const float* __restrict__ b2,     // [C]
                        uint16_t* __restrict__ out,       // [B, H/2, W/2, C] bf16, C a multiple of 64
                        int batch, int height, int width, int cin, int c) {
  // At C = 128 (kNB = 128) each loop over output groups and Y fillings runs once, known to the compiler,
  // so conv B's 128 accumulators are born after conv A's die.
  constexpr bool kOneGroup = kNB == 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring_smem = smem_u32(smem), x_smem = ring_smem + kXOff, bars = ring_smem + kBarOff;
  const uint32_t x_full = bars + 16 * kUnits, x_empty = x_full + 8;
  const uint32_t y_smem = ring_smem + kYOff, junk = ring_smem + kJunkOff;

  const int nci = (cin + kC - 1) / kC, nc = kOneGroup ? 2 : c / kC;
  const int ng = kOneGroup ? 1 : nc;                               // output groups
  const int nfill = kOneGroup ? 1 : (nc + kYSlots - 1) / kYSlots;  // Y fillings an output group
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kRows2 - 1) / kRows2;
  const int tiles = tiles_x * tiles_y * batch;

  if (threadIdx.x == 0) {
    for (int u = 0; u < kUnits; ++u) {
      mbar_init(bars + 8 * u, 1);                            // the producer's expect_tx (then the bytes) or arrival
      mbar_init(bars + 8 * (kUnits + u), kConsumerWarps);    // each consumer warp, after its MMAs
    }
    mbar_init(x_full, kXLoaders);
    mbar_init(x_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    KB2_TRACE_DECL;
    KB2_T(start);
    if (threadIdx.x == 0) {
      // warp 0, one thread: the weight slabs, in the consumers' order
      int idx = 0;
      const auto push = [&](const uint16_t* src, uint32_t bytes) {
        const int units = bytes / kUnitBytes, s = idx & (kUnits - 1);
        KB2_T(t0);
        for (int u = 0; u < units; ++u) mbar_wait(bars + 8 * (kUnits + s + u), (((idx + u) / kUnits) & 1) ^ 1);
        KB2_ADD(1, t0);
        mbar_expect_tx(bars + 8 * s, bytes);
        for (int u = 1; u < units; ++u) mbar_arrive(bars + 8 * (s + u));
        bulk_load(ring_smem + s * kUnitBytes, src, bytes, bars + 8 * s);
        idx += units;
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int n = 0; n < ng; ++n)
          for (int f = 0; f < nfill; ++f) {
            const int k0 = kYSlots * f, k1 = min(k0 + kYSlots, nc);  // chunks of C this filling of Y holds
            for (int k = k0; k < k1; ++k)
              for (int j = 0; j < nci; ++j)
                for (int t = 0; t < 9; ++t) push(w1 + (static_cast<size_t>(k * nci + j) * 9 + t) * kC * kC, kUnitBytes);
            for (int k = k0; k < k1; ++k)
              for (int t = 0; t < 9; ++t) push(w2 + (static_cast<size_t>(n * nc + k) * 9 + t) * kNB * kC, kNB * kC * 2);
          }
      KB2_ADD(0, start);
      KB2_TRACE_SAVE(2);
    } else if (threadIdx.x >= 32) {
      // warps 1-3: the input tile, one Ci chunk a load
      int xi = 0;
      const auto load_x = [&](const uint16_t* ximg, int y0, int x0, int ci0) {
        KB2_T(t0);
        mbar_wait(x_empty, (xi & 1) ^ 1);
        KB2_ADD(1, t0);
        for (int v = threadIdx.x - 32; v < kX2H * kX2W * 8; v += kXLoaders) {
          const int p = v >> 3, cc = v & 7;
          const int r = p / kX2W, col = p - r * kX2W;
          const int gy = y0 - 2 + r, gx = x0 - 2 + col, ch = ci0 + 8 * cc;
          const bool valid = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < cin;
          cp_async16(x_smem + a_offset(p, cc), valid ? ximg + (static_cast<size_t>(gy) * width + gx) * cin + ch : x,
                     valid);
        }
        cp_async_arrive_noinc(x_full);
        ++xi;
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
        const uint16_t* ximg = x + static_cast<size_t>(b) * height * width * cin;
        if (nci == 1) {
          load_x(ximg, ty * kRows2, tx * kTileW, 0);  // kept for the whole tile
        } else {  // one load a conv A pass and Ci chunk
          for (int n = 0; n < ng; ++n)
            for (int k = 0; k < nc; ++k)
              for (int j = 0; j < nci; ++j) load_x(ximg, ty * kRows2, tx * kTileW, j * kC);
        }
      }
      KB2_ADD(0, start);
      KB2_TRACE_SAVE(3);
    }
  } else {
    // ---- consumer warpgroups 1 and 2 -----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    KB2_TRACE_DECL;
    KB2_T(start);
    const int g = (threadIdx.x >> 7) - 1;
    Ring ring{ring_smem, bars, 0};
    int xi = 0;
    uint16_t* staging = reinterpret_cast<uint16_t*>(smem + kPoolOff + g * (kPoolBytes / 2));

    // One conv A pass: 64 of conv A's output channels (all Ci chunks) into acc; X is handed back after
    // the pass where `last` (the tile's last use of a kept X), or after each Ci chunk.
    const auto conv_a = [&](float (&acc)[kAMT][kC / 2], bool last) {
      zero_accs(acc);
      int p[kAMT];
#pragma unroll
      for (int i = 0; i < kAMT; ++i) p[i] = conv_a_pixel(kAMT * g + i);
      for (int j = 0; j < nci; ++j) {
        KB2_T(t0);
        mbar_wait(x_full, xi & 1);
        KB2_ADD(2, t0);
        ring_conv<kX2W>(acc, x_smem, p, ring);
        if (nci > 1 || last) {
          if ((tid_here() & 31) == 0) mbar_arrive(x_empty);
          ++xi;
        }
      }
    };
    const auto conv_b = [&](float (&acc)[kBMT][kNB / 2], int slot) {
      const int tid = tid_here();
      int p[kBMT];
#pragma unroll
      for (int i = 0; i < kBMT; ++i) p[i] = lane_pixel(kBMT * g + i, (tid >> 5) & 3, tid & 31);
      ring_conv<kYW>(acc, y_smem + slot * kYBytes, p, ring);
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
      const int x0 = tx * kTileW, y0 = ty * kRows2;
      for (int n = 0; n < ng; ++n) {
        float acc_b[kBMT][kNB / 2];
        for (int f = 0; f < nfill; ++f) {
          const int k0 = kYSlots * f, k1 = min(k0 + kYSlots, nc);
          for (int k = k0; k < k1; ++k) {
            float acc_a[kAMT][kC / 2];
            KB2_T(t0);
            conv_a(acc_a, nci == 1 && n == ng - 1 && k == nc - 1);
            KB2_ADD(6, t0);
            KB2_T(t1);
            if (k == k0) named_barrier(1, 256);  // Y free: both consumers are done with its last filling
            KB2_ADD(3, t1);
            KB2_T(t2);
            conv_a_to_y(acc_a, g, b1 + k * kC, y_smem + (k - k0) * kYBytes, junk, y0, x0, height, width);
            KB2_ADD(4, t2);
          }
          KB2_T(t3);
          named_barrier(1, 256);  // Y written
          KB2_ADD(3, t3);
          KB2_T(t4);
#ifdef RON_KB2_TRACE
          const long long waited = ring.waited;
#endif
          if (f == 0) zero_accs(acc_b);
          for (int k = k0; k < k1; ++k) conv_b(acc_b, k - k0);
          KB2_ADD(7, t4);
#ifdef RON_KB2_TRACE
          trace[8] += ring.waited - waited;
#endif
        }
        KB2_T(t5);
        named_barrier(2 + g, 128);  // this consumer's last store has read its staging
        pool_to_staging2(acc_b, b2 + n * kNB, staging);
        named_barrier(2 + g, 128);
        store_pooled<kNB>(staging, out + static_cast<size_t>(b) * (height / 2) * (width / 2) * c,
                          y0 / 2 + kBMT * g, x0 / 2, height / 2, width / 2, n * kNB, c);
        KB2_ADD(5, t5);
      }
    }
#ifdef RON_KB2_TRACE
    KB2_ADD(0, start);
    trace[1] = ring.waited;
#endif
    KB2_TRACE_SAVE(g);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// conv B's N for output width c: the slab width of its weight image.
int conv_b_n(int c) { return c == 128 ? 128 : kC; }

template <int kNB>
cudaError_t launch_block2(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                          int batch, int height, int width, int cin, int c, int grid, cudaStream_t stream) {
  const auto kernel = fused_vgg_block2_kernel<kNB>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem2Bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads2, kSmem2Bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1), static_cast<const float*>(b1),
      static_cast<const uint16_t*>(w2), static_cast<const float*>(b2), static_cast<uint16_t*>(out), batch, height,
      width, cin, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_vgg_block1_smem_bytes() { return kSmemBytes; }
extern "C" int fused_vgg_block2_smem_bytes() { return kSmem2Bytes; }
extern "C" int fused_vgg_block2_stages() { return kUnits; }
// conv B's N at output width c: the slab width of its weight image (conv A's is always 64).
extern "C" int fused_vgg_block2_conv_b_n(int c) { return conv_b_n(c); }

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

// Any Ci (a multiple of 8) and C (a multiple of 64): x [B, H, W, Ci] bf16; w1, w2 the slab images of
// `_block2_weight_image`, w1's 64 output channels wide, w2's `fused_vgg_block2_conv_b_n(c)`; b1, b2 [C] f32;
// out [B, H/2, W/2, C] bf16.
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
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  return static_cast<int>(conv_b_n(c) == 128
                              ? launch_block2<128>(x, w1, b1, w2, b2, out, batch, height, width, cin, c, grid, stream)
                              : launch_block2<kC>(x, w1, b1, w2, b2, out, batch, height, width, cin, c, grid, stream));
}

#ifdef RON_KB2_TRACE
// The clock64() split of the last traced launch: [kTraceBlocks][4 roles][kTraceSlots] int64 into host.
extern "C" int fused_vgg_block2_trace(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, kb2_trace, sizeof(kb2_trace)));
}
extern "C" int fused_vgg_block2_trace_blocks() { return kTraceBlocks; }
extern "C" int fused_vgg_block2_trace_slots() { return kTraceSlots; }
#endif
