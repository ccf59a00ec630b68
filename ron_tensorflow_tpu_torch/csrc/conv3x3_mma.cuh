// Tensor-core mainloop shared by the fused block-1 kernel (fused_vgg_block1.cu)
// and the conv kernel of conv3x3_relu_pool2.cu (K-D stem and K-E general): an
// implicit GEMM for a 3x3 SAME conv + bias + ReLU + 2x2/s2 max-pool over one
// 16 x 32 tile of conv outputs of one image, 64 output channels, one chunk of
// 64 input channels, NHWC, bf16 operands, f32 accumulation. The kernels differ
// only in how the input tile and the weights reach shared memory (conv1_1
// computed in place, or loaded; weights resident, or streamed by tap rows);
// all call `conv_tile_mma` and `pool_tile_to_staging`, so they sum in the same
// order and give the same bits for the same input tile.
//
// GEMM view of one tile: M = 512 conv output pixels, N = 64 output channels,
// K = 9 taps x 64 input channels, in 36 steps of K = 16 (tap-major).
//
//   A  the haloed input tile in shared memory, [18 rows][34 cols] pixels,
//      pixel-major, 64 bf16 (128 B) per pixel; the 16-byte chunk c of pixel p
//      sits at chunk c ^ (p % 8) (`a_offset`), so an ldmatrix of 8 pixels in a
//      row touches 32 distinct banks. For tap (dy, dx) the A rows are the
//      output pixels shifted by (dy, dx); each lane hands ldmatrix its own
//      row address, so the shift costs nothing.
//   B  the weights [9 taps][64 co][64 ci] bf16 (72 KB) in shared memory, in
//      the 128-byte swizzle that a wgmma descriptor reads (`w_offset`):
//      K-major, one 128-byte row per output channel, 8-row groups 1024 bytes
//      apart. Tap row dy (taps 3dy..3dy+2, 24 KB, `kSlabBytes`) is read only
//      by K-steps 12dy..12dy+11, so a caller may refill it once those have
//      retired: `conv_tile_mma` calls its `rows` hook before the first step
//      of tap rows 1 and 2 is issued (`before_row<dy>`) and just after
//      (`after_row<dy>`).
//   D  wgmma.m64n64k16 (A from registers, B by descriptor) into f32
//      registers. 4 warpgroups x 2 M-tiles of 64 pixels = 64 accumulators a
//      thread. M-tile mt holds tile rows 2mt and 2mt+1; warp w of a
//      warpgroup holds columns 8w..8w+7 of both rows, ordered so that its
//      accumulator rows r and r+8 are vertical neighbours and rows r and
//      r^1 (lanes 4 apart) horizontal ones: each 2x2 pool window lies in
//      one thread's registers and its xor-4 lane.
//
// The A fragments are double-buffered in registers: step s+1's ldmatrix runs
// while step s's wgmma does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_mma {

constexpr int kTileH = 16;  // conv output rows per tile
constexpr int kTileW = 32;  // conv output cols per tile
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;
constexpr int kC = 64;      // channels of one K or N chunk
constexpr int kThreads = 512;  // 4 warpgroups
constexpr int kSteps = 9 * kC / 16;
constexpr int kRowSteps = kSteps / 3;  // K-steps of one tap row

constexpr int kSlabBytes = 3 * kC * kC * 2;        // 24 576, one tap row of B

constexpr int kWBytes = 3 * kSlabBytes;           // 73 728, B operand
constexpr int kABytes = kInH * kInW * kC * 2;      // 78 336, A operand
constexpr int kStagingBytes = (kTileH / 2) * (kTileW / 2) * kC * 4;  // 32 768 as f32
static_assert(kStagingBytes <= kABytes, "the pooled tile is staged in the A buffer");
static_assert(kSlabBytes % 1024 == 0, "each tap row of B keeps the swizzle's 1024-byte alignment");

// Byte offset of 16-byte chunk c (channels 8c..8c+7) of haloed pixel p in A.
__device__ __forceinline__ uint32_t a_offset(int p, int c) {
  return static_cast<uint32_t>(p * 128 + ((c ^ (p & 7)) << 4));
}

// Byte offset of 16-byte chunk c (input channels 8c..8c+7) of output channel
// co of tap t in B (128-byte swizzle: chunk c ^ (co % 8)).
__device__ __forceinline__ uint32_t w_offset(int t, int co, int c) {
  return static_cast<uint32_t>(t * kC * 128 + co * 128 + ((c ^ (co & 7)) << 4));
}

// threadIdx.x, read where it is used: what is computed from it cannot be
// hoisted out of a caller's tile loop, where, kept live across the mainloop's
// 64 accumulators, it would be spilled.
__device__ __forceinline__ int tid_here() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// wgmma descriptor of B for tap t, K-step kk (16 input channels = 32 bytes):
// start address >> 4, leading offset 1 (unused by a swizzled K-major
// operand), stride 1024 bytes between 8-row groups, 128-byte swizzle. The B
// buffer must be 1024-byte aligned.
__device__ __forceinline__ uint64_t b_desc(uint32_t w_smem, int t, int kk) {
  const uint32_t addr = w_smem + t * kC * 128 + kk * 32;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, registers) * B (16 x 64, shared memory by descriptor).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// The row (0..15) of its warp's 16 rows of an M-tile whose address this
// lane hands ldmatrix; lanes 16-31 give the second 8 channels of a K-step.
__device__ __forceinline__ int lane_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }

// This lane's haloed pixel index (before the tap shift) for M-tile mt.
__device__ __forceinline__ int lane_pixel(int mt, int warp_in_group, int lane) {
  const int m = lane_row(lane);
  return (2 * mt + (m >> 3)) * kInW + 8 * warp_in_group + (m & 7);
}

// A fragments of K-step s (tap s / 4, input channels 16 (s % 4) ..) for
// the M-tiles whose lane pixels are p[i], in an A tile kStride pixels wide.
template <int S, int kStride, int kMT>
__device__ __forceinline__ void load_a(uint32_t (&a)[kMT][4], uint32_t a_smem, const int (&p)[kMT], int khalf) {
  constexpr int t = S / 4, kk = S % 4;
  constexpr int shift = (t / 3) * kStride + (t % 3);
  const int c = 2 * kk + khalf;
#pragma unroll
  for (int i = 0; i < kMT; ++i) ldmatrix_x4(a[i], a_smem + a_offset(p[i] + shift, c));
}

// The B buffer stays as it is for the whole mainloop (K-B; K-D and K-E at
// Ci, Co <= 64).
struct ResidentWeights {
  template <int Row>
  __device__ __forceinline__ void before_row() const {}
  template <int Row>
  __device__ __forceinline__ void after_row() const {}
};

template <int S, int kStride, int kMT, class Rows>
__device__ __forceinline__ void mma_steps(float (&acc)[kMT][32], uint32_t (&a)[2][kMT][4], uint32_t a_smem,
                                          uint32_t w_smem, const int (&p)[kMT], int khalf, const Rows& rows) {
  if constexpr (S < kSteps) {
    constexpr int buf = S & 1;
    constexpr bool row_start = S > 0 && S % kRowSteps == 0;
    if constexpr (row_start) rows.template before_row<S / kRowSteps>();
    wgmma_fence();
    const uint64_t desc = b_desc(w_smem, S / 4, S % 4);
#pragma unroll
    for (int i = 0; i < kMT; ++i) wgmma_m64n64k16(acc[i], a[buf][i], desc);
    wgmma_commit();
    if constexpr (row_start) rows.template after_row<S / kRowSteps>();
    if constexpr (S + 1 < kSteps) {
      wgmma_wait<1>();  // step S-1 is done: its A registers may be refilled
      load_a<S + 1, kStride>(a[buf ^ 1], a_smem, p, khalf);
    }
    mma_steps<S + 1, kStride>(acc, a, a_smem, w_smem, p, khalf, rows);
  }
}

// acc[i] += the conv of one 64-channel chunk for this warpgroup's M-tile i,
// whose lanes' pixels (at tap (0, 0)) are p[i] in an A tile at a_smem that
// is kStride pixels wide; B at w_smem (1024-byte aligned). `rows` is called
// around the first step of tap rows 1 and 2 (see B above). Returns with
// every wgmma of this warpgroup complete; the caller zeroes acc first.
template <int kStride, int kMT, class Rows = ResidentWeights>
__device__ __forceinline__ void conv_chunk_mma(float (&acc)[kMT][32], uint32_t a_smem, uint32_t w_smem,
                                         const int (&p)[kMT], const Rows& rows = Rows()) {
  const int khalf = (tid_here() & 31) >> 4;
  uint32_t a[2][kMT][4];
  load_a<0, kStride>(a[0], a_smem, p, khalf);
#pragma unroll
  for (int i = 0; i < kMT; ++i) fence_acc(acc[i]);
  mma_steps<0, kStride>(acc, a, a_smem, w_smem, p, khalf, rows);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kMT; ++i) fence_acc(acc[i]);
}

// acc[i] += the tile's conv for M-tiles 2g and 2g+1 of warpgroup g, over one
// 64-channel chunk of the 18 x 34 A tile (see conv_chunk_mma).
template <class Rows = ResidentWeights>
__device__ __forceinline__ void conv_tile_mma(float (&acc)[2][32], uint32_t a_smem, uint32_t w_smem,
                                              const Rows& rows = Rows()) {
  const int tid = tid_here(), warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, wig = warp & 3;
  const int p[2] = {lane_pixel(2 * group, wig, lane), lane_pixel(2 * group + 1, wig, lane)};
  conv_chunk_mma<kInW>(acc, a_smem, w_smem, p, rows);
}

// Two neighbouring channels of the staged pooled tile, at even element `at`.
__device__ __forceinline__ void put_pair(uint16_t* staging, int at, float lo, float hi) {
  reinterpret_cast<uint32_t*>(staging)[at >> 1] = pack_bf16x2(lo, hi);
}
__device__ __forceinline__ void put_pair(float* staging, int at, float lo, float hi) {
  reinterpret_cast<float2*>(staging)[at >> 1] = make_float2(lo, hi);
}

// Bias, ReLU (the 0 floor) and the 2x2 max in registers; writes the pooled
// rows of the kMT M-tiles of this warpgroup (M-tile kMT g + i in acc[i], two
// conv rows each) to `staging`, [pooled rows][16 cols][64 ch], as Out: bf16
// (uint16_t, one rounding) or f32 (not rounded). bias: 64 floats.
// max(relu(a_i + b)) = max(0, max(a_i) + b) exactly, as rounding is monotonic.
template <typename Out, int kMT>
__device__ __forceinline__ void pool_tile_to_staging(const float (&acc)[kMT][32], const float* bias,
                                                     Out* staging) {
  const int tid = tid_here(), warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, wig = warp & 3;
  const int r = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int py = kMT * group + i;
    const int px = 4 * wig + (r >> 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = fmaxf(acc[i][4 * j + e], acc[i][4 * j + 2 + e]);  // rows y, y+1
        m[e] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));       // cols x, x+1
      }
      if ((r & 1) == 0) {
        const int co = 8 * j + 2 * q;
        put_pair(staging, (py * (kTileW / 2) + px) * kC + co, fmaxf(m[0] + bias[co], 0.0f),
                 fmaxf(m[1] + bias[co + 1], 0.0f));
      }
    }
  }
}

// Stores the staged pooled tile ([kRows][16][64]) with 16-byte vectors:
// pooled rows from py0, cols from px0, channels co0.. of a [.., out_h,
// out_w, cout] map of Out (cout a multiple of 8); rows, cols and channels
// past the map are dropped.
template <typename Out, int kRows = kTileH / 2>
__device__ __forceinline__ void store_staging(const Out* staging, Out* out_img, int py0, int px0,
                                              int out_h, int out_w, int co0, int cout) {
  constexpr int kPerVec = 16 / sizeof(Out);  // channels of one vector
  constexpr int kPixVecs = kC / kPerVec;
  constexpr int kVecs = kRows * (kTileW / 2) * kPixVecs;
  for (int v = tid_here(); v < kVecs; v += kThreads) {
    const int c = v % kPixVecs, pix = v / kPixVecs;
    const int py = py0 + pix / (kTileW / 2), px = px0 + pix % (kTileW / 2);
    const int co = co0 + kPerVec * c;
    if (py < out_h && px < out_w && co < cout) {
      *reinterpret_cast<uint4*>(out_img + (static_cast<size_t>(py) * out_w + px) * cout + co) =
          reinterpret_cast<const uint4*>(staging)[v];
    }
  }
}

// Asynchronous copies to shared memory; an invalid one writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tap row dy of the weights [9][cout][cin] (bf16, cin a multiple of 8) of
// chunk pair (co0, ci0) into slab dy of B, by cp.async; channels past cin
// or cout are zero.
__device__ __forceinline__ void load_slab(uint32_t w_smem, const uint16_t* w, int cin, int cout, int dy,
                                          int co0, int ci0) {
  for (int v = tid_here(); v < 3 * kC * 8; v += kThreads) {
    const int c = v & 7, co = (v >> 3) % kC, t = 3 * dy + v / (kC * 8);
    const bool valid = co0 + co < cout && ci0 + 8 * c < cin;
    const uint16_t* src = valid ? w + (static_cast<size_t>(t) * cout + co0 + co) * cin + ci0 + 8 * c : w;
    cp_async16(w_smem + w_offset(t, co, c), src, valid);
  }
}

// The SMs of the current device, 0 on error: the persistent grids' size.
inline int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  return sms;
}

}  // namespace conv_mma
