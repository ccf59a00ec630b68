// Fused 3x3 SAME conv + bias + ReLU + 2x2/s2 max-pool, NHWC, Ci -> Co, on the
// tensor cores. bf16 input and weights, f32 sums, bias, ReLU and pool; the
// pooled value is stored as bf16 (one rounding) or as f32 (not rounded).
//
// Replaces two TPU kernels of ron_tensorflow_tpu/kernels/fused_conv_pool.py
// that compute the same function up to the output rounding; one kernel here,
// `conv3x3_relu_pool2_mma_kernel<Out, kStream>`, serves both:
//   `fused_stem_conv_relu_pool2` (`_stem_kernel`, C -> C, K-D): the pooled
//       value is always rounded to bf16 (its identity-matmul pool runs in
//       bf16); launcher `fused_stem_conv_relu_pool2`, Out = bf16.
//   `fused_conv3x3_relu_pool2` (`_kernel`, Ci -> Co, K-E): the f32 value is
//       only cast to x's dtype; launcher `fused_conv3x3_relu_pool2`, Out = bf16
//       for a bf16 x, f32 for an f32 x.
// The TPU kernels' H-only padding, merged-column layout, lane rolls with
// boundary masks and identity-matmul pool serve the MXU's 128 lanes and are
// not carried over.
//
// Bound on the H100: operations. The VGG block-2 tail ([32, 160, 160, 128]
// -> 128) and block-3 tail ([32, 80, 80, 256] -> 256) are 241.6 GFLOP each
// (0.244 ms at 989 TFLOP/s) against about 0.26 GB and 0.13 GB of input and
// output (0.08 and 0.04 ms at 3.35 TB/s); K-D at [32, 320, 320, 64] is the
// same 241.6 GFLOP against 0.52 GB. So the loads must hide under the MMAs.
//
// Design: the mainloop of conv3x3_mma.cuh, which fused block 1 (K-B) shares,
// so K-D on block 1's conv1_1 map gives K-B's bits. A persistent grid, one
// block of 512 threads per SM, walks (16 x 32 output tile, 64-output-channel
// chunk) units, the output-channel chunks of one tile next to each other:
// they run on neighbouring SMs at about the same time, so a tile read for
// one chunk is found in L2 by the others. Each unit sums over its
// 64-input-channel chunks, one stage each (channels past Ci or Co are zero).
// - A: each stage's input tile with its 1-pixel halo (18 x 34 x 64 bf16,
//   zero outside the image) is loaded with cp.async into one of two A buffers
//   while the previous stage's MMAs run.
// - B: the weights of a stage's (co, ci) chunk pair, [9][64][64] bf16, are a
//   ring of three tap-row slabs of 24 KB. Slab dy is refilled with the next
//   stage's tap row dy as soon as every warpgroup's MMAs of tap row dy have
//   retired: slabs 0 and 1 during this stage's MMAs of rows 1 and 2 (at a
//   barrier before each of those rows, where the warpgroups drain their
//   MMAs), slab 2 at the next stage's start; each is waited for at the
//   barrier before its row. Refilling slab 0 one row later, where no drain
//   is needed, and slabs 1 and 2 at the next stage's start measured 2-3%
//   slower: those copies then issue while no MMA runs. Where consecutive
//   stages share a pair nothing is loaded and the mid-stage barriers are
//   skipped. At Ci, Co <= 64 (K-D's block-1 tail) the pair never changes,
//   and the kernel is built without the ring's hooks (kStream false; with
//   them K-D measured ~2% slower). Two weight sets and two A buffers would
//   not fit in 227 KB.
// - Epilogue: bias (a slot of its own per unit, as the ring may already
//   hold the next unit's weights), ReLU and the pool in registers, staged in
//   the spent A buffer and stored with 16-byte vectors.
// The sum order within a 64-channel chunk is the mainloop's, and chunks are
// summed in order, so K-B, K-D and K-E (bf16 x, Ci = Co = 64) agree in bits.

#include <cstddef>

#include "conv3x3_mma.cuh"

namespace {

namespace cm = conv_mma;

constexpr int kBiasOffset = cm::kWBytes + 2 * cm::kABytes;  // two slots of 64 floats
constexpr int kNextOffset = kBiasOffset + 2 * cm::kC * 4;    // NextPair
constexpr int kSmemBytes = kNextOffset + 8 + 1024;           // + alignment

// The next stage's (co, ci) chunk pair, written by thread 0 before the
// stage's first barrier and read where the ring refills: kept in shared
// memory, not in registers that would stay live across the 64 accumulators.
struct NextPair {
  int co0, ci0;
};

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The mainloop's row hooks for the streamed weight ring. cp.async groups, in
// the order every thread commits them (one each, empty when nothing loads):
// stage i's start: S2(i) slab 2, T(i+1) tile (with its unit's bias); row 1:
// S0(i+1); row 2: S1(i+1). So before row 1 (S1(i), S2(i), T(i+1) at most
// pending) and before row 2 (S2(i), T(i+1), S0(i+1)) waiting for all but the
// newest 2 lands the row's slab.
struct StreamedWeights {
  const uint16_t* w;
  uint32_t w_smem, next;  // B buffer, NextPair
  int cin, cout;
  bool sync;    // this stage's slabs 1 and 2 arrive, or the next stage's are loaded
  bool refill;  // the next stage has another (co, ci) pair: load it

  template <int Row>
  __device__ __forceinline__ void before_row() const {
    if (sync) {
      cm::wgmma_wait<0>();  // this warpgroup's MMAs of row Row-1 have retired
      cm::cp_async_wait<2>();
      cm::fence_proxy_async();
      __syncthreads();  // every warpgroup's too; slab Row has landed
    }
  }
  template <int Row>
  __device__ __forceinline__ void after_row() const {
    if (refill) {
      cm::load_slab(w_smem, w, cin, cout, Row - 1, ld_shared(next + offsetof(NextPair, co0)),
                ld_shared(next + offsetof(NextPair, ci0)));
    }
    cm::cp_async_commit();
  }
};

// kStream: the weights change between stages (Ci or Co above 64), so they
// stream through the ring; else they are loaded once and stay resident, and
// the mainloop runs without the row hooks.
template <typename Out, bool kStream>
__global__ void __launch_bounds__(cm::kThreads, 1)
conv3x3_relu_pool2_mma_kernel(const uint16_t* __restrict__ x,   // [B, H, W, Ci] bf16
                              const uint16_t* __restrict__ w,   // [9, Co, Ci] bf16
                              const float* __restrict__ bias,   // [Co]
                              Out* __restrict__ out,            // [B, H/2, W/2, Co]
                              int batch, int height, int width, int cin, int cout) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t w_smem = cm::smem_u32(smem);  // B operand, 1024-aligned
  auto abuf = [&](int buf) { return smem + cm::kWBytes + buf * cm::kABytes; };  // two A buffers
  float* bs = reinterpret_cast<float*>(smem + kBiasOffset);
  NextPair* next_pair = reinterpret_cast<NextPair*>(smem + kNextOffset);
  const int tid = threadIdx.x;

  const int nk = (cin + cm::kC - 1) / cm::kC;    // 64-channel chunks of K
  const int nco = (cout + cm::kC - 1) / cm::kC;  // and of N
  const int tiles_x = (width + cm::kTileW - 1) / cm::kTileW;
  const int tiles_y = (height + cm::kTileH - 1) / cm::kTileH;
  const int units = tiles_x * tiles_y * batch * nco;  // (tile, output-channel chunk), the chunk innermost
  const int my_units = blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int stages = my_units * nk;  // one per input-channel chunk of each unit
  if (stages == 0) return;

  // Stage i's unit. Its (co, ci) chunk pair differs from the previous
  // stage's at every stage when there are several K chunks, else when the
  // grid stride moves the unit to another output-channel chunk.
  auto unit_of = [&](int i) { return static_cast<int>(blockIdx.x) + (i / nk) * static_cast<int>(gridDim.x); };
  const bool pairs_change = nk > 1 || gridDim.x % nco != 0;

  // Input tile of stage i (1-pixel zero halo, channels past Ci zero) into
  // buf and, at a unit's first stage, the unit's bias into the bias slot of
  // its parity (channels past Co zero).
  auto load_tile = [&](int i, int buf) {
    const int unit = unit_of(i), tile = unit / nco, kc = i % nk;
    if (kc == 0 && cm::tid_here() < cm::kC) {
      const int t = cm::tid_here(), co = (unit % nco) * cm::kC + t;
      cm::cp_async4(cm::smem_u32(bs + ((i / nk) & 1) * cm::kC + t), co < cout ? bias + co : bias, co < cout);
    }
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
    const uint32_t dst = cm::smem_u32(abuf(buf));
    for (int v = cm::tid_here(); v < cm::kInH * cm::kInW * 8; v += cm::kThreads) {
      const int p = v >> 3, c = v & 7;
      const int r = p / cm::kInW, col = p - r * cm::kInW;
      const int gy = ty * cm::kTileH - 1 + r, gx = tx * cm::kTileW - 1 + col;
      const int ch = kc * cm::kC + 8 * c;
      const bool valid = gy >= 0 && gy < height && gx >= 0 && gx < width && ch < cin;
      const uint16_t* src = valid ? x + ((static_cast<size_t>(b) * height + gy) * width + gx) * cin + ch : x;
      cm::cp_async16(dst + cm::a_offset(p, c), src, valid);
    }
  };

  load_tile(0, 0);
  cm::cp_async_commit();  // T(0)
  const int co0_first = static_cast<int>(blockIdx.x % nco) * cm::kC;
  cm::load_slab(w_smem, w, cin, cout, 0, co0_first, 0);
  cm::cp_async_commit();  // S0(0)
  cm::load_slab(w_smem, w, cin, cout, 1, co0_first, 0);
  cm::cp_async_commit();  // S1(0)

  float acc[2][32];
  for (int i = 0; i < stages; ++i) {
    const int kc = i % nk;
    const bool fresh = i == 0 || pairs_change;  // this stage's slabs are loading
    const bool refill = kStream && i + 1 < stages && pairs_change;
    if (fresh) cm::load_slab(w_smem, w, cin, cout, 2, unit_of(i) % nco * cm::kC, kc * cm::kC);
    cm::cp_async_commit();  // S2(i)
    if (i + 1 < stages) load_tile(i + 1, (i + 1) & 1);  // the next tile loads while this one computes
    cm::cp_async_commit();  // T(i+1)
    if (refill && tid == 0) *next_pair = NextPair{unit_of(i + 1) % nco * cm::kC, (i + 1) % nk * cm::kC};
    if (kStream && i > 0) {
      cm::cp_async_wait<3>();  // T(i) and S0(i) have landed (the rows' groups are newer)
    } else {
      cm::cp_async_wait<1>();  // all but T(i+1): at stage 0 T(0) and all three slabs
    }
    if (fresh) cm::fence_proxy_async();
    __syncthreads();

    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[m][k] = 0.0f;
    }
    if constexpr (kStream) {
      const StreamedWeights rows{w, w_smem, cm::smem_u32(next_pair), cin, cout, (i > 0 && fresh) || refill, refill};
      cm::conv_tile_mma(acc, cm::smem_u32(abuf(i & 1)), w_smem, rows);
    } else {
      cm::conv_tile_mma(acc, cm::smem_u32(abuf(i & 1)), w_smem);
    }
    if (kc == nk - 1) {
      const int unit = unit_of(i), tile = unit / nco;
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y, b = tile / (tiles_x * tiles_y);
      Out* staging = reinterpret_cast<Out*>(abuf(i & 1));
      __syncthreads();  // every warpgroup is done reading this A buffer
      cm::pool_tile_to_staging(acc, bs + ((i / nk) & 1) * cm::kC, staging);
      __syncthreads();
      cm::store_staging(staging, out + static_cast<size_t>(b) * (height / 2) * (width / 2) * cout,
                        ty * cm::kTileH / 2, tx * cm::kTileW / 2, height / 2, width / 2,
                        (unit % nco) * cm::kC, cout);
    }
    __syncthreads();  // this A buffer and slab 2 may be overwritten
  }
  cm::cp_async_wait<0>();  // no copy outlives the block
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Out>
int launch(const void* x, const void* w, const void* b, void* out, int batch, int height, int width, int cin,
           int cout, cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 2 != 0 || width % 2 != 0 || cin <= 0 || cin % 8 != 0 || cout <= 0 || cout % 8 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = static_cast<long long>(batch) * ((height + cm::kTileH - 1) / cm::kTileH) *
                          ((width + cm::kTileW - 1) / cm::kTileW) * ((cout + cm::kC - 1) / cm::kC);
  if (units * ((cin + cm::kC - 1) / cm::kC) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = cm::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const auto kernel = cin > cm::kC || cout > cm::kC ? conv3x3_relu_pool2_mma_kernel<Out, true>
                                                    : conv3x3_relu_pool2_mma_kernel<Out, false>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, cm::kThreads, kSmemBytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), static_cast<const float*>(b),
      static_cast<Out*>(out), batch, height, width, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_stem_conv_relu_pool2_smem_bytes() { return kSmemBytes; }
extern "C" int fused_conv3x3_relu_pool2_smem_bytes() { return kSmemBytes; }

// K-D: C -> C, the pooled value always stored as bf16; w [9][C co][C ci].
extern "C" int fused_stem_conv_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                          int batch, int height, int width, int cin, int cout,
                                          cudaStream_t stream) {
  if (cin != cout) return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint16_t>(x, w, b, out, batch, height, width, cin, cout, stream);
}

// K-E: Ci -> Co, w [9][Co][Ci]; stored as bf16 when out_bf16 (a bf16 x), else as f32.
extern "C" int fused_conv3x3_relu_pool2(const void* x, const void* w, const void* b, void* out,
                                        int batch, int height, int width, int cin, int cout,
                                        int out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<uint16_t>(x, w, b, out, batch, height, width, cin, cout, stream)
                  : launch<float>(x, w, b, out, batch, height, width, cin, cout, stream);
}
