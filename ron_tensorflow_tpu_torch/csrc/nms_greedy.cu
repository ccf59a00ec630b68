// Greedy-NMS keep masks of score-sorted rows by one greedy sweep that skips
// untaken candidates in bulk: the uncapped, division-free mask (K-A) and the
// capped, dividing one (K-C) from one kernel template.
//
// Replaces the TPU kernels ron_tensorflow_tpu/kernels/nms_pallas.py:225
// `pallas_nms_fixpoint_keep_mask` (body `_nms_fixpoint_kernel`, the
// suppression fixpoint) and nms_pallas.py:93 `pallas_nms_keep_mask` (body
// `_nms_kernel`, the K-step scan with the keep_top_k cap inside). Both
// compute the sequential greedy keep set of each row of K candidates:
//   for i = 0 .. K-1 in order: take i iff it is alive, score_i > 0 and
//   (capped only) fewer than keep_top_k are kept; a taken i kills every
//   later j that it suppresses.
// They differ in two ways, two of the kernel's template parameters:
//   kDivide  the predicate. false (K-A, nms_pallas.py:179-181):
//            inter >= t * denom && denom > 0. true (K-C, nms_pallas.py:75):
//            ov = denom > 0 ? inter / denom : 0; ov >= t, IEEE division.
//            ('min': denom = min(vol_i, vol_j); 'union': vol_i + vol_j - inter.)
//   kCapped  false (K-A): no cap; true (K-C): stop at keep_top_k.
// Every product, sum and difference is written with a round-to-nearest
// intrinsic so nvcc cannot contract it into an FMA: the masks equal the plain
// PyTorch versions' bit for bit.
//
// The sweep. A row's alive bits start as "score > 0" (NaN is not > 0, and
// the valid candidates need not be a prefix: a descending torch.sort puts
// NaN first). Each step takes the lowest alive candidate i (one min-reduction
// over the threads of the row, each offering its own lowest alive candidate),
// clears its bit, and evaluates i's predicate against the row's candidates
// in parallel across the threads; the bits of the alive hits are cleared.
// Every alive candidate lies after i, since i was the lowest. A row takes as
// many steps as it keeps: 12.8 on average and 46 at most on the Detector's
// [640, 200] rows, where a K-step scan takes 200 steps a row and the
// fixpoint builds all K(K-1)/2 overlaps first. It is exact because it
// evaluates the same pairwise predicate, and a pair's result is used only
// when its suppressor is taken and its target still alive.
//
// Bound on the H100: latency. The bytes (2.69 MB at [640, 200]) take
// 0.0008 ms at 3.35 TB/s, and the overlaps the greedy set needs (each kept i
// against every later j, 1.17 M pairs) ~14 MFLOP. The time is a fixed ~2 us
// (launch, loading the rows) plus the longest row's kept count times the
// latency of one step: the reduction, a shared-memory broadcast of box i,
// the predicate, the bit update. What the design does about it:
// - How many threads a row gets (the candidates were timed in turns on the
//   card with tools/time_nms.py; PERF.md, Findings): one warp for K <= 256,
//   each lane holding its 8 candidates' boxes in registers, so that a step
//   needs no barrier and reads only box i from shared memory; above that a
//   block per row, up to 4 candidates a thread, one barrier a step. At
//   K = 200 the warp was the faster, at K = 2048 the block, where a lane
//   would walk 64 candidates a step.
// - A warp evaluates its slots in pairs, each pair branch-free and masked
//   by the alive bits afterwards, and skips a pair that no lane needs (one
//   redux.or of the alive words). A branch around every slot would run the
//   slots' dependent chains one after another; evaluating every slot would
//   spend the step on dead ones. A block's thread, with one or two slots at
//   K = 2048, branches on its own alive bits.
// - K-C's IEEE division has a slow path behind a branch, which serialises
//   the slots the same way. The dividing predicate is decided without
//   dividing where the answer is certain (`scan_verdict`); only a quotient
//   within a few ulps of t is divided, with __fdiv_rn, after the slot loop.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;
constexpr int kMaxK = 4096;
constexpr int kWarpSlots = 8;   // one warp per row: K <= 32 * 8
constexpr int kBlockSlots = 4;  // one block per row: K <= 1024 * 4
constexpr int kRowsPerWarpBlock = 4;
constexpr int kWarpGroup = 2;  // a warp evaluates its slots in pairs, skipping a pair no lane needs

// Boxes are (ymin, xmin, ymax, xmax) in (x, y, z, w).
__device__ __forceinline__ float box_volume(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The overlap's numerator and denominator for a taken box a and a box b.
template <bool kUnion>
__device__ __forceinline__ void overlap(float4 a, float va, float4 b, float vb, float& inter,
                                        float& denom) {
  const float ih = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  inter = __fmul_rn(ih, iw);
  denom = kUnion ? __fsub_rn(__fadd_rn(va, vb), inter) : fminf(va, vb);
}

// K-C's verdict on one pair, ov = denom > 0 && inter != 0 ? RN(inter / denom)
// : 0; ov >= t (0 / denom is +0 for every denom > 0, so inter == 0 needs no
// division), decided without the division where the answer is certain.
// Sets `border` where it is not; the caller then divides. For a normal
// t > 0 and P = RN(t * denom) positive and finite, |t * denom - P| <= ulp(P)/2:
// - inter >= P + 4 ulps: inter > t * denom, so inter / denom > t, and its
//   rounding, t being a float, is >= t;
// - inter <= P - 4 ulps, at least 2 ulp(P) below P (a binade crossing halves
//   the ulp): inter / denom <= t - 1.5 ulp(P) / denom, and as ulp(P) > P 2^-24
//   while ulp(t) <= t 2^-23, that lies more than ulp(t) / 2 below t, so the
//   quotient rounds to a float below t.
__device__ __forceinline__ bool scan_verdict(float inter, float denom, float t, bool t_normal,
                                             bool zero_hits, bool& border) {
  const bool zero = !(denom > 0.0f) || inter == 0.0f;
  const uint32_t pb = __float_as_uint(__fmul_rn(t, denom));
  // P in [4 ulps above 0, 4 ulps below FLT_MAX] (a negative or NaN P is out)
  const bool in_range = t_normal && pb - 4u <= 0x7f7ffffbu - 4u;
  const bool above = inter >= __uint_as_float(pb + 4u);
  const bool below = inter <= __uint_as_float(pb - 4u);
  border = !zero && !(in_range && (above || below));
  return zero ? zero_hits : in_range && above;
}

// Thread r of a row of `width` threads owns candidates j = r + width * s,
// s < kSlots, with their boxes and volumes in registers; its alive and kept
// flags are bit s of one word each. kOneWarp: a warp per row, the warps of a
// block on separate rows; else a block per row.
template <bool kDivide, bool kCapped, bool kUnion, int kSlots, bool kOneWarp>
__global__ void __launch_bounds__(kOneWarp ? 32 * kRowsPerWarpBlock : 1024)
nms_sweep_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                 uint8_t* __restrict__ keep, int rows, int k, float threshold, int cap) {
  extern __shared__ float4 smem[];  // the rows' boxes, volumes; a block per row: warp minima
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_here = kOneWarp ? blockDim.x >> 5 : 1;
  const int row = kOneWarp ? blockIdx.x * rows_here + warp : blockIdx.x;
  const int r = kOneWarp ? lane : threadIdx.x;
  const int width = kOneWarp ? 32 : blockDim.x;
  if (row >= rows) return;  // a whole warp of a warp-per-row block
  const int slot_row = kOneWarp ? warp : 0;
  float4* bx = smem + slot_row * k;
  float* vol = reinterpret_cast<float*>(smem + rows_here * k) + slot_row * k;
  uint32_t* mins = reinterpret_cast<uint32_t*>(vol + k);  // [2][32]
  const float* rs = scores + static_cast<size_t>(row) * k;
  const float4* rb = boxes + static_cast<size_t>(row) * k;

  float4 mine[kSlots];
  float vmine[kSlots];
  uint32_t alive = 0u, kept_bits = 0u;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = r + width * s;
    mine[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    vmine[s] = 0.0f;
    if (j < k) {
      mine[s] = __ldg(rb + j);  // 16-byte loads, neighbouring threads on neighbouring boxes
      vmine[s] = box_volume(mine[s]);
      bx[j] = mine[s];
      vol[j] = vmine[s];
      if (__ldg(rs + j) > 0.0f) alive |= 1u << s;
    }
  }
  if (kOneWarp) __syncwarp();  // a block per row: the first step's barrier publishes the boxes

  const bool t_normal = threshold >= FLT_MIN && threshold <= FLT_MAX;
  const bool zero_hits = 0.0f >= threshold;  // K-C's verdict where ov is 0
  int kept = 0, buf = 0;
  while (!kCapped || kept < cap) {
    // the row's lowest alive candidate: each thread offers its own lowest
    const uint32_t key = alive ? r + width * (__ffs(alive) - 1) : kNone;
    uint32_t i = __reduce_min_sync(kFull, key);
    // the slots worth evaluating: a warp's, alive in any lane (uniform); a
    // block's thread, its own
    const uint32_t live = kOneWarp ? __reduce_or_sync(kFull, alive) : alive;
    if (!kOneWarp) {
      if (lane == 0) mins[32 * buf + warp] = i;
      __syncthreads();
      i = __reduce_min_sync(kFull, lane < (width >> 5) ? mins[32 * buf + lane] : kNone);
      buf ^= 1;
    }
    if (i == kNone) break;
    if (key == i) {  // this thread owns i, its lowest alive candidate
      kept_bits |= alive & (0u - alive);
      alive &= alive - 1u;
    }
    ++kept;
    const float4 a = bx[i];
    const float va = vol[i];
    uint32_t kill = 0u, border = 0u;
    constexpr int kGroup = kOneWarp ? kWarpGroup : 1;
#pragma unroll
    for (int g = 0; g < kSlots; g += kGroup) {
      if (!((live >> g) & ((1u << kGroup) - 1u))) continue;
#pragma unroll
      for (int s = g; s < g + kGroup; ++s) {
        float inter, denom;
        overlap<kUnion>(a, va, mine[s], vmine[s], inter, denom);
        bool hit;
        if (kDivide) {
          bool unsure;
          hit = scan_verdict(inter, denom, threshold, t_normal, zero_hits, unsure);
          border |= static_cast<uint32_t>(unsure) << s;
        } else {
          hit = inter >= __fmul_rn(threshold, denom) && denom > 0.0f;
        }
        kill |= static_cast<uint32_t>(hit) << s;
      }
    }
    if (kDivide && (border &= alive) != 0u) {  // rare: a quotient within a few ulps of t
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if ((border >> s) & 1u) {
          float inter, denom;
          overlap<kUnion>(a, va, mine[s], vmine[s], inter, denom);
          kill = __fdiv_rn(inter, denom) >= threshold ? kill | 1u << s : kill & ~(1u << s);
        }
      }
    }
    alive &= ~kill;
  }

  uint8_t* out = keep + static_cast<size_t>(row) * k;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = r + width * s;
    if (j < k) out[j] = (kept_bits >> s) & 1u;
  }
}

template <bool kDivide, bool kCapped, bool kUnion>
cudaError_t launch(const float* scores, const float* boxes, void* keep, int rows, int k,
                   float threshold, int cap, cudaStream_t stream) {
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  uint8_t* out = static_cast<uint8_t*>(keep);
  const size_t per_row = (sizeof(float4) + sizeof(float)) * static_cast<size_t>(k);
  if (k <= 32 * kWarpSlots) {
    nms_sweep_kernel<kDivide, kCapped, kUnion, kWarpSlots, true>
        <<<(rows + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock, 32 * kRowsPerWarpBlock,
           per_row * kRowsPerWarpBlock, stream>>>(scores, b4, out, rows, k, threshold, cap);
    return cudaGetLastError();
  }
  auto kernel = nms_sweep_kernel<kDivide, kCapped, kUnion, kBlockSlots, false>;
  const int threads = min(1024, (k + 31) / 32 * 32);
  const size_t smem = per_row + 64 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<rows, threads, smem, stream>>>(scores, b4, out, rows, k, threshold, cap);
  return cudaGetLastError();
}

template <bool kDivide, bool kCapped>
int launch_rows(const float* scores, const float* boxes, void* keep, int rows, int k,
                float threshold, int cap, int union_mode, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(boxes) % alignof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaError_t err =
      union_mode ? launch<kDivide, kCapped, true>(scores, boxes, keep, rows, k, threshold, cap, stream)
                 : launch<kDivide, kCapped, false>(scores, boxes, keep, rows, k, threshold, cap, stream);
  return static_cast<int>(err);
}

}  // namespace

// K-A: the uncapped keep mask, division-free predicate.
extern "C" int nms_fixpoint_keep_mask(const float* scores, const float* boxes, void* keep,
                                      int rows, int k, float threshold, int union_mode,
                                      cudaStream_t stream) {
  return launch_rows<false, false>(scores, boxes, keep, rows, k, threshold, 0, union_mode, stream);
}

// K-C: the keep mask capped at keep_top_k, dividing predicate.
extern "C" int nms_scan_keep_mask(const float* scores, const float* boxes, void* keep, int rows,
                                  int k, float threshold, int keep_top_k, int union_mode,
                                  cudaStream_t stream) {
  return launch_rows<true, true>(scores, boxes, keep, rows, k, threshold, keep_top_k, union_mode,
                                 stream);
}

extern "C" const char* ron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
