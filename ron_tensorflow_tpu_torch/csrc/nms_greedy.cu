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
//
// Wide rows (K > kMaxK: a Detector's top_k at every anchor, 21250 for
// RON-320, 8732 for SSD-300, 24564 for SSD-512) do not fit one SM's
// registers. Up to kClusterMaxK candidates they take `nms_cluster_kernel`,
// the same greedy keep set by a tile-batched sweep spread over a thread-block
// cluster:
// - A row is cut into tiles of kTile = 32 candidates, dealt out in turn to
//   the C CTAs of the row's cluster and, inside a CTA, to its 32 warps: tile
//   t lives in CTA t % C, warp (t / C) % 32, a lane a candidate. A CTA loads
//   its tiles' boxes from HBM once into its own shared memory (K / C boxes
//   of 16 bytes: 21 KB a CTA at K = 21250, C = 16); a lane keeps its alive
//   and kept flags in each of its warp's tiles as bits of two registers.
// - In a step every warp resolves the greedy inside its first alive tile in
//   registers (one ballot per kept box), unasked. Per CTA, the warp holding
//   the CTA's first alive tile sends a note (that tile, the CTA's next alive
//   tile, the kept mask, the tile's boxes) to every CTA of the cluster by
//   bulk copies into their shared memory (distributed shared memory), each
//   counted in by the receiver's mbarrier: no cluster barrier a step.
// - Warp 0 of every CTA then takes the notes' tiles in order, as long as no
//   other alive tile lies before them (each earlier note's next alive tile
//   bounds them), their kept boxes fit a warp, and no box kept in an earlier
//   taken tile suppresses one kept in a later one. Their kept sets are then
//   exactly the sequential sweep's: the first tile's is, since every box
//   kept before it has been applied, and a later tile's kept boxes stand
//   when no earlier kept box suppresses them (what those boxes suppress in
//   the tile stays suppressed). K-C stops at keep_top_k, which may fall in
//   the middle of a tile.
// - Every warp then tests its alive candidates after the last taken tile
//   against the taken boxes: each kept box meets each later candidate still
//   alive at its turn at most once, as in the sequential sweep. A row takes
//   fewer steps than it has tiles holding a kept box (49 for [2, 21250]'s
//   'union' rows, 273 such tiles, 613 kept).
// - Notes and their barriers alternate between two buffers by the step's
//   parity: a CTA's note for step s + 2 can only be sent after the CTA has
//   had this CTA's note for step s + 1, sent after this CTA read step s's.
// - C follows the rows (`cluster_ctas`): up to 16 CTAs a row when rows are
//   few ([2, K]: 32 SMs), about SMs / rows when they are many (3 at the
//   Detector's [40, 21250]), at least what the row's boxes need.
// - K-C decides its dividing predicate through `scan_verdict` here too.
// Bound: latency, as on the narrow path. A step costs two block barriers,
// one round of notes through distributed shared memory, the tile's
// in-register greedy and warp 0's decision; the bytes (21 B a candidate)
// and the pairs are far below a microsecond.
//
// Rows wider than kClusterMaxK (the boxes of 16 CTAs' shared memory) take
// `nms_wide_kernel`: one block of 1024 threads a row, the row's alive and
// kept bits as words in shared memory (K / 8 bytes each); a cursor moves
// only forward to the word of the lowest alive candidate, which warp 0 finds
// with one ballot per 32 words; box i is broadcast through shared memory;
// warp w evaluates the words w, w + 32, ... at and after i's, a lane per
// candidate, reading the alive candidates' boxes from global memory and
// clearing the hits with one ballot per word. The row takes as many steps
// as it keeps (K up to 925,696). Here K-C decides every pair with
// __fdiv_rn.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;
constexpr int kMaxK = 4096;  // above: nms_cluster_kernel, then nms_wide_kernel
constexpr int kWarpSlots = 8;   // one warp per row: K <= 32 * 8
constexpr int kBlockSlots = 4;  // one block per row: K <= 1024 * 4
constexpr int kRowsPerWarpBlock = 4;
constexpr int kWarpGroup = 2;  // a warp evaluates its slots in pairs, skipping a pair no lane needs
constexpr int kWideThreads = 1024;
constexpr int kWideBatch = 4;  // words a warp of the wide kernel evaluates at once
// the bit words' dynamic shared memory, beside the block's few static bytes:
// K up to 925,696 candidates a row
constexpr size_t kWideMaxSmem = 226 * 1024;
// nms_cluster_kernel: a tile of 32 candidates, a lane each; 32 warps a CTA
constexpr int kTile = 32;
constexpr int kClusterWarps = 32;
constexpr int kClusterMaxCtas = 16;  // above 8: a non-portable cluster size
constexpr int kClusterSpread = 16;   // most CTAs a row gets when there are SMs to spare
constexpr int kCtaMaxK = 13312;      // candidates a CTA holds: 208 KB of boxes
constexpr int kClusterMaxK = kClusterMaxCtas * kCtaMaxK;  // 212,992; above: nms_wide_kernel

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

// One block of kWideThreads a row, any K whose 2 * ceil(K / 32) bit words
// fit in shared memory: the sweep of nms_sweep_kernel over bit words.
template <bool kDivide, bool kCapped, bool kUnion>
__global__ void __launch_bounds__(kWideThreads)
nms_wide_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                uint8_t* __restrict__ keep, int k, float threshold, int cap) {
  extern __shared__ uint32_t words[];  // [nwords] alive bits, then [nwords] kept bits
  __shared__ int taken;
  __shared__ float4 box_i;
  __shared__ float vol_i;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kWideThreads / 32;
  const int nwords = (k + 31) >> 5;
  uint32_t* alive = words;
  uint32_t* kept_bits = words + nwords;
  const size_t row = blockIdx.x;
  const float* rs = scores + row * k;
  const float4* rb = boxes + row * k;

  for (int w = warp; w < nwords; w += kWarps) {  // alive = score > 0 (NaN is not)
    const int j = 32 * w + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && __ldg(rs + j) > 0.0f);
    if (lane == 0) {
      alive[w] = bits;
      kept_bits[w] = 0u;
    }
  }
  __syncthreads();

  int cursor = 0, kept = 0;  // the word of the last taken candidate: nothing alive lies before it
  while (!kCapped || kept < cap) {
    if (warp == 0) {  // the lowest alive candidate, 32 words a ballot from the cursor on
      int found = -1;
      for (int w0 = cursor; w0 < nwords; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t bits = w < nwords ? alive[w] : 0u;
        const uint32_t nonzero = __ballot_sync(kFull, bits != 0u);
        if (nonzero) {
          const int src = __ffs(nonzero) - 1;
          const uint32_t first = __shfl_sync(kFull, bits, src);
          found = 32 * (w0 + src) + __ffs(first) - 1;
          break;
        }
      }
      if (lane == 0) {
        taken = found;
        if (found >= 0) {
          alive[found >> 5] &= ~(1u << (found & 31));
          kept_bits[found >> 5] |= 1u << (found & 31);
          const float4 b = __ldg(rb + found);
          box_i = b;
          vol_i = box_volume(b);
        }
      }
    }
    __syncthreads();
    const int i = taken;
    if (i < 0) break;
    ++kept;
    cursor = i >> 5;
    const float4 a = box_i;
    const float va = vol_i;
    // each warp its words, kWideBatch at a time so that their box loads overlap
    for (int w0 = cursor + warp; w0 < nwords; w0 += kWarps * kWideBatch) {
      uint32_t bits[kWideBatch];
      float4 b[kWideBatch];
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) {
        const int w = w0 + u * kWarps;
        bits[u] = w < nwords ? alive[w] : 0u;
        b[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if ((bits[u] >> lane) & 1u) b[u] = __ldg(rb + 32 * w + lane);
      }
#pragma unroll
      for (int u = 0; u < kWideBatch; ++u) {
        bool hit = false;
        if ((bits[u] >> lane) & 1u) {
          float inter, denom;
          overlap<kUnion>(a, va, b[u], box_volume(b[u]), inter, denom);
          if (kDivide) {
            hit = (denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f) >= threshold;
          } else {
            hit = inter >= __fmul_rn(threshold, denom) && denom > 0.0f;
          }
        }
        const uint32_t kill = __ballot_sync(kFull, hit);
        if (lane == 0 && kill) alive[w0 + u * kWarps] = bits[u] & ~kill;
      }
    }
    __syncthreads();
  }

  uint8_t* out = keep + row * k;
  for (int j = threadIdx.x; j < k; j += kWideThreads) out[j] = (kept_bits[j >> 5] >> (j & 31)) & 1u;
}

template <bool kDivide, bool kCapped, bool kUnion>
cudaError_t launch_wide(const float* scores, const float* boxes, void* keep, int rows, int k,
                        float threshold, int cap, cudaStream_t stream) {
  auto kernel = nms_wide_kernel<kDivide, kCapped, kUnion>;
  const size_t smem = 2 * sizeof(uint32_t) * static_cast<size_t>((k + 31) / 32);
  if (smem > kWideMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<rows, kWideThreads, smem, stream>>>(scores, reinterpret_cast<const float4*>(boxes),
                                               static_cast<uint8_t*>(keep), k, threshold, cap);
  return cudaGetLastError();
}

// K-A's (division-free) or K-C's (dividing) verdict: does taken box a
// suppress box b?
template <bool kDivide, bool kUnion>
__device__ __forceinline__ bool suppresses(float4 a, float va, float4 b, float vb, float t, bool t_normal,
                                           bool zero_hits) {
  float inter, denom;
  overlap<kUnion>(a, va, b, vb, inter, denom);
  if (!kDivide) return inter >= __fmul_rn(t, denom) && denom > 0.0f;
  bool border;
  const bool hit = scan_verdict(inter, denom, t, t_normal, zero_hits, border);
  return border ? __fdiv_rn(inter, denom) >= t : hit;
}

__device__ __forceinline__ float4 shfl_box(float4 b, int src) {
  return make_float4(__shfl_sync(kFull, b.x, src), __shfl_sync(kFull, b.y, src), __shfl_sync(kFull, b.z, src),
                     __shfl_sync(kFull, b.w, src));
}

// CTAs a row's cluster gets: what its boxes need, and up to kClusterSpread
// when the rows leave SMs idle.
int cluster_ctas(int rows, int k, int sms) {
  constexpr int kCtaTiles = kCtaMaxK / kTile;
  const int need = ((k + kTile - 1) / kTile + kCtaTiles - 1) / kCtaTiles;
  return max(need, max(1, min(kClusterSpread, sms / max(rows, 1))));
}

// What each CTA tells every CTA of the cluster in a step: head = (its
// first alive tile or kNone, its next alive tile or kNone, the first tile's
// warp | u << 8, the first tile's kept mask as resolved), then that tile's
// boxes.
struct __align__(16) TileNote {
  uint4 head;
  float4 boxes[kTile];
};

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory object in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_address(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The position of the j-th set bit (j >= 1) of mask.
__device__ __forceinline__ int nth_bit(uint32_t mask, int j) {
  for (int r = 1; r < j; ++r) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// A row of any K up to kClusterMaxK on one cluster of C CTAs of 32 warps
// (the grid: rows x C CTAs, C from the launch's cluster dimension): the
// tile-batched greedy sweep of the header. Warp w of CTA c owns the tiles
// t = c + C w + 32 C u, u = 0, 1, ... (its u-th tile), lane l the slot l of
// each. `steps`, where not null, gets each row's number of steps.
template <bool kDivide, bool kCapped, bool kUnion>
__global__ void __launch_bounds__(kClusterWarps * 32, 1)
nms_cluster_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                   uint8_t* __restrict__ keep, int* __restrict__ steps, int k, float threshold, int cap) {
  namespace cg = cooperative_groups;
  extern __shared__ float4 tile_boxes[];  // warp w's u-th tile at (w + 32 u) * kTile
  __shared__ uint2 warp_tiles[kClusterWarps];  // each warp's first and next alive tile, or kNone
  // by step parity: the notes from the cluster's CTAs, this CTA's own as
  // sent, and the barrier that counts the notes' bytes in
  __shared__ TileNote notes[2][kClusterMaxCtas];
  __shared__ TileNote outbox[2];
  __shared__ uint64_t note_bar[2];
  // the step's decision: the boxes it keeps, in order; (their count, the
  // mask kept of this CTA's note, the last tile's owner c + C w and u)
  __shared__ float4 taken_boxes[kTile];
  __shared__ uint4 taken;
  __shared__ int listed_boxes[kTile];  // warp 0's list of the listed notes' kept boxes: note << 8 | slot
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int cta = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x / ctas;
  const int tiles = (k + kTile - 1) / kTile;
  const int stride = ctas * kClusterWarps;  // from a warp's tile to its next
  const int first = cta + ctas * warp;      // the warp's tile u = 0
  const float* rs = scores + row * k;
  const float4* rb = boxes + row * k;
  const uint32_t note_bytes = static_cast<uint32_t>(ctas * sizeof(TileNote));

  uint32_t alive = 0u, kept_bits = 0u;  // bit u: this lane's candidate in the warp's tile u
  for (int u = 0, t = first; t < tiles; ++u, t += stride) {
    const int j = kTile * t + lane;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool valid = false;
    if (j < k) {
      b = __ldg(rb + j);
      valid = __ldg(rs + j) > 0.0f;  // NaN is not
    }
    tile_boxes[(warp + kClusterWarps * u) * kTile + lane] = b;
    alive |= static_cast<uint32_t>(valid) << u;
  }
  if (threadIdx.x == 0) {
    for (int p = 0; p < 2; ++p) {  // one arrival a phase, and steps 0 and 1's bytes
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_address(&note_bar[p])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int p = 0; p < 2; ++p) expect_bytes(smem_address(&note_bar[p]), note_bytes);
  }
  cluster.sync();  // every CTA of the cluster running, its barriers set, before any note is sent

  const bool t_normal = threshold >= FLT_MIN && threshold <= FLT_MAX;
  const bool zero_hits = 0.0f >= threshold;
  int kept = 0, taken_steps = 0;
  for (int step = 0; !kCapped || kept < cap; ++step) {
    const int par = step & 1;
    // 1. resolve this warp's first alive tile in registers, unasked
    const uint32_t live = __reduce_or_sync(kFull, alive);
    const int u = live != 0u ? __ffs(live) - 1 : 0;
    const uint32_t rest = live & (live - 1u);
    const uint32_t my_first = live != 0u ? static_cast<uint32_t>(first + stride * u) : kNone;
    const uint32_t my_next = rest != 0u ? static_cast<uint32_t>(first + stride * (__ffs(rest) - 1)) : kNone;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint32_t m = 0u;
    if (live != 0u) {
      b = tile_boxes[(warp + kClusterWarps * u) * kTile + lane];
      const float v = box_volume(b);
      uint32_t a = __ballot_sync(kFull, (alive >> u) & 1u);
      for (int n = kept; a != 0u && (!kCapped || n < cap); ++n) {  // take the tile's first alive candidate i
        const int i = __ffs(a) - 1;
        m |= 1u << i;
        a &= a - 1u;
        const float4 bi = shfl_box(b, i);
        const float vi = __shfl_sync(kFull, v, i);
        a &= ~__ballot_sync(kFull, suppresses<kDivide, kUnion>(bi, vi, b, v, threshold, t_normal, zero_hits));
      }
    }
    if (lane == 0) warp_tiles[warp] = make_uint2(my_first, my_next);
    __syncthreads();
    // 2. the warp that holds the CTA's first alive tile sends the CTA's note
    // to every CTA of the cluster (warp 0 sends kNone)
    const uint2 wt = lane < kClusterWarps ? warp_tiles[lane] : make_uint2(kNone, kNone);
    const uint32_t cta_first = __reduce_min_sync(kFull, wt.x);
    const uint32_t cta_next = __reduce_min_sync(kFull, wt.x == cta_first ? wt.y : wt.x);
    if (cta_first == kNone ? warp == 0 : cta_first == my_first) {
      TileNote& note = outbox[par];
      if (lane == 0) note.head = make_uint4(cta_first, cta_next, warp | u << 8, m);
      note.boxes[lane] = b;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the note, to the bulk copies
      __syncwarp();
      if (lane < ctas) {
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                cluster_address(smem_address(&notes[par][cta]), lane)),
            "r"(smem_address(&note)), "r"(static_cast<uint32_t>(sizeof(TileNote))),
            "r"(cluster_address(smem_address(&note_bar[par]), lane))
            : "memory");
      }
    }
    wait_phase(smem_address(&note_bar[par]), (step >> 1) & 1);
    // the phase after next: its notes come only after this CTA's next one
    if (threadIdx.x == 0) expect_bytes(smem_address(&note_bar[par]), note_bytes);
    // 3. warp 0 takes the notes' tiles in order, as long as no alive tile
    // lies between them and no box kept in an earlier one suppresses a box
    // kept in a later one: their kept sets are then the sweep's
    if (warp == 0) {
      const uint4 h = lane < ctas ? notes[par][lane].head : make_uint4(kNone, kNone, 0u, 0u);
      const int nt = __popc(h.w);
      int base = 0;  // boxes kept in the notes' tiles before this one
      uint32_t bound = kNone;  // the first alive tile after those tiles
#pragma unroll
      for (int d = 0; d < kClusterMaxCtas; ++d) {  // lanes from `ctas` on hold kNone
        const uint32_t td = __shfl_sync(kFull, h.x, d);
        const int nd = __shfl_sync(kFull, nt, d);
        const uint32_t xd = __shfl_sync(kFull, h.y, d);
        if (td < h.x) {
          base += nd;
          bound = min(bound, xd);
        }
      }
      const bool fits = h.x != kNone && h.x < bound && (base == 0 || base + nt <= kTile);
      const uint32_t stop = __reduce_min_sync(kFull, h.x != kNone && !fits ? h.x : kNone);
      const int listed = fits && h.x < stop;
      // lane l: the l-th box kept in the listed tiles, in order
      if (listed) {
        int e = base;
        for (uint32_t mm = h.w; mm != 0u; mm &= mm - 1u) listed_boxes[e++] = lane << 8 | (__ffs(mm) - 1);
      }
      __syncwarp();
      const int total = __reduce_max_sync(kFull, listed ? base + nt : 0);
      const int src = lane < total ? listed_boxes[lane] : -1;
      const int my_note = src >= 0 ? src >> 8 : 0;
      const int my_base = __shfl_sync(kFull, base, my_note);
      const float4 kb = src >= 0 ? notes[par][my_note].boxes[src & 0xff] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float kv = box_volume(kb);
      bool hit = false;  // by a box of an earlier tile
      for (int q0 = 0; q0 < total; q0 += 4) {  // four at a time, branch-free
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + e;
          const float4 a = shfl_box(kb, q & 31);
          const float va = __shfl_sync(kFull, kv, q & 31);
          hit |= (q < my_base) & suppresses<kDivide, kUnion>(a, va, kb, kv, threshold, t_normal, zero_hits);
        }
      }
      int count = __reduce_min_sync(kFull, src >= 0 && hit ? my_base : total);
      if (kCapped) count = min(count, cap - kept);
      if (lane < count) taken_boxes[lane] = kb;
      const int j = count - base;  // this note's boxes taken
      const uint32_t own = !listed || j <= 0 ? 0u : j >= nt ? h.w : h.w & ((2u << nth_bit(h.w, j)) - 1u);
      const int last = __shfl_sync(kFull, my_note, max(count - 1, 0));
      const uint32_t last_z = __shfl_sync(kFull, h.z, last);
      const uint32_t own_cta = __shfl_sync(kFull, own, cta);
      if (lane == 0) {
        taken = make_uint4(count, own_cta, last + ctas * (last_z & 0xffu), last_z >> 8);
      }
    }
    __syncthreads();
    const uint4 tk = taken;
    const int n = static_cast<int>(tk.x);
    if (n == 0) break;
    kept += n;
    ++taken_steps;
    if (tk.y != 0u) {  // this CTA's note was taken: its warp keeps the boxes
      const uint32_t z = notes[par][cta].head.z;
      if (warp == static_cast<int>(z & 0xffu)) {
        kept_bits |= ((tk.y >> lane) & 1u) << (z >> 8);
        alive &= ~(1u << (z >> 8));
      }
    }
    if (kCapped && kept >= cap) break;
    // 4. this warp's alive candidates after the last taken tile against the taken boxes
    const int after = static_cast<int>(tk.w) + (first <= static_cast<int>(tk.z) ? 1 : 0);
    const uint32_t later = after >= 32 ? 0u : kFull << after;
    uint32_t todo = __reduce_or_sync(kFull, alive & later);
    while (todo != 0u) {
      const int uj = __ffs(todo) - 1;
      todo &= todo - 1u;
      const float4 bj = tile_boxes[(warp + kClusterWarps * uj) * kTile + lane];
      const float vj = box_volume(bj);
      bool hit = false;
      for (int q0 = 0; q0 < n; q0 += 4) {  // four at a time, branch-free
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 a = taken_boxes[(q0 + e) & (kTile - 1)];
          hit |= (q0 + e < n) & suppresses<kDivide, kUnion>(a, box_volume(a), bj, vj, threshold, t_normal, zero_hits);
        }
      }
      if (hit) alive &= ~(1u << uj);
    }
  }
  if (steps != nullptr && cta == 0 && threadIdx.x == 0) steps[row] = taken_steps;
  // no CTA leaves while a copy from its shared memory may be in flight
  cluster.sync();

  uint8_t* out = keep + row * k;
  for (int u = 0, t = first; t < tiles; ++u, t += stride) {
    const int j = kTile * t + lane;
    if (j < k) out[j] = (kept_bits >> u) & 1u;
  }
}

template <bool kDivide, bool kCapped, bool kUnion>
cudaError_t launch_cluster(const float* scores, const float* boxes, void* keep, int* steps, int rows, int k,
                           float threshold, int cap, cudaStream_t stream) {
  auto kernel = nms_cluster_kernel<kDivide, kCapped, kUnion>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int ctas = cluster_ctas(rows, k, sms);
  const int tiles = (k + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>((tiles + ctas - 1) / ctas) * kTile * sizeof(float4);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * ctas);
  cfg.blockDim = dim3(kClusterWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, scores, reinterpret_cast<const float4*>(boxes),
                           static_cast<uint8_t*>(keep), steps, k, threshold, cap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kDivide, bool kCapped>
int launch_rows(const float* scores, const float* boxes, void* keep, int* steps, int rows, int k,
                float threshold, int cap, int union_mode, cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(boxes) % alignof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err;
  if (k > kClusterMaxK) {
    err = union_mode ? launch_wide<kDivide, kCapped, true>(scores, boxes, keep, rows, k, threshold, cap, stream)
                     : launch_wide<kDivide, kCapped, false>(scores, boxes, keep, rows, k, threshold, cap, stream);
  } else if (k > kMaxK) {
    err = union_mode
              ? launch_cluster<kDivide, kCapped, true>(scores, boxes, keep, steps, rows, k, threshold, cap, stream)
              : launch_cluster<kDivide, kCapped, false>(scores, boxes, keep, steps, rows, k, threshold, cap, stream);
  } else {
    err = union_mode ? launch<kDivide, kCapped, true>(scores, boxes, keep, rows, k, threshold, cap, stream)
                     : launch<kDivide, kCapped, false>(scores, boxes, keep, rows, k, threshold, cap, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// K-A: the uncapped keep mask, division-free predicate. `steps` (null, or
// int32 [rows]): the cluster kernel's steps a row, where it runs.
extern "C" int nms_fixpoint_keep_mask(const float* scores, const float* boxes, void* keep, int* steps,
                                      int rows, int k, float threshold, int union_mode,
                                      cudaStream_t stream) {
  return launch_rows<false, false>(scores, boxes, keep, steps, rows, k, threshold, 0, union_mode, stream);
}

// K-C: the keep mask capped at keep_top_k, dividing predicate; `steps` as K-A's.
extern "C" int nms_scan_keep_mask(const float* scores, const float* boxes, void* keep, int* steps, int rows,
                                  int k, float threshold, int keep_top_k, int union_mode,
                                  cudaStream_t stream) {
  return launch_rows<true, true>(scores, boxes, keep, steps, rows, k, threshold, keep_top_k, union_mode,
                                 stream);
}

// The cluster path's layout for [rows, k] rows on the current device: the
// CTAs of a row's cluster (0 where K takes another kernel, -1 on a CUDA
// error), the candidates of a tile, and the widest row it takes.
extern "C" int nms_cluster_ctas(int rows, int k) {
  if (rows <= 0 || k <= kMaxK || k > kClusterMaxK) return 0;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  return cluster_ctas(rows, k, sms);
}

extern "C" int nms_tile_candidates() { return kTile; }

extern "C" int nms_cluster_max_k() { return kClusterMaxK; }

extern "C" const char* ron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
