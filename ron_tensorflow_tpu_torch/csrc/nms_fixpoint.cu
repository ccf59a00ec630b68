// Greedy-NMS keep mask of score-sorted rows through the suppression fixpoint.
//
// Replaces the TPU kernel ron_tensorflow_tpu/kernels/nms_pallas.py
// `pallas_nms_fixpoint_keep_mask` (body `_nms_fixpoint_kernel`).
//
// What it computes, per row of K candidates sorted by descending score:
//   hit[i][j] = inter(i, j) >= t * denom(i, j) && denom(i, j) > 0
//     ('min': denom = min(vol_i, vol_j); 'union': vol_i + vol_j - inter),
//   sup[i][j] = hit[i][j] && i < j,       valid[j] = score[j] > 0,
//   keep = the fixpoint of keep[j] = valid[j] && !any_i (keep[i] && sup[i][j]),
//   iterated from keep = valid; the fixpoint is the sequential greedy keep set.
// The predicate is the TPU kernel's, division-free (nms_pallas.py:179-181).
// Every product and sum is written with explicit round-to-nearest intrinsics
// so nvcc cannot contract them into FMAs: the masks then equal the plain
// PyTorch version's bit for bit.
//
// Design: one block per row, one thread per candidate j (K <= 1024). The
// boxes sit in shared memory; thread j builds column j of the [K, K]
// suppression relation as ceil(K/32) 32-bit words (bit i = "i suppresses
// j"), 200 x 7 words = 5.6 KB at K = 200. The keep set is a bitmask of the
// same width, double-buffered: each step, thread j ANDs its column with the
// keep mask, the warps publish the new mask with __ballot_sync, and a
// block-wide __syncthreads_or says whether any word changed. The loop ends
// at the fixpoint, and after at most K steps (level n of the greedy
// recurrence settles after n steps, so K always suffices).
//
// Bound on the H100: latency, not bytes or operations. At the main path's
// [640, 200] the inputs are 2.6 MB and the mask build ~0.15 GFLOP; each
// fixpoint step is a few dependent shared-memory passes and a barrier, and
// the number of steps is the depth of the longest suppression chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float box_volume(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Boxes are (ymin, xmin, ymax, xmax) in (x, y, z, w).
__device__ __forceinline__ bool overlap_hit(float4 a, float vol_a, float4 b, float vol_b,
                                            float threshold, int union_mode) {
  const float ih = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float denom =
      union_mode ? __fsub_rn(__fadd_rn(vol_a, vol_b), inter) : fminf(vol_a, vol_b);
  return inter >= __fmul_rn(threshold, denom) && denom > 0.0f;
}

__global__ void __launch_bounds__(1024)
nms_fixpoint_kernel(const float* __restrict__ scores, const float* __restrict__ boxes,
                    uint8_t* __restrict__ keep, int k, float threshold, int union_mode) {
  extern __shared__ float4 smem_boxes[];
  const int words = (k + 31) / 32;
  float* vols = reinterpret_cast<float*>(smem_boxes + k);
  uint32_t* sup = reinterpret_cast<uint32_t*>(vols + k);  // [k][words]
  uint32_t* keep_bits = sup + k * words;                   // [2][words]

  const int row = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const float* row_scores = scores + static_cast<size_t>(row) * k;
  const float* row_boxes = boxes + static_cast<size_t>(row) * k * 4;

  bool valid = false;
  if (j < k) {
    const float4 b = make_float4(row_boxes[4 * j], row_boxes[4 * j + 1],
                                 row_boxes[4 * j + 2], row_boxes[4 * j + 3]);
    smem_boxes[j] = b;
    vols[j] = box_volume(b);
    valid = row_scores[j] > 0.0f;
  }
  __syncthreads();

  if (j < k) {
    const float4 bj = smem_boxes[j];
    const float vj = vols[j];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      const int end = min(32, j - 32 * w);  // suppressors i < j only
      for (int t = 0; t < end; ++t) {
        const int i = 32 * w + t;
        if (overlap_hit(smem_boxes[i], vols[i], bj, vj, threshold, union_mode)) {
          bits |= 1u << t;
        }
      }
      sup[j * words + w] = bits;
    }
  }

  // blockDim.x == 32 * words, so warp w owns keep word w.
  const uint32_t valid_bits = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) keep_bits[warp] = valid_bits;
  __syncthreads();

  int cur = 0;
  for (int step = 0; step < k; ++step) {
    bool suppressed = false;
    if (j < k) {
      const uint32_t* col = sup + j * words;
      const uint32_t* kb = keep_bits + cur * words;
      for (int w = 0; w < words; ++w) suppressed |= (col[w] & kb[w]) != 0u;
    }
    const uint32_t next = __ballot_sync(0xffffffffu, valid && !suppressed);
    int changed = 0;
    if (lane == 0) {
      changed = next != keep_bits[cur * words + warp];
      keep_bits[(cur ^ 1) * words + warp] = next;
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }

  if (j < k) {
    keep[static_cast<size_t>(row) * k + j] = (keep_bits[cur * words + warp] >> lane) & 1u;
  }
}

}  // namespace

extern "C" int nms_fixpoint_keep_mask(const float* scores, const float* boxes, void* keep,
                                      int rows, int k, float threshold, int union_mode,
                                      cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (k > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + 31) / 32;
  const size_t smem = sizeof(float4) * k + sizeof(float) * k +
                      sizeof(uint32_t) * (static_cast<size_t>(k) * words + 2 * words);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_fixpoint_kernel<<<rows, 32 * words, smem, stream>>>(
      scores, boxes, static_cast<uint8_t*>(keep), k, threshold, union_mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ron_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
