// Greedy-NMS keep mask of score-sorted rows by the sequential scan, with the
// keep_top_k cap inside the scan.
//
// Replaces the TPU kernel ron_tensorflow_tpu/kernels/nms_pallas.py
// `pallas_nms_keep_mask` (body `_nms_kernel`).
//
// What it computes, per row of K candidates: for i = 0 .. K-1 in order,
//   take_i = alive_i && score_i > 0 && kept < keep_top_k;
//   if take_i: keep_i = 1, kept += 1, and every j with ov(i, j) >= t dies,
//   ov(i, j) = denom > 0 ? inter / denom : 0
//     ('min': denom = min(vol_i, vol_j); 'union': vol_i + vol_j - inter).
// The predicate DIVIDES, as the TPU kernel does (nms_pallas.py:75); it may
// differ from nms_fixpoint.cu's division-free one for a pair that sits on
// the threshold. The division is IEEE (__fdiv_rn, never __fdividef), and
// every other product, sum and difference is written with a round-to-nearest
// intrinsic so nvcc cannot contract it into an FMA: the masks then equal the
// plain PyTorch version's bit for bit.
//
// Design: one warp per row, four rows per block (K <= 1024). The row's
// boxes, volumes and scores sit in shared memory. Lane l owns candidates
// j = l + 32 t (t < ceil(K/32) <= 32) and keeps their alive flags as bits of
// one register. Step i broadcasts alive_i from its owner lane with
// __shfl_sync; the decision is warp-uniform, and when i is taken each lane
// clears the bits of its own candidates j > i that i suppresses: no block
// barrier anywhere. The scan stops once keep_top_k candidates are kept.
//
// Bound on the H100: latency. The work is K dependent steps per row; at the
// main path's [640, 200] the inputs are 2.6 MB and the overlaps of the kept
// candidates a fraction of a GFLOP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__global__ void __launch_bounds__(32 * kWarps)
nms_scan_kernel(const float* __restrict__ scores, const float* __restrict__ boxes,
                uint8_t* __restrict__ keep, int rows, int k, float threshold, int keep_top_k,
                int union_mode) {
  extern __shared__ float4 smem_boxes[];  // [kWarps][k]
  float* vols = reinterpret_cast<float*>(smem_boxes + kWarps * k);  // [kWarps][k]
  float* row_sc = vols + kWarps * k;                                // [kWarps][k]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // only warp-level synchronisation below
  float4* bx = smem_boxes + warp * k;
  float* vol = vols + warp * k;
  float* sc = row_sc + warp * k;
  const float* rs = scores + static_cast<size_t>(row) * k;
  const float* rb = boxes + static_cast<size_t>(row) * k * 4;

  for (int j = lane; j < k; j += 32) {
    // (ymin, xmin, ymax, xmax) in (x, y, z, w)
    const float4 b = make_float4(rb[4 * j], rb[4 * j + 1], rb[4 * j + 2], rb[4 * j + 3]);
    bx[j] = b;
    vol[j] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    sc[j] = rs[j];
  }
  __syncwarp();

  const int words = (k + 31) / 32;
  uint32_t alive = 0xffffffffu;  // bit t: candidate lane + 32 t
  uint32_t kept_bits = 0;
  int kept = 0;
  for (int i = 0; i < k && kept < keep_top_k; ++i) {
    const int t = i >> 5;
    const uint32_t alive_i = __shfl_sync(0xffffffffu, (alive >> t) & 1u, i & 31);
    if (!alive_i || !(sc[i] > 0.0f)) continue;
    if (lane == (i & 31)) kept_bits |= 1u << t;
    ++kept;
    const float4 a = bx[i];
    const float va = vol[i];
    for (int tt = t; tt < words; ++tt) {
      const int j = lane + 32 * tt;
      if (j <= i || j >= k) continue;
      const float4 b = bx[j];
      const float vb = vol[j];
      const float ih = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
      const float iw = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
      const float inter = __fmul_rn(ih, iw);
      const float denom = union_mode ? __fsub_rn(__fadd_rn(va, vb), inter) : fminf(va, vb);
      const float ov = denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
      if (ov >= threshold) alive &= ~(1u << tt);
    }
  }

  uint8_t* out = keep + static_cast<size_t>(row) * k;
  for (int tt = 0; tt < words; ++tt) {
    const int j = lane + 32 * tt;
    if (j < k) out[j] = (kept_bits >> tt) & 1u;
  }
}

}  // namespace

extern "C" int nms_scan_keep_mask(const float* scores, const float* boxes, void* keep, int rows,
                                  int k, float threshold, int keep_top_k, int union_mode,
                                  cudaStream_t stream) {
  if (rows <= 0 || k <= 0) return 0;
  if (k > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * k * (sizeof(float4) + 2 * sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<(rows + kWarps - 1) / kWarps, 32 * kWarps, smem, stream>>>(
      scores, boxes, static_cast<uint8_t*>(keep), rows, k, threshold, keep_top_k, union_mode);
  return static_cast<int>(cudaGetLastError());
}
