// Bidirectional Chamfer distance (the RecMG paper's Eq. 5) for the prefetch
// model's loss, for Hopper (sm_90a), bound to Python through a plain C
// interface.
//
// Replaces the Pallas TPU kernel chamfer of
// src/repro/kernels/chamfer_kernel.py: for each batch row,
//   d2[p, w] = |po_p - w_w|^2,
//   loss = alpha * mean_p min_w d2 + (1 - alpha) * mean_w min_p d2.
// It also writes the argmins of the two min-reductions (arg_fwd (B, P),
// arg_bwd (B, W), ties to the lowest index), which the backward (PyTorch
// ops in repro_torch/kernels/ops.py) reads; the Pallas kernel has no
// backward.
//
// What bounds it: bytes.  A row is tiny (P = 5, W = 15, F = 25: 2 KB of
// inputs, 375 multiply-adds per pair set), so at B = 65,536 the 131 MB
// read takes 39 us at 3.35 TB/s while the arithmetic takes ~1 us.  The
// design reads each input once and writes nothing but the loss and the
// argmins: the (P, W, F) difference tensor and the (P, W) distances never
// leave the SM.
//   * one warp owns one batch row: its lanes copy the row's po and w into
//     shared memory with contiguous loads, then split the P x W pairs;
//   * each pair's distance sums over F in index order, with one rounding
//     per operation (__fsub_rn, __fmul_rn, __fadd_rn: no contraction into
//     FMAs), so the distances, the argmins and the loss equal the plain
//     version's bit for bit;
//   * lanes over p (and over w) take the min-reductions with a strict "<",
//     so ties go to the lowest index, and lane 0 sums the P (and W) minima
//     in index order and divides with an IEEE division.
// Ragged batches need no padding: a warp past the last row does nothing.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // batch rows per block
// Shared memory a block gets without cudaFuncSetAttribute: rows of up to
// 6 KB of staged floats each (the prefetch loss's P = 5, W = 15, F = 25
// row takes 2.4 KB).
constexpr int64_t kMaxSmem = 48 * 1024;

__global__ void __launch_bounds__(kWarps * 32)
chamfer_kernel(const float* __restrict__ po, const float* __restrict__ w,
               float* __restrict__ loss, int32_t* __restrict__ arg_fwd,
               int32_t* __restrict__ arg_bwd, int64_t n, int n_p, int n_w,
               int n_f, float alpha, float beta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = (n_p + n_w) * n_f + n_p * n_w + n_p + n_w;
  float* s_po = smem + static_cast<int64_t>(warp) * per_warp;  // (P, F)
  float* s_w = s_po + n_p * n_f;                               // (W, F)
  float* s_d2 = s_w + n_w * n_f;                               // (P, W)
  float* s_fmin = s_d2 + n_p * n_w;                            // (P,)
  float* s_bmin = s_fmin + n_p;                                // (W,)
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      warp;
  if (row >= n) return;  // the whole warp: only __syncwarp follows

  const float* po_r = po + row * n_p * n_f;
  const float* w_r = w + row * n_w * n_f;
  for (int i = lane; i < n_p * n_f; i += 32) s_po[i] = po_r[i];
  for (int i = lane; i < n_w * n_f; i += 32) s_w[i] = w_r[i];
  __syncwarp();

  for (int pair = lane; pair < n_p * n_w; pair += 32) {
    const int p = pair / n_w;
    const int q = pair - p * n_w;
    const float* a = s_po + p * n_f;
    const float* bq = s_w + q * n_f;
    float acc = 0.0f;
    for (int f = 0; f < n_f; ++f) {
      const float d = __fsub_rn(a[f], bq[f]);
      const float sq = __fmul_rn(d, d);
      acc = f == 0 ? sq : __fadd_rn(acc, sq);
    }
    s_d2[pair] = acc;
  }
  __syncwarp();

  for (int p = lane; p < n_p; p += 32) {
    const float* d = s_d2 + p * n_w;
    float best = d[0];
    int arg = 0;
    for (int q = 1; q < n_w; ++q) {
      if (d[q] < best) {
        best = d[q];
        arg = q;
      }
    }
    s_fmin[p] = best;
    arg_fwd[row * n_p + p] = arg;
  }
  for (int q = lane; q < n_w; q += 32) {
    float best = s_d2[q];
    int arg = 0;
    for (int p = 1; p < n_p; ++p) {
      const float v = s_d2[p * n_w + q];
      if (v < best) {
        best = v;
        arg = p;
      }
    }
    s_bmin[q] = best;
    arg_bwd[row * n_w + q] = arg;
  }
  __syncwarp();

  if (lane == 0) {
    float fs = s_fmin[0];
    for (int p = 1; p < n_p; ++p) fs = __fadd_rn(fs, s_fmin[p]);
    float bs = s_bmin[0];
    for (int q = 1; q < n_w; ++q) bs = __fadd_rn(bs, s_bmin[q]);
    const float fwd = __fdiv_rn(fs, static_cast<float>(n_p));
    const float bwd = __fdiv_rn(bs, static_cast<float>(n_w));
    loss[row] = __fadd_rn(__fmul_rn(alpha, fwd), __fmul_rn(beta, bwd));
  }
}

}  // namespace

extern "C" {

// po (n, n_p, n_f) and w (n, n_w, n_f) float32, contiguous; loss (n,)
// float32; arg_fwd (n, n_p) and arg_bwd (n, n_w) int32.  alpha and beta
// weigh the two directions (beta = 1 - alpha, rounded on the host as the
// plain version rounds it).  n >= 1, n_p >= 1, n_w >= 1, n_f >= 1.
int repro_chamfer(const float* po, const float* w, float* loss,
                  int32_t* arg_fwd, int32_t* arg_bwd, int64_t n, int n_p,
                  int n_w, int n_f, float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n_p < 1 || n_w < 1 || n_f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_warp =
      (static_cast<int64_t>(n_p + n_w) * n_f + int64_t{n_p} * n_w + n_p +
       n_w) * 4;
  const int64_t smem = per_warp * kWarps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  chamfer_kernel<<<static_cast<unsigned>(blocks), kWarps * 32,
                   static_cast<size_t>(smem), s>>>(
      po, w, loss, arg_fwd, arg_bwd, n, n_p, n_w, n_f, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
