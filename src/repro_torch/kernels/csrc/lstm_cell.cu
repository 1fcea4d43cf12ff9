// Fused LSTM cell for the learned RecMG models, for Hopper (sm_90a), bound
// to Python through a plain C interface.
//
// Replaces the Pallas TPU kernel lstm_cell of
// src/repro/kernels/lstm_cell.py: z = [x, h] @ W + b with the gates in the
// order i, f, g, o; c' = sigmoid(f) c + sigmoid(i) tanh(g) and
// h' = sigmoid(o) tanh(c'), all in fp32.  When asked, it also writes the
// activated gates [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)], which the
// backward (PyTorch ops in repro_torch/kernels/ops.py) reads; the Pallas
// kernel has no backward.
//
// What bounds it: the product.  At the models' shapes (K = in + H <= 120,
// H = 40) one call reads ~4 MB at B = 4096 but does 2*B*K*4H = 157 MFLOP,
// so it is bound by fp32 operations, and below ~1e5 rows by the launch.
// The design keeps the product and the gate math in one pass, with nothing
// but h', c' (and the gates) written back:
//   * a block owns kRows batch rows; it stages the rows' [x, h] (the concat
//     is never materialised in device memory), the bias and, when it fits
//     in shared memory (76.8 KB for the decoder's 120 x 160, so dynamic
//     shared memory above the 48 KB default), the whole weight W;
//   * a thread owns one hidden unit j for kRowsPerThread rows: it keeps the
//     4 x kRowsPerThread gate sums in registers, reads the four weights of
//     unit j once per k and reuses each for all its rows, so there is no
//     cross-thread reduction;
//   * neighbouring threads own neighbouring units, so the W reads from
//     shared memory and the h', c' and gate writes are contiguous.
// K and H are any sizes (no 128-lane rule: that was the TPU's).  The sums
// run in fp32 in the order k = 0 .. K-1; expf and tanhf are the accurate
// functions (the build has no fast-math flag).
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;          // batch rows per block
constexpr int kRowsPerThread = 4;  // rows a thread carries for its unit
constexpr int kGroups = kRows / kRowsPerThread;
constexpr int kMaxThreads = 512;
constexpr int64_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int64_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

template <bool kStageW>
__global__ void __launch_bounds__(kMaxThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ h_out,
                 float* __restrict__ c_out, float* __restrict__ gates,
                 int64_t n, int in_dim, int hid) {
  extern __shared__ float smem[];
  const int k_dim = in_dim + hid;
  const int g_dim = 4 * hid;
  float* s_b = smem;                   // (4H,)
  float* s_xh = s_b + g_dim;           // (kRows, K)
  float* s_w = s_xh + kRows * k_dim;   // (K, 4H) when staged
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int i = tid; i < g_dim; i += nthr) s_b[i] = b[i];
  for (int i = tid; i < kRows * k_dim; i += nthr) {
    const int r = i / k_dim;
    const int k = i - r * k_dim;
    float v = 0.0f;
    if (r < rows) {
      v = k < in_dim ? x[(row0 + r) * in_dim + k]
                     : h[(row0 + r) * hid + (k - in_dim)];
    }
    s_xh[i] = v;
  }
  if (kStageW) {
    // 4H floats per row of W, so W is a whole number of float4s; torch
    // allocations are 16-byte aligned.
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float4* s_w4 = reinterpret_cast<float4*>(s_w);
    const int64_t n4 = static_cast<int64_t>(k_dim) * hid;
    for (int64_t i = tid; i < n4; i += nthr) s_w4[i] = w4[i];
  }
  __syncthreads();
  const float* wm = kStageW ? s_w : w;

  for (int item = tid; item < kGroups * hid; item += nthr) {
    const int grp = item / hid;
    const int j = item - grp * hid;
    const int r0 = grp * kRowsPerThread;
    if (r0 >= rows) continue;
    float acc[kRowsPerThread][4];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[q][g] = 0.0f;
    }
    const float* xh = s_xh + r0 * k_dim;
    for (int k = 0; k < k_dim; ++k) {
      const float* wk = wm + static_cast<int64_t>(k) * g_dim + j;
      const float w0 = wk[0];
      const float w1 = wk[hid];
      const float w2 = wk[2 * hid];
      const float w3 = wk[3 * hid];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float xv = xh[q * k_dim + k];
        acc[q][0] = fmaf(xv, w0, acc[q][0]);
        acc[q][1] = fmaf(xv, w1, acc[q][1]);
        acc[q][2] = fmaf(xv, w2, acc[q][2]);
        acc[q][3] = fmaf(xv, w3, acc[q][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int r = r0 + q;
      if (r >= rows) break;
      const int64_t row = row0 + r;
      const float gi = sigmoid(acc[q][0] + s_b[j]);
      const float gf = sigmoid(acc[q][1] + s_b[hid + j]);
      const float gg = tanhf(acc[q][2] + s_b[2 * hid + j]);
      const float go = sigmoid(acc[q][3] + s_b[3 * hid + j]);
      const float c2 = gf * c[row * hid + j] + gi * gg;
      c_out[row * hid + j] = c2;
      h_out[row * hid + j] = go * tanhf(c2);
      if (gates != nullptr) {
        float* gr = gates + row * g_dim;
        gr[j] = gi;
        gr[hid + j] = gf;
        gr[2 * hid + j] = gg;
        gr[3 * hid + j] = go;
      }
    }
  }
}

template <bool kStageW>
cudaError_t launch(const float* x, const float* h, const float* c,
                   const float* w, const float* b, float* h_out, float* c_out,
                   float* gates, int64_t n, int in_dim, int hid, int64_t smem,
                   cudaStream_t s) {
  static int64_t smem_set = kDefaultSmem;  // per instantiation
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel<kStageW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  int threads = ((kGroups * hid + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int64_t blocks = (n + kRows - 1) / kRows;
  lstm_cell_kernel<kStageW><<<static_cast<unsigned>(blocks), threads,
                              static_cast<size_t>(smem), s>>>(
      x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, in_dim), h and c (n, hid), w (in_dim + hid, 4 hid), b (4 hid,),
// all float32 and contiguous; h_out and c_out (n, hid); gates (n, 4 hid)
// or null.  n >= 1, in_dim >= 0, hid >= 1.
int repro_lstm_cell(const float* x, const float* h, const float* c,
                    const float* w, const float* b, float* h_out,
                    float* c_out, float* gates, int64_t n, int in_dim,
                    int hid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || in_dim < 0 || hid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t k_dim = in_dim + hid;
  const int64_t base = (4 * static_cast<int64_t>(hid) + kRows * k_dim) * 4;
  const int64_t staged = base + k_dim * 4 * hid * 4;
  cudaError_t err;
  if (staged <= kMaxSmem) {
    err = launch<true>(x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid,
                       staged, s);
  } else if (base <= kMaxSmem) {
    // W does not fit: read it through the cache from device memory.
    err = launch<false>(x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid,
                        base, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
