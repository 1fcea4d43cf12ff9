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
// so it is bound by fp32 operations (2.4 us at 67 TFLOP/s), and below ~1e5
// rows by the launch.  The products stay fp32 FMAs: TF32 would not hold
// 1e-5.  The design keeps the product and the gate math in one pass, with
// nothing but h', c' (and the gates) written back:
//   * the grid tiles (rows, hidden units): a block owns a tile of 16, 32 or
//     64 rows and a slice of kUnits = 8 hidden units with all four of their
//     gates, so the gate math stays in one thread.  The host picks the
//     largest row tile that still gives two blocks per SM (64 rows at
//     B = 4096: 320 blocks; 16 at B = 256: 80), so both the inference and
//     the training batch spread over the card;
//   * a block stages its rows' [x, h] (the concat is never materialised in
//     device memory), zero-padded to K4 = K rounded up to 4, and only its
//     slice of W, (K4, 4 gates, 8 units).  Staging is 16-byte cp.async
//     copies, all issued before the block waits, so the block waits out the
//     memory latency once and in few requests (4-byte copies, one a value,
//     took longer than the FMAs).  Rows whose x or h width is
//     not a multiple of 4 floats are not 16-byte aligned: the block's x rows
//     and h rows are each one contiguous range, copied flat and repacked
//     into rows in shared memory.  Aligned rows skip that step: the flat
//     copy doubles the rows' shared memory and was slower at every aligned
//     shape of the path;
//   * thread (row group, unit) keeps 4 rows x 4 gates of sums in
//     registers; per 4 values of k it loads 4 float4 of [x, h] (its rows)
//     and 16 floats of W (its unit's gates) for 64 FMAs, 3.2 FMAs a load.
//     In a warp the 8 threads of a row group read 8 neighbouring floats of
//     W and one float4 of [x, h], so the loads have no bank conflicts;
//   * when the slice of W does not fit beside the rows in shared memory,
//     or H is not a multiple of 4 (its gates' slices are then not 16-byte
//     aligned), W is read from device memory through the cache instead.
// There is no 128-lane rule (that was the TPU's): H is any size, and K up
// to what 16 staged rows leave of the 227 KB of shared memory, 3,632 when
// in_dim and H are multiples of 4 and 1,815 otherwise (the flat copies
// double the rows' footprint); a larger K is refused.  The path's K are
// 57-120.  The sums
// run in fp32 in the order k = 0 .. K-1; expf and tanhf are the accurate
// functions (the build has no fast-math flag).
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kUnits = 8;          // hidden units a block owns
constexpr int kRowsPerThread = 4;  // rows a thread carries for its unit
constexpr int kMaxRowGroups = 16;  // 64 rows, 128 threads a block
constexpr int kMinRowGroups = 4;   // 16 rows, 32 threads a block
static_assert(kMinRowGroups * kUnits % 32 == 0,
              "the staging loops give each warp whole rows");
constexpr int64_t kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int64_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n_bytes (0..16) from global to shared memory, the rest of the 16 bytes
// zero-filled; only the n_bytes are read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n_bytes));
}

// The floats [first, last) of a, from the 16-byte boundary at or below
// first, into dst (16-byte aligned): a[first] lands at dst[first % 4].
__device__ __forceinline__ void stage_flat(float* dst, const float* a,
                                           int64_t first, int64_t last,
                                           int tid, int nthr) {
  const int64_t base = first & ~int64_t{3};
  const int chunks = static_cast<int>((last - base + 3) / 4);
  for (int i = tid; i < chunks; i += nthr) {
    const int64_t at = base + 4 * i;
    const int64_t left = last - at;
    cp_async16(dst + 4 * i, a + at, left >= 4 ? 16 : static_cast<int>(4 * left));
  }
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

// acc[g] += x * (w.x, w.y, w.z, w.w)[g]: one k of the four gates.
__device__ __forceinline__ void fma4(float (&acc)[4], float x, float4 w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// Shared memory (floats): s_x (rows, K4), then s_w (K4, 4, kUnits) when
// staged, then, when a row of x or h is not 16-byte aligned, the flat
// copies of the block's x and h rows (rows in + 4, rows H + 4).
template <bool kStageW>
__global__ void __launch_bounds__(kUnits * kMaxRowGroups)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ h_out,
                 float* __restrict__ c_out, float* __restrict__ gates,
                 int64_t n, int in_dim, int hid, int k4) {
  extern __shared__ float4 smem4[];
  const int k_dim = in_dim + hid;
  const int g_dim = 4 * hid;
  const int nthr = blockDim.x;
  const int rows = (nthr / kUnits) * kRowsPerThread;  // rows of the block
  float* s_x = reinterpret_cast<float*>(smem4);       // (rows, K4)
  float* s_w = s_x + rows * k4;                       // (K4, 4, kUnits)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int live = static_cast<int>(n - row0 < rows ? n - row0 : rows);
  const int j0 = blockIdx.y * kUnits;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_warps = nthr / 32;

  // Staging is 16-byte cp.async copies, all issued before the block
  // waits: the block pays the memory latency once, in few requests.
  const bool aligned = in_dim % 4 == 0 && hid % 4 == 0;
  float* s_flat = s_w + (kStageW ? k4 * 4 * kUnits : 0);
  // The flat x copy, its shift included, in whole 16-byte chunks.
  const int x_span = (live * in_dim + 6) / 4 * 4;
  if (aligned) {
    // Row r's chunks straight into s_x[r], a warp a row (K4 = K here);
    // zeros past n.
    const int cx = in_dim / 4;
    for (int r = warp; r < rows; r += n_warps) {
      const int64_t row = r < live ? row0 + r : row0;
      for (int q = lane; q < k4 / 4; q += 32) {
        cp_async16(s_x + r * k4 + 4 * q,
                   q < cx ? x + row * in_dim + 4 * q
                          : h + row * hid + 4 * (q - cx),
                   r < live ? 16 : 0);
      }
    }
  } else {
    // The block's rows of x and of h are each one contiguous range.
    stage_flat(s_flat, x, row0 * in_dim, (row0 + live) * in_dim, tid, nthr);
    stage_flat(s_flat + x_span, h, row0 * hid, (row0 + live) * hid, tid,
               nthr);
  }
  if (kStageW) {
    // s_w[k][g][u] = W[k][g H + j0 + u]; zeros past K and past H.  H is a
    // multiple of 4 here, so each half of a gate's 8 units is 16 bytes.
    for (int i = tid; i < k4 * 8; i += nthr) {
      const int k = i / 8;  // (k, gate, half)
      const int gate = (i / 2) % 4;
      const int half = i % 2;
      const bool ok = k < k_dim && j0 + 4 * half < hid;
      cp_async16(s_w + i * 4,
                 w + (ok ? static_cast<int64_t>(k) * g_dim + gate * hid + j0 +
                               4 * half
                         : 0),
                 ok ? 16 : 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!aligned) {
    // Rows as [x, h, zeros] of K4 from the flat copies.
    const int sx = static_cast<int>((row0 * in_dim) % 4);
    const int sh = static_cast<int>((row0 * hid) % 4);
    for (int r = warp; r < rows; r += n_warps) {
      for (int k = lane; k < k4; k += 32) {
        float v = 0.0f;
        if (r < live && k < in_dim) {
          v = s_flat[sx + r * in_dim + k];
        } else if (r < live && k < k_dim) {
          v = s_flat[x_span + sh + r * hid + (k - in_dim)];
        }
        s_x[r * k4 + k] = v;
      }
    }
    __syncthreads();
  }

  const int u = tid % kUnits;
  const int r0 = (tid / kUnits) * kRowsPerThread;
  const int j = j0 + u;
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[q][g] = 0.0f;
  }
  const float* xr = s_x + r0 * k4;
  for (int k = 0; k < k4; k += 4) {
    float4 wv[4];  // the four gates' weights at k + e
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kStageW) {
        const float* wk = s_w + (k + e) * 4 * kUnits + u;
        wv[e] = make_float4(wk[0], wk[kUnits], wk[2 * kUnits],
                            wk[3 * kUnits]);
      } else if (k + e < k_dim && j < hid) {
        const float* wk = w + static_cast<int64_t>(k + e) * g_dim + j;
        wv[e] = make_float4(__ldg(wk), __ldg(wk + hid), __ldg(wk + 2 * hid),
                            __ldg(wk + 3 * hid));
      } else {
        wv[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + q * k4 + k);
      fma4(acc[q], xv.x, wv[0]);
      fma4(acc[q], xv.y, wv[1]);
      fma4(acc[q], xv.z, wv[2]);
      fma4(acc[q], xv.w, wv[3]);
    }
  }
  if (j >= hid) return;

  const float bi = b[j], bf = b[hid + j], bg = b[2 * hid + j],
              bo = b[3 * hid + j];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    if (r0 + q >= live) break;
    const int64_t row = row0 + r0 + q;
    const float gi = sigmoid(acc[q][0] + bi);
    const float gf = sigmoid(acc[q][1] + bf);
    const float gg = tanhf(acc[q][2] + bg);
    const float go = sigmoid(acc[q][3] + bo);
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

template <bool kStageW>
cudaError_t launch(const float* x, const float* h, const float* c,
                   const float* w, const float* b, float* h_out, float* c_out,
                   float* gates, int64_t n, int in_dim, int hid, int k4,
                   int row_groups, int64_t smem, cudaStream_t s) {
  static int64_t smem_set = kDefaultSmem;  // per instantiation
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel<kStageW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int rows = row_groups * kRowsPerThread;
  const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows),
                  static_cast<unsigned>((hid + kUnits - 1) / kUnits));
  lstm_cell_kernel<kStageW><<<grid, row_groups * kUnits,
                              static_cast<size_t>(smem), s>>>(
      x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid, k4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, in_dim), h and c (n, hid), w (in_dim + hid, 4 hid), b (4 hid,),
// all float32 and contiguous, x, h and w 16-byte aligned (the staging
// copies 16 bytes at a time); h_out and c_out (n, hid); gates (n, 4 hid)
// or null.  n >= 1, in_dim >= 0, hid >= 1, and K = in_dim + hid at most
// 3,632 when in_dim and hid are multiples of 4, else at most 1,815;
// otherwise it returns cudaErrorInvalidValue and launches nothing.
int repro_lstm_cell(const float* x, const float* h, const float* c,
                    const float* w, const float* b, float* h_out,
                    float* c_out, float* gates, int64_t n, int in_dim,
                    int hid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || in_dim < 0 || hid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(w)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t k4 = (static_cast<int64_t>(in_dim) + hid + 3) / 4 * 4;
  const int64_t slices = (hid + kUnits - 1) / kUnits;
  // The largest row tile that still gives two blocks per SM.
  int row_groups = kMaxRowGroups;
  while (row_groups > kMinRowGroups &&
         (n + row_groups * kRowsPerThread - 1) /
                 (row_groups * kRowsPerThread) * slices <
             2 * sm_count()) {
    row_groups /= 2;
  }
  // Bytes of s_x, of s_w and of the flat copies for rows that are not
  // 16-byte aligned (all in floats, times 4).
  const bool aligned = in_dim % 4 == 0 && hid % 4 == 0;
  const int64_t w_bytes = k4 * 4 * kUnits * 4;
  auto x_bytes = [&](int64_t groups) {
    const int64_t rows = groups * kRowsPerThread;
    return (rows * k4 + (aligned ? 0 : rows * (in_dim + hid) + 16)) * 4;
  };
  while (x_bytes(row_groups) > kMaxSmem && row_groups > kMinRowGroups) {
    row_groups /= 2;
  }
  if (k4 > 0x7fffffff || x_bytes(row_groups) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k = static_cast<int>(k4);
  cudaError_t err;
  if (hid % 4 == 0 && x_bytes(row_groups) + w_bytes <= kMaxSmem) {
    err = launch<true>(x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid, k,
                       row_groups, x_bytes(row_groups) + w_bytes, s);
  } else {
    // The slice of W does not fit, or is not 16-byte aligned: read it
    // through the cache.
    err = launch<false>(x, h, c, w, b, h_out, c_out, gates, n, in_dim, hid,
                        k, row_groups, x_bytes(row_groups), s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
