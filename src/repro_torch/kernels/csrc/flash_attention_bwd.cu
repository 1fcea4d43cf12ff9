// Backward of causal flash attention for Hopper (sm_90a), bound to Python
// through a plain C interface.
//
// No TPU kernel stands behind this one: the JAX package differentiates the
// XLA counterpart of its Pallas flash_attention
// (src/repro/models/layers.py::blocked_causal_attention), whose query
// blocks sit under jax.checkpoint so that the (S, S) scores are never
// stored.  This is the same bargain on the card: the forward
// (flash_attention.cu) keeps each row's log-sum-exp, and the backward
// recomputes the scores tile by tile from q, k and it, so nothing of size
// S^2 reaches device memory.
//
// Contract: q (B, S, H, hd), k and v (B, S, K, hd) with H % K == 0 (query
// head h reads KV head h / (H / K)), o and dO like q, lse (B, H, S) fp32 in
// natural-log units; any S (the ragged tail is masked), hd in {16, 32, 64,
// 128}, fp32 or bf16 (widened to fp32 on load).  With s = q k^T * scale,
// p = exp(s - lse) (0 above the diagonal) and delta_i = sum_d dO_i o_i:
//   dV = sum p^T dO,   dP = dO v^T,   dS = p (dP - delta),
//   dQ = dS k * scale, dK = sum dS^T q * scale,
// dK and dV summed over the G = H / K query heads that share a KV head.
// dq is written in q's dtype, dk and dv in k's.
//
// What bounds it: the five products, 5 * 2 * B * H * S^2 / 2 * hd
// operations (causal).  This first design runs them on fp32 FMAs from
// shared memory, bf16 included (tensor cores are a later redesign), in
// three kernels on the caller's stream:
//   1. attn_bwd_delta: delta (B, H, S) fp32, 8 lanes a row;
//   2. attn_bwd_dkdv: a block per (batch, KV head, 64-key tile) stages its
//      k and v once, walks the G query heads and, for each, the query
//      tiles from its own to the end of S (tiles before the diagonal have
//      no unmasked entry and are skipped), and keeps dK and dV in
//      registers in fp32: each written once, no atomics, deterministic;
//   3. attn_bwd_dq: a block per (batch, head, 64-query tile) stages q, dO,
//      lse and delta once, walks the KV tiles up to the diagonal and writes
//      dQ once.
// Both recompute the score tile (s and dP in one pass over hd, 4 x 4
// entries a thread) and put p and dS through shared memory for the
// products that sum over the tile's other axis (4 rows x hd / 16 columns
// of the accumulator a thread).  Shared rows are padded by one float
// against bank conflicts.  Blocks of the costliest tiles are issued first.
// exp is the accurate expf; nothing is allocated here (the wrapper hands
// in delta's buffer) and nothing synchronises.  The C function returns
// cudaGetLastError() after its three launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                      // queries or keys a tile
constexpr int kGrid = 16;                      // 16 x 16 threads a tile
constexpr int kThreads = kGrid * kGrid;        // 256
constexpr int kPer = kTile / kGrid;            // 4 rows (and keys) a thread
constexpr int kSStride = kTile + 1;            // padded row of p and dS
constexpr int kDeltaLanes = 8;                 // lanes a row of delta
constexpr int kMaxTiles = 65535;               // gridDim.y limit
constexpr int64_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * o[b, s, h, d]: kDeltaLanes lanes
// a row of the (B * S * H, HD) view, reduced by shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, int64_t rows, int s_len,
               int n_heads) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) /
      kDeltaLanes;
  const int lane = threadIdx.x % kDeltaLanes;
  float acc = 0.0f;
  if (row < rows) {
    const T* orow = o + row * HD;
    const T* drow = dout + row * HD;
#pragma unroll
    for (int d = lane; d < HD; d += kDeltaLanes) {
      acc = fmaf(widen(drow[d]), widen(orow[d]), acc);
    }
  }
#pragma unroll
  for (int off = 1; off < kDeltaLanes; off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < rows && lane == 0) {
    // row = (b * S + s) * H + h  ->  delta[(b * H + h) * S + s].
    const int64_t h = row % n_heads;
    const int64_t bs = row / n_heads;
    const int64_t s = bs % s_len;
    const int64_t b = bs / s_len;
    delta[(b * n_heads + h) * s_len + s] = acc;
  }
}

// Stages rows [row0, row0 + kTile) of one head of a (B, S, heads, HD)
// tensor (base already at the batch and head) as fp32, row stride HD + 1;
// rows past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row_stride, int row0,
                                      int s_len) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int pos = row0 + r;
    dst[r * (HD + 1) + d] =
        pos < s_len ? widen(src[pos * row_stride + d]) : 0.0f;
  }
}

// Stages lse and delta of query rows [q0, q0 + kTile) of one head (0 past
// S, where p is masked anyway).
__device__ __forceinline__ void stage_rows(float* s_lse, float* s_delta,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int q0, int s_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int pos = q0 + r;
    s_lse[r] = pos < s_len ? lse[pos] : 0.0f;
    s_delta[r] = pos < s_len ? delta[pos] : 0.0f;
  }
}

// One 64 x 64 score tile: s = q k^T and dP = dO v^T in one pass over hd,
// thread (rg, cg) owning query rows rg + 16 i and keys cg + 16 j; then
// p = exp(s * scale - lse) where key <= query < S (else 0) and dS =
// p (dP - delta).  Writes dS, and p when s_p is not null, with rows =
// queries, row stride kSStride.
template <int HD>
__device__ __forceinline__ void score_tile(
    const float* s_q, const float* s_do, const float* s_k, const float* s_v,
    const float* s_lse, const float* s_delta, float* s_p, float* s_ds,
    int q0, int k0, int s_len, float scale, int rg, int cg) {
  constexpr int kStride = HD + 1;
  float s[kPer][kPer];
  float dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[i][j] = 0.0f;
      dp[i][j] = 0.0f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[kPer], dov[kPer], kv[kPer], vv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = s_q[(rg + kGrid * i) * kStride + d];
      dov[i] = s_do[(rg + kGrid * i) * kStride + d];
      kv[i] = s_k[(cg + kGrid * i) * kStride + d];
      vv[i] = s_v[(cg + kGrid * i) * kStride + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = rg + kGrid * i;
    const int qpos = q0 + r;
    const float row_lse = s_lse[r];
    const float row_delta = s_delta[r];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = cg + kGrid * j;
      const bool keep = k0 + c <= qpos && qpos < s_len;
      const float p = keep ? expf(fmaf(s[i][j], scale, -row_lse)) : 0.0f;
      if (s_p != nullptr) s_p[r * kSStride + c] = p;
      s_ds[r * kSStride + c] = p * (dp[i][j] - row_delta);
    }
  }
}

template <int HD>
constexpr int64_t dkdv_smem_bytes() {
  // k, v, q, dO tiles; p and dS; lse and delta.
  return static_cast<int64_t>(4 * kTile * (HD + 1) + 2 * kTile * kSStride +
                              2 * kTile) * 4;
}

template <int HD>
constexpr int64_t dq_smem_bytes() {
  // q, dO, k, v tiles; dS; lse and delta.
  return static_cast<int64_t>(4 * kTile * (HD + 1) + kTile * kSStride +
                              2 * kTile) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int s_len, int n_heads,
              int n_kv, float scale) {
  constexpr int kStride = HD + 1;
  constexpr int kCols = HD / kGrid;  // accumulator columns a thread
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * kStride;
  float* s_q = s_v + kTile * kStride;
  float* s_do = s_q + kTile * kStride;
  float* s_p = s_do + kTile * kStride;
  float* s_ds = s_p + kTile * kSStride;
  float* s_lse = s_ds + kTile * kSStride;
  float* s_delta = s_lse + kTile;

  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x - b * n_kv;
  const int group = n_heads / n_kv;
  // Key tile 0 sees every query tile: the costliest blocks come first.
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int rg = threadIdx.x / kGrid;
  const int cg = threadIdx.x - rg * kGrid;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * s_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;
  stage<T, HD>(s_k, k + kv_base, kv_row, k0, s_len);
  stage<T, HD>(s_v, v + kv_base, kv_row, k0, s_len);

  // Thread (rg, cg) accumulates keys rg + 16 a, head dims cg + 16 c.
  float acc_k[kPer][kCols];
  float acc_v[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_k[a][c] = 0.0f;
      acc_v[a][c] = 0.0f;
    }
  }

  const int n_qt = (s_len + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t q_base = static_cast<int64_t>(b) * s_len * q_row +
                           static_cast<int64_t>(h) * HD;
    const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * s_len;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last tile's q, dO, p and dS are read
      stage<T, HD>(s_q, q + q_base, q_row, q0, s_len);
      stage<T, HD>(s_do, dout + q_base, q_row, q0, s_len);
      stage_rows(s_lse, s_delta, lse + row_base, delta + row_base, q0,
                 s_len);
      __syncthreads();
      score_tile<HD>(s_q, s_do, s_k, s_v, s_lse, s_delta, s_p, s_ds, q0, k0,
                     s_len, scale, rg, cg);
      __syncthreads();
      // dV += p^T dO and dK += dS^T q over the tile's queries.
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pv[kPer], dsv[kPer], dov[kCols], qv[kCols];
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
          pv[a] = s_p[i * kSStride + rg + kGrid * a];
          dsv[a] = s_ds[i * kSStride + rg + kGrid * a];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = s_do[i * kStride + cg + kGrid * c];
          qv[c] = s_q[i * kStride + cg + kGrid * c];
        }
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[a][c] = fmaf(pv[a], dov[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qv[c], acc_k[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int kpos = k0 + rg + kGrid * a;
    if (kpos >= s_len) continue;
    const int64_t at = kv_base + kpos * kv_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(dk + at + cg + kGrid * c, acc_k[a][c] * scale);
      store(dv + at + cg + kGrid * c, acc_v[a][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dq, int s_len, int n_heads, int n_kv,
            float scale) {
  constexpr int kStride = HD + 1;
  constexpr int kCols = HD / kGrid;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kTile * kStride;
  float* s_k = s_do + kTile * kStride;
  float* s_v = s_k + kTile * kStride;
  float* s_ds = s_v + kTile * kStride;
  float* s_lse = s_ds + kTile * kSStride;
  float* s_delta = s_lse + kTile;

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  // The last query tile walks the most KV tiles: issued first.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int rg = threadIdx.x / kGrid;
  const int cg = threadIdx.x - rg * kGrid;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * s_len * q_row +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * s_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;
  const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * s_len;
  stage<T, HD>(s_q, q + q_base, q_row, q0, s_len);
  stage<T, HD>(s_do, dout + q_base, q_row, q0, s_len);
  stage_rows(s_lse, s_delta, lse + row_base, delta + row_base, q0, s_len);

  // Thread (rg, cg) accumulates queries rg + 16 a, head dims cg + 16 c.
  float acc[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;
  }

  // KV tiles up to the diagonal (tiles of queries and keys coincide).
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // q, dO staged; the last tile's k and dS are read
    stage<T, HD>(s_k, k + kv_base, kv_row, k0, s_len);
    stage<T, HD>(s_v, v + kv_base, kv_row, k0, s_len);
    __syncthreads();
    score_tile<HD>(s_q, s_do, s_k, s_v, s_lse, s_delta, nullptr, s_ds, q0,
                   k0, s_len, scale, rg, cg);
    __syncthreads();
    // dQ += dS k over the tile's keys.
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float dsv[kPer], kv[kCols];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        dsv[a] = s_ds[(rg + kGrid * a) * kSStride + j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = s_k[j * kStride + cg + kGrid * c];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int qpos = q0 + rg + kGrid * a;
    if (qpos >= s_len) continue;
    const int64_t at = q_base + qpos * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(dq + at + cg + kGrid * c, acc[a][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Raises a kernel's dynamic shared memory limit once, where it needs more
// than the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t smem, bool* done) {
  if (smem <= kDefaultSmem || *done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int64_t batch,
                   int s_len, int n_heads, int n_kv, float scale,
                   cudaStream_t stream) {
  constexpr int64_t dkdv_smem = dkdv_smem_bytes<HD>();
  constexpr int64_t dq_smem = dq_smem_bytes<HD>();
  static bool dkdv_set = false;  // per instantiation
  static bool dq_set = false;
  cudaError_t err = allow_smem(attn_bwd_dkdv<T, HD>, dkdv_smem, &dkdv_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dq<T, HD>, dq_smem, &dq_set);
  if (err != cudaSuccess) return err;

  const int64_t rows = batch * s_len * n_heads;
  const int64_t delta_blocks = (rows * kDeltaLanes + kThreads - 1) / kThreads;
  attn_bwd_delta<T, HD><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      s_len, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned n_tiles = static_cast<unsigned>((s_len + kTile - 1) / kTile);
  attn_bwd_dkdv<T, HD><<<dim3(static_cast<unsigned>(batch * n_kv), n_tiles),
                         kThreads, static_cast<size_t>(dkdv_smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), s_len, n_heads, n_kv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  attn_bwd_dq<T, HD><<<dim3(static_cast<unsigned>(batch * n_heads), n_tiles),
                       kThreads, static_cast<size_t>(dq_smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), s_len, n_heads, n_kv, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int64_t batch, int s_len, int n_heads,
                         int n_kv, float scale, cudaStream_t stream) {
  return dtype == 0
             ? launch<float, HD>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 batch, s_len, n_heads, n_kv, scale, stream)
             : launch<__nv_bfloat16, HD>(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, batch, s_len, n_heads, n_kv,
                                         scale, stream);
}

}  // namespace

extern "C" {

// q, o, dout, dq (batch, s_len, n_heads, head_dim); k, v, dk, dv (batch,
// s_len, n_kv, head_dim); contiguous, all float32 (dtype 0) or all
// bfloat16 (dtype 1).  lse (batch, n_heads, s_len) float32 from the
// forward; delta a float32 scratch of the same shape, overwritten.
// n_heads % n_kv == 0, head_dim in {16, 32, 64, 128}, scale the forward's
// softmax scale.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int64_t batch,
                              int64_t s_len, int n_heads, int n_kv,
                              int head_dim, int dtype, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_heads < n_kv ||
      n_heads % n_kv != 0 || batch * n_heads > 0x7fffffffLL ||
      (s_len + kTile - 1) / kTile > kMaxTiles ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sl = static_cast<int>(s_len);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  switch (head_dim) {
    case 16:
      err = launch_dtype<16>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv,
                             batch, sl, n_heads, n_kv, scale, s);
      break;
    case 32:
      err = launch_dtype<32>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv,
                             batch, sl, n_heads, n_kv, scale, s);
      break;
    case 64:
      err = launch_dtype<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv,
                             batch, sl, n_heads, n_kv, scale, s);
      break;
    case 128:
      err = launch_dtype<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv,
                              batch, sl, n_heads, n_kv, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
