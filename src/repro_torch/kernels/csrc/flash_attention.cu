// Causal flash attention for Hopper (sm_90a), bound to Python through a
// plain C interface.
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py: o = softmax(q k^T / sqrt(hd) +
// causal mask) v with an online softmax whose running max m, running sum l
// and accumulator stay in fp32, and the output written once, in q's dtype.
// The Pallas kernel takes (BH, S, hd) with one KV head per query head and
// asserts S % block == 0; this one takes the JAX model's layout directly,
// q (B, S, H, hd) and k, v (B, S, K, hd) with H % K == 0, so grouped-query
// attention needs no transpose and no repeated KV: query head h reads KV
// head h / (H / K), the grouping of src/repro/models/layers.py (q reshaped
// to (B, S, K, G, hd) puts h = kv * G + g).  Any S works: the ragged tail
// of the last tiles is masked.  fp32 and bf16 inputs, hd in {16, 32, 64,
// 128}.
//
// What bounds it: the two products.  At the serve prefill shape (B = 8,
// S = 2048, H = 9, hd = 64) the causal work is 2 * 2 * B * H * S^2 / 2 * hd
// = 38.7 GFLOP against 50.3 MB of q, k, v and o, so the card's tensor-core
// rate is the bound.  This first kernel is the right and simple one: its
// products are fp32 FMAs from shared memory (no mma), so it runs at a few
// percent of that bound; a wgmma/TMA design is later work.  What the design
// does keep from the Pallas kernel is the traffic: q, k and v are read from
// device memory once per query tile and the (S, S) scores never leave the
// chip.
//   * a block owns one (batch, head) and kBlockQ = 64 queries; it stages
//     its queries once, then walks the KV tiles of kBlockK = 32 keys up to
//     the causal frontier (tiles past it are skipped; the Pallas kernel
//     computes and masks them, the same function);
//   * thread (rg, cg) of the 16 x 8 threads owns query rows rg + 16 i
//     (i < 4), key columns cg + 8 j (j < 4) of the score tile and head-dim
//     columns cg + 8 c (c < hd / 8) of the accumulator, so the score tile,
//     its softmax statistics and the rows of the accumulator they rescale
//     stay in one thread's registers; a row's max and sum are reduced over
//     its 8 threads, which are 8 neighbouring lanes, by shuffles;
//   * p goes through shared memory once per tile for the p v product; p is
//     kept in fp32 (as in the Pallas kernel);
//   * shared rows are padded (hd + 1 floats, 40 for p) so that the 32
//     lanes of a warp hit distinct banks in both products;
//   * the blocks of the last (costliest) query tiles are issued first.
// exp is the accurate expf and 1/l a true division (the build has no
// fast-math flag).
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                           // queries per block
constexpr int kBlockK = 32;                           // keys per KV tile
constexpr int kRowGroups = 16;                        // threads along queries
constexpr int kColGroups = 8;                         // threads along keys
constexpr int kThreads = kRowGroups * kColGroups;     // 128
constexpr int kRowsPerThread = kBlockQ / kRowGroups;  // 4
constexpr int kKeysPerThread = kBlockK / kColGroups;  // 4
constexpr int kPStride = kBlockK + 8;                 // padded row of p
constexpr int kMaxQTiles = 65535;                     // gridDim.y limit
constexpr int64_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <int HD>
constexpr int64_t smem_bytes() {
  return static_cast<int64_t>(kBlockQ * (HD + 1) + kBlockK * (HD + 1) +
                              kBlockK * HD + kBlockQ * kPStride) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int s_len, int n_heads, int n_kv, float scale) {
  constexpr int kStride = HD + 1;           // padded row of q and k
  constexpr int kCols = HD / kColGroups;    // accumulator columns a thread
  extern __shared__ float smem[];
  float* s_q = smem;                        // (kBlockQ, HD + 1)
  float* s_k = s_q + kBlockQ * kStride;     // (kBlockK, HD + 1)
  float* s_v = s_k + kBlockK * kStride;     // (kBlockK, HD)
  float* s_p = s_v + kBlockK * HD;          // (kBlockQ, kPStride)

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid - rg * kColGroups;

  // Row strides (elements) of the (B, S, H, hd) and (B, S, K, hd) layouts.
  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * s_len * q_row +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * s_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int pos = q0 + r;
    s_q[r * kStride + d] =
        pos < s_len ? to_float(q[q_base + pos * q_row + d]) : 0.0f;
  }

  float m[kRowsPerThread];
  float l[kRowsPerThread];
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // KV tiles up to the causal frontier of the tile's last real query.
  const int q_last = min(q0 + kBlockQ, s_len) - 1;
  const int n_tiles = q_last / kBlockK + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // s_q written; the last tile's s_k, s_v, s_p read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i - r * HD;
      const int pos = k0 + r;
      const bool ok = pos < s_len;
      const int64_t at = kv_base + pos * kv_row + d;
      s_k[r * kStride + d] = ok ? to_float(k[at]) : 0.0f;
      s_v[r * HD + d] = ok ? to_float(v[at]) : 0.0f;
    }
    __syncthreads();

    // Scores of the thread's 4 x 4 tile: q . k in fp32.
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread];
      float kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        qv[i] = s_q[(rg + kRowGroups * i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        kv[j] = s_k[(cg + kColGroups * j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
    }

    // Online softmax of each row over this tile.  All 32 lanes of every
    // warp run these shuffles: a row's 8 threads are lanes 8w .. 8w + 7.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = rg + kRowGroups * i;
      const int qpos = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kpos = k0 + cg + kColGroups * j;
        const bool keep = kpos <= qpos && kpos < s_len;
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      // A row that has seen no key yet has nothing to rescale.
      const float corr = m[i] == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        s_p[row * kPStride + cg + kColGroups * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kColGroups; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p v over the tile's keys.
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRowsPerThread];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        pv[i] = s_p[(rg + kRowGroups * i) * kPStride + j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = s_v[j * HD + cg + kColGroups * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qpos = q0 + rg + kRowGroups * i;
    if (qpos >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + q_base + qpos * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(orow + cg + kColGroups * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t batch, int s_len, int n_heads, int n_kv,
                   float scale, cudaStream_t stream) {
  constexpr int64_t smem = smem_bytes<HD>();
  static bool smem_set = false;  // per instantiation
  if (smem > kDefaultSmem && !smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(batch * n_heads),
                  static_cast<unsigned>((s_len + kBlockQ - 1) / kBlockQ));
  flash_attention_kernel<T, HD><<<grid, kThreads, static_cast<size_t>(smem),
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, n_heads, n_kv,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int64_t batch, int s_len, int n_heads, int n_kv,
                        int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, s_len, n_heads, n_kv, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, s_len, n_heads, n_kv, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, s_len, n_heads, n_kv, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, s_len, n_heads, n_kv, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (batch, s_len, n_heads, head_dim), k and v (batch, s_len, n_kv,
// head_dim), o like q; contiguous, all float32 (dtype 0) or all bfloat16
// (dtype 1).  n_heads % n_kv == 0, head_dim in {16, 32, 64, 128}, scale
// the softmax scale (1 / sqrt(head_dim) for the model).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int64_t batch, int64_t s_len, int n_heads,
                          int n_kv, int head_dim, int dtype, float scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_heads < n_kv ||
      n_heads % n_kv != 0 || batch * n_heads > 0x7fffffffLL ||
      (s_len + kBlockQ - 1) / kBlockQ > kMaxQTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sl = static_cast<int>(s_len);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_hd<float>(q, k, v, o, batch, sl, n_heads, n_kv, head_dim,
                             scale, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(q, k, v, o, batch, sl, n_heads, n_kv,
                                     head_dim, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
