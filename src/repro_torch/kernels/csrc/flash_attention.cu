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
// = 38.7 GFLOP against 50.3 MB of q, k, v and o, so the card's bf16
// tensor-core rate (989 TFLOP/s) is the bound.  Both designs keep the
// Pallas kernel's traffic: q, k and v are read once per query tile and the
// (S, S) scores never leave the chip; KV tiles past the causal frontier are
// skipped (the Pallas kernel computes and masks them: the same function),
// and the blocks of the last, costliest query tiles are issued first.
//
// bf16 inputs: both products on the tensor cores (flash_attention_mma),
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 through inline PTX, the FA2 shape:
//   * a block owns one (batch, head) and kMmaBlockQ = 128 queries, one warp
//     per 16 of them (8 warps); its queries are staged once and held as
//     mma A fragments in registers;
//   * KV tiles of kMmaBlockK = 64 keys, double-buffered in shared memory by
//     16-byte cp.async copies (the ragged tail zero-filled), so the next
//     tile's copy runs under this tile's products;
//   * shared rows are padded by 16 bytes (hd + 8 bf16), so the 8 row
//     addresses of each ldmatrix fall in distinct banks; K is read with
//     ldmatrix, V with ldmatrix.trans;
//   * the score tile's accumulator fragments (two adjacent n8 tiles) are
//     the A fragment of one k16 step of p v: p never goes through shared
//     memory.  p is rounded to bf16 for that product (as the JAX model's
//     blocked_causal_attention does); m, l and the accumulator stay fp32;
//   * the online softmax runs in registers: a row lives in the 4 lanes of a
//     quad, so its max and sum need two shuffles; 2^x (the SFU's
//     ex2.approx) on scores scaled by scale * log2(e); the causal mask is applied only on the tiles that
//     cross a warp's diagonal or the ragged end of S, and a warp skips a
//     tile whose keys all lie past its last query.
// fp32 inputs keep the first port's kernel (flash_attention_fma): fp32
// FMAs from shared memory, exact to ~1e-6 against the plain version, which
// TF32 tensor cores (10-bit mantissa) would not hold to 1e-5; it already
// beats the library's fp32 attention, and serving runs bf16.
//   * a block owns one (batch, head) and kBlockQ = 64 queries and walks KV
//     tiles of kBlockK = 32 keys;
//   * thread (rg, cg) of the 16 x 8 threads owns query rows rg + 16 i
//     (i < 4), key columns cg + 8 j (j < 4) of the score tile and head-dim
//     columns cg + 8 c (c < hd / 8) of the accumulator; a row's max and
//     sum are reduced over its 8 threads by shuffles;
//   * p goes through shared memory once per tile, in fp32; shared rows are
//     padded (hd + 1 floats, 40 for p) against bank conflicts.
// exp is the accurate expf for fp32 and ex2.approx for bf16 (its 2^-22
// relative error is far below p's bf16 rounding); 1/l is a true division
// (the build has no fast-math flag).
//
// A sliding window (window > 0; the Pallas kernel has none, JAX's windowed
// attention is XLA: src/repro/models/layers.py:77-191) limits query q to
// keys q - window < k <= q.  Both kernels then start their KV walk at the
// tile holding the block's first visible key, max(0, q0 - window + 1), and
// mask the tiles that cross that lower edge for any of their rows; the mma
// kernel's warps also skip a tile that lies wholly below their window.  A
// row late in a query tile can meet tiles that are all masked for it
// before its first visible key: it keeps m = -inf, l = 0 and a zero
// accumulator through them (p = 0, and the rescale of a row that has seen
// nothing is 1 or 0, never NaN).  window = 0 is the causal walk, with no
// instruction of its arithmetic changed, so its bits are those of the
// causal kernel; a window >= S masks no key of a real row.
//
// Unmasked attention (causal = 0; an encoder's self-attention, which JAX
// computes in XLA: src/repro/models/encdec.py::encode, plain_attention
// with causal=False) is an instantiation of its own (kCausal false): the
// KV walk runs to the end of S for every query tile, the warps skip no
// tile below S, and only the ragged end of S is masked.  The causal
// instantiation folds the flag away, so its instructions and bits are
// those of the kernels before it.  The work is twice the causal one's
// (4 * B * H * S^2 * hd operations); blocks are still issued last query
// tile first, which here orders nothing.
//
// With a non-null lse pointer both kernels also write each row's
// log-sum-exp of its scaled scores, lse (B, H, S) fp32 in natural-log
// units, m * scale + log(l): what the backward (flash_attention_bwd.cu)
// recomputes p from.  The mma kernel keeps m in raw scores and l in base 2
// units of the same exponent, so its lse is (m * scale_log2 + log2(l)) *
// ln(2).  A null lse is the serve path: no other instruction changes, so o
// keeps its bits.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

template <int HD>
constexpr int64_t fma_smem_bytes() {
  return static_cast<int64_t>(kBlockQ * (HD + 1) + kBlockK * (HD + 1) +
                              kBlockK * HD + kBlockQ * kPStride) * 4;
}

template <int HD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int s_len, int n_heads, int n_kv,
                    float scale, int window_arg) {
  const int window = kCausal ? window_arg : 0;  // 0: folds away
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
        pos < s_len ? q[q_base + pos * q_row + d] : 0.0f;
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

  // KV tiles from the window's edge for the block's first query up to the
  // causal frontier of its last real query (to the end of S unmasked).
  const int q_last = min(q0 + kBlockQ, s_len) - 1;
  const int n_tiles = (kCausal ? q_last : s_len - 1) / kBlockK + 1;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // s_q written; the last tile's s_k, s_v, s_p read
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i - r * HD;
      const int pos = k0 + r;
      const bool ok = pos < s_len;
      const int64_t at = kv_base + pos * kv_row + d;
      s_k[r * kStride + d] = ok ? k[at] : 0.0f;
      s_v[r * HD + d] = ok ? v[at] : 0.0f;
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
        const bool keep = (!kCausal || kpos <= qpos) && kpos < s_len &&
                          (window == 0 || qpos - kpos < window);
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
    float* orow = o + q_base + qpos * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      orow[cg + kColGroups * c] = acc[i][c] / denom;
    }
    // m is the row's largest scaled score; its 8 threads hold the same m, l.
    if (lse != nullptr && cg == 0) {
      lse[(static_cast<int64_t>(b) * n_heads + h) * s_len + qpos] =
          m[i] + logf(l[i]);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;     // 256
constexpr int kMmaBlockQ = 16 * kMmaWarps;      // 128 queries, 16 a warp
constexpr int kMmaBlockK = 64;                  // keys per KV tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr int64_t mma_smem_bytes() {
  // q, then two stages of k and of v, rows padded to hd + 8 bf16.
  return static_cast<int64_t>(kMmaBlockQ + 4 * kMmaBlockK) * (HD + 8) * 2;
}

// Fragment layouts: mma_bf16.cuh.  The C fragments of score columns
// 16 s .. 16 s + 7 and 16 s + 8 .. 16 s + 15 are, packed, the A fragment
// of p for key step s.
template <int HD, bool kCausal>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 2 : 1)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int s_len, int n_heads, int n_kv, float scale_log2,
                    int window_arg) {
  const int window = kCausal ? window_arg : 0;  // 0: folds away
  constexpr int kStride = HD + 8;              // padded row, bf16
  constexpr int kChunks = HD / 8;              // 16-byte chunks a row
  constexpr int kDSteps = HD / 16;             // k16 steps of q k^T
  constexpr int kSTiles = kMmaBlockK / 8;      // n8 tiles of the scores
  constexpr int kOTiles = HD / 8;              // n8 tiles of the output
  constexpr int kTileElems = kMmaBlockK * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + kMmaBlockQ * kStride;  // 2 stages
  __nv_bfloat16* s_v = s_k + 2 * kTileElems;        // 2 stages

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * s_len * q_row +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * s_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;

  // Rows past S are zero-filled (their source address stays in bounds).
  for (int i = tid; i < kMmaBlockQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int pos = q0 + r;
    cp_async16(smem_addr(s_q + r * kStride + c * 8),
               q + q_base + min(pos, s_len - 1) * q_row + c * 8,
               pos < s_len ? 16 : 0);
  }
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* dk = s_k + stage * kTileElems;
    __nv_bfloat16* dv = s_v + stage * kTileElems;
    for (int i = tid; i < kMmaBlockK * kChunks; i += kMmaThreads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const int pos = tile * kMmaBlockK + r;
      const int64_t at = kv_base + min(pos, s_len - 1) * kv_row + c * 8;
      const int n = pos < s_len ? 16 : 0;
      cp_async16(smem_addr(dk + r * kStride + c * 8), k + at, n);
      cp_async16(smem_addr(dv + r * kStride + c * 8), v + at, n);
    }
  };
  // KV tiles from the window's edge for the block's first query up to the
  // causal frontier of its last real query (to the end of S unmasked);
  // stage t & 1 holds tile t.
  const int q_last = min(q0 + kMmaBlockQ, s_len) - 1;
  const int n_tiles = (kCausal ? q_last : s_len - 1) / kMmaBlockK + 1;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kMmaBlockK : 0;
  load_kv(t_first, t_first & 1);
  cp_async_commit();

  // This warp's 16 rows: g and g + 8 of them are this lane's.
  const int w_first = q0 + 16 * warp;
  const int w_last = w_first + 15;
  const int row_lo = w_first + g;
  const int row_hi = row_lo + 8;
  uint32_t qf[kDSteps][4];
  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, raw scores
  float l_lo = 0.0f, l_hi = 0.0f;            // this lane's share of l

  for (int t = t_first; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_first) {
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
        ldmatrix_x4(qf[d], smem_addr(s_q + (16 * warp + (lane & 15)) *
                                               kStride +
                                     16 * d + 8 * (lane >> 4)));
      }
    }
    const int k0 = t * kMmaBlockK;
    // A warp whose queries all lie before this tile (causal), or past S,
    // skips it; so does a warp whose window starts after the tile's last
    // key.
    if ((!kCausal || k0 <= w_last) && w_first < s_len &&
        (window == 0 || k0 + kMmaBlockK > w_first - window + 1)) {
      const __nv_bfloat16* sk = s_k + (t & 1) * kTileElems;
      const __nv_bfloat16* sv = s_v + (t & 1) * kTileElems;
      float s[kSTiles][4];
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      }
      // s = q k^T.  One ldmatrix.x4 gives the b0, b1 of key tiles n and
      // n + 1 for one k16 step: lanes 8 i .. 8 i + 7 address keys
      // 8 (n + i / 2) .. + 7 at head dims 16 d + 8 (i % 2).
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
#pragma unroll
        for (int n = 0; n < kSTiles; n += 2) {
          uint32_t kb[4];
          const int key = 8 * (n + (lane >> 4)) + (lane & 7);
          ldmatrix_x4(kb, smem_addr(sk + key * kStride + 16 * d +
                                    8 * ((lane >> 3) & 1)));
          mma_bf16(s[n], qf[d], kb[0], kb[1]);
          mma_bf16(s[n + 1], qf[d], kb[2], kb[3]);
        }
      }
      // The causal mask, the end of S and the window's lower edge, on the
      // tiles that reach them.
      if ((kCausal && k0 + kMmaBlockK - 1 > w_first) ||
          k0 + kMmaBlockK > s_len ||
          (window > 0 && k0 < w_last - window + 1)) {
#pragma unroll
        for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = e < 2 ? row_lo : row_hi;
            if ((kCausal && key > row) || key >= s_len ||
                (window > 0 && row - key >= window)) {
              s[n][e] = -INFINITY;
            }
          }
        }
      }
      // Online softmax: a row's 16 scores here, its 64 over the quad.
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // A row that has seen no key yet (max -inf) has nothing to rescale
      // and no p: subtract 0, not -inf.
      const float base_lo = mx_lo == -INFINITY ? 0.0f : mx_lo * scale_log2;
      const float base_hi = mx_hi == -INFINITY ? 0.0f : mx_hi * scale_log2;
      const float corr_lo = exp2_approx(fmaf(m_lo, scale_log2, -base_lo));
      const float corr_hi = exp2_approx(fmaf(m_hi, scale_log2, -base_hi));
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        s[n][0] = exp2_approx(fmaf(s[n][0], scale_log2, -base_lo));
        s[n][1] = exp2_approx(fmaf(s[n][1], scale_log2, -base_lo));
        s[n][2] = exp2_approx(fmaf(s[n][2], scale_log2, -base_hi));
        s[n][3] = exp2_approx(fmaf(s[n][3], scale_log2, -base_hi));
        sum_lo += s[n][0] + s[n][1];
        sum_hi += s[n][2] + s[n][3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= corr_lo;
        acc[n][1] *= corr_lo;
        acc[n][2] *= corr_hi;
        acc[n][3] *= corr_hi;
      }
      // acc += p v, p from the score fragments; one ldmatrix.x4.trans
      // gives the b0, b1 of head-dim tiles n and n + 1 for key step j:
      // lanes 8 i .. 8 i + 7 address keys 16 j + 8 (i % 2) .. + 7 at head
      // dims 8 (n + i / 2).
#pragma unroll
      for (int j = 0; j < kMmaBlockK / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const int key = 16 * j + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
        for (int n = 0; n < kOTiles; n += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_addr(sv + key * kStride +
                                          8 * (n + (lane >> 4))));
          mma_bf16(acc[n], pa, vb[0], vb[1]);
          mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f);
  const float den_hi = fmaxf(l_hi, 1e-30f);
  // The quad's 4 lanes hold the row's m and, after the shuffles, its l.
  if (lse != nullptr && t4 == 0) {
    const int64_t lse_base = (static_cast<int64_t>(b) * n_heads + h) * s_len;
    if (row_lo < s_len) {
      lse[lse_base + row_lo] = fmaf(m_lo, scale_log2, log2f(l_lo)) * kLn2;
    }
    if (row_hi < s_len) {
      lse[lse_base + row_hi] = fmaf(m_hi, scale_log2, log2f(l_hi)) * kLn2;
    }
  }
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) {
    const int col = 8 * n + 2 * t4;
    if (row_lo < s_len) {
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + row_lo * q_row + col) =
          __floats2bfloat162_rn(acc[n][0] / den_lo, acc[n][1] / den_lo);
    }
    if (row_hi < s_len) {
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + row_hi * q_row + col) =
          __floats2bfloat162_rn(acc[n][2] / den_hi, acc[n][3] / den_hi);
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

template <int HD, bool kCausal>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int64_t batch, int s_len, int n_heads,
                       int n_kv, float scale, int window,
                       cudaStream_t stream) {
  constexpr int64_t smem = fma_smem_bytes<HD>();
  static bool smem_set = false;  // per instantiation
  cudaError_t err =
      allow_smem(flash_attention_fma<HD, kCausal>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * n_heads),
                  static_cast<unsigned>((s_len + kBlockQ - 1) / kBlockQ));
  flash_attention_fma<HD, kCausal><<<grid, kThreads,
                                     static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s_len, n_heads, n_kv, scale, window);
  return cudaGetLastError();
}

template <int HD, bool kCausal>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int64_t batch, int s_len, int n_heads,
                       int n_kv, float scale, int window,
                       cudaStream_t stream) {
  constexpr int64_t smem = mma_smem_bytes<HD>();
  static bool smem_set = false;  // per instantiation
  cudaError_t err =
      allow_smem(flash_attention_mma<HD, kCausal>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * n_heads),
                  static_cast<unsigned>((s_len + kMmaBlockQ - 1) /
                                        kMmaBlockQ));
  flash_attention_mma<HD, kCausal><<<grid, kMmaThreads,
                                     static_cast<size_t>(smem), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, n_heads, n_kv, scale * kLog2e,
      window);
  return cudaGetLastError();
}

template <int HD, bool kCausal>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* o, void* lse, int64_t batch, int s_len,
                         int n_heads, int n_kv, int dtype, float scale,
                         int window, cudaStream_t stream) {
  return dtype == 0
             ? launch_fma<HD, kCausal>(q, k, v, o, lse, batch, s_len,
                                       n_heads, n_kv, scale, window, stream)
             : launch_mma<HD, kCausal>(q, k, v, o, lse, batch, s_len,
                                       n_heads, n_kv, scale, window, stream);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int64_t batch, int s_len, int n_heads, int n_kv,
                   int dtype, float scale, int window, bool causal,
                   cudaStream_t stream) {
  return causal ? launch_dtype<HD, true>(q, k, v, o, lse, batch, s_len,
                                         n_heads, n_kv, dtype, scale, window,
                                         stream)
                : launch_dtype<HD, false>(q, k, v, o, lse, batch, s_len,
                                          n_heads, n_kv, dtype, scale, 0,
                                          stream);
}

}  // namespace

extern "C" {

// q (batch, s_len, n_heads, head_dim), k and v (batch, s_len, n_kv,
// head_dim), o like q; contiguous, all float32 (dtype 0) or all bfloat16
// (dtype 1; 16-byte aligned, for the 16-byte copies).  n_heads % n_kv ==
// 0, head_dim in {16, 32, 64, 128}, scale the softmax scale (1 /
// sqrt(head_dim) for the model).  lse: null, or (batch, n_heads, s_len)
// float32 for each row's log-sum-exp.  window: 0 (causal), or the sliding
// window's size (query q sees keys q - window < k <= q).  causal: 1, or 0
// for every query to see every key (window 0 only).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse, int64_t batch, int64_t s_len,
                          int n_heads, int n_kv, int head_dim, int dtype,
                          float scale, int64_t window, int causal,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || s_len < 1 || n_kv < 1 || n_heads < n_kv || window < 0 ||
      (causal != 0 && causal != 1) || (causal == 0 && window != 0) ||
      n_heads % n_kv != 0 || batch * n_heads > 0x7fffffffLL ||
      (s_len + kBlockQ - 1) / kBlockQ > kMaxQTiles ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int sl = static_cast<int>(s_len);
  // A window wider than S masks nothing: it is kept within int.
  const int win = static_cast<int>(window < s_len ? window : s_len);
  cudaError_t err;
  switch (head_dim) {
    case 16:
      err = launch<16>(q, k, v, o, lse, batch, sl, n_heads, n_kv, dtype,
                         scale, win, causal == 1, s);
      break;
    case 32:
      err = launch<32>(q, k, v, o, lse, batch, sl, n_heads, n_kv, dtype,
                         scale, win, causal == 1, s);
      break;
    case 64:
      err = launch<64>(q, k, v, o, lse, batch, sl, n_heads, n_kv, dtype,
                         scale, win, causal == 1, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, lse, batch, sl, n_heads, n_kv, dtype,
                        scale, win, causal == 1, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
