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
// Contract: q (B, Sq, H, hd), k and v (B, Sk, K, hd) with H % K == 0 (query
// head h reads KV head h / (H / K)), o and dO like q, lse (B, H, Sq) fp32
// in natural-log units from the forward of the same mask and offset; any
// Sq and Sk (the ragged tails are masked), hd in {16, 32, 64, 128}, fp32
// or bf16.  Query row i sits at absolute position q_offset + i, the keys at
// 0 .. Sk - 1 (causal needs q_offset + Sq <= Sk); Sq = Sk at offset 0 is
// the model's own attention, and a sequence-parallel rank's queries against
// every key are the rest.  Every mask, tile frontier and walk below compares
// absolute positions; with q_offset 0 and Sq = Sk only integer arithmetic
// differs from a kernel of one length, so those calls keep their bits.
// dK and dV cover all Sk keys, summed over this call's queries only (a
// partial the caller sums over the ranks of a split); a key tile that no
// query of the call sees is written as zeros.  With s = q k^T * scale,
// p = exp(s - lse) (0 where the mask hides the key) and delta_i = sum_d
// dO_i o_i:
//   dV = sum p^T dO,   dP = dO v^T,   dS = p (dP - delta),
//   dQ = dS k * scale, dK = sum dS^T q * scale,
// dK and dV summed over the G = H / K query heads that share a KV head.
// dq is written in q's dtype, dk and dv in k's.
//
// What bounds it: the five products, 5 * 2 * B * H * S^2 / 2 * hd
// operations (causal): 0.1954 ms on the bf16 tensor cores (989 TFLOP/s)
// at the LM training cut, q (4, 4096, 9, 64), k/v (4, 4096, 3, 64).  A
// delta pass (attn_bwd_delta: delta (B, H, S) fp32, 8 lanes a row) comes
// first in both dtypes.  No atomics anywhere: each gradient element is
// summed by one thread in a fixed order, so a call gives the same bits
// every time (a resumed training run repeats the uninterrupted one's
// losses bit for bit).  Blocks of the costliest tiles are issued first.
//
// bf16: FlashAttention-2's backward on mma.sync.m16n8k16 bf16 x bf16 ->
// fp32 (the forward's inline-PTX helpers, mma_bf16.cuh), two kernels:
//   1. attn_bwd_dkdv_mma: a block per (batch, KV head, 64-key tile, split
//      of the G query heads), 4 warps, each owning 16 keys.  A warp
//      computes the transposed tiles S^T = k q^T and dP^T = v dO^T with k
//      and v as the A operands (held in registers for the whole block at
//      hd <= 64, re-read by ldmatrix at hd 128 to stay under 255 registers)
//      and q, dO tiles as B operands read by ldmatrix; P^T = 2^(S^T *
//      scale * log2 e - lse * log2 e) and dS^T = P^T (dP^T - delta), lse
//      and delta being the column values staged per query tile, masked on
//      the tiles that cross the warp's diagonal or the end of S.  P^T and
//      dS^T are packed to bf16 straight from the C fragments as the A
//      operands of dV += P^T dO and dK += dS^T q (dO and q read by
//      ldmatrix.trans): P and dS never go through shared memory.  dK and dV
//      accumulate in fp32 registers over the split's query heads and every
//      query tile from the diagonal on, and are written once.  Query tiles
//      are 64 rows (32 at hd 128, for registers).
//   2. attn_bwd_dq_mma: a block per (batch, head, 64-query tile), 4 warps
//      of 16 queries holding their q and dO A fragments in registers; K and
//      V tiles of 32 keys as B operands.  S = q k^T, dP = dO
//      v^T, dS = P (dP - delta) and dQ += dS k, dS packed from the C
//      fragments and k read by ldmatrix.trans.  S and dP are computed again
//      here (7 products where FA2 with atomics does 5): the price of
//      determinism; the bound counts the function's 5.
//   Tiles stay bf16 in shared memory, rows padded by 16 bytes (hd + 8) so
//   each ldmatrix's 8 row addresses fall in distinct banks, loaded by
//   16-byte cp.async (4-byte for lse and delta) with the next tile's copy
//   in flight under this tile's products; ragged tails are zero-filled.
//   Where the key tiles of all KV heads would not fill the card
//   (qwen2.5-3b's 1 x 2 KV heads x 64 tiles = 128 blocks for 132 SMs,
//   the block of key tile 0 walking 8 heads x 64 query tiles), the G query
//   heads are split over blocks (the caller picks the count): each split
//   writes fp32 dK/dV partials to a scratch the wrapper allocates, and
//   attn_bwd_sum_splits adds them in split order, scales and rounds once.
//   Registers: 3 blocks of 128 threads an SM at hd <= 64 (168 a thread for
//   dK/dV with k and v held), 2 at hd 128 (242); no spills.
//   Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PR 21): 1.12
//   ms at the training cut (17% of the bound; SDPA's backward 0.59 ms; the
//   FMA design it replaces 11.08 ms), 1.04 ms at qwen2.5-3b's heads (1,
//   4096, 16/2, 128) with the heads split 4 ways (2.00 ms unsplit; the
//   plain version 15.3 ms, SDPA 0.47 ms).  What holds it back: mma.sync
//   with 16-row warp tiles reads every B fragment from shared memory by
//   ldmatrix for one use, and dQ recomputes S and dP.
//
// fp32: the first port's kernels on FMAs (attn_bwd_dkdv, attn_bwd_dq): the
// same two walks with 64 x 64 tiles staged in shared memory (rows padded by
// one float), the score tile recomputed as s and dP in one pass over hd (4
// x 4 entries a thread), p and dS through shared memory.  They beat the
// library's fp32 backward, and TF32 tensor cores would not hold 1e-5.
//
// A sliding window (window > 0, as the forward takes it: query q sees keys
// q - window < k <= q) shortens both walks in both dtypes: a key tile's
// query walk (dK/dV) ends at the tile of its last key + window - 1, and a
// query tile's key walk (dQ) starts at the tile of max(0, q0 - window + 1).
// The tiles that cross the window's lower edge mask q - k >= window as the
// forward does (p = 0, so dS = 0 there), and the mma kernels' warps skip a
// tile that lies wholly outside their window.  Every row keeps its
// diagonal key, so no row is fully masked.  window = 0 is the causal walk,
// in an instantiation of its own (kMask kCausal) where the window's terms
// fold away, so the causal kernels run the instructions they ran without it;
// the wrapper passes a window of S or more as S, which masks no key of a
// real row and walks every causal tile, so it gives the causal bits.
//
// Unmasked attention (causal = 0: an encoder's self-attention, whose
// gradient JAX takes through XLA's plain_attention(causal=False)) is a
// third instantiation (kMask kFull): the dK/dV walk starts at query tile
// 0, the dQ walk runs to the end of S, the warps skip no tile below S and
// only the ragged end of S is masked.  The causal and windowed
// instantiations fold its terms away.  Its work is twice the causal
// backward's, 5 * 2 * B * H * S^2 * hd operations.
//
// exp is the SFU's 2^x for bf16 and the accurate expf for fp32.  Nothing is
// allocated here (the wrapper hands in delta's buffer and the partials)
// and nothing synchronises.  The C functions return cudaGetLastError()
// after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// The mask of an instantiation: causal, causal in a sliding window, or
// none (every query sees every key).
constexpr int kCausal = 0;
constexpr int kWindowed = 1;
constexpr int kFull = 2;

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
// fp32 tensor (base already at the batch and head), row stride HD + 1;
// rows past S are zeros.
template <int HD>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int64_t row_stride, int row0,
                                      int s_len) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int pos = row0 + r;
    dst[r * (HD + 1) + d] =
        pos < s_len ? src[pos * row_stride + d] : 0.0f;
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
// p = exp(s * scale - lse) where the query row is below Sq, key <= its
// absolute position q_off + row and, with a window, that position - key <
// window (kFull: where the row is below Sq and key < Sk), else 0, and
// dS = p (dP - delta).  Writes dS, and p when s_p is not null, with rows =
// queries, row stride kSStride.  q0 is the tile's first local row.
template <int HD, int kMask>
__device__ __forceinline__ void score_tile(
    const float* s_q, const float* s_do, const float* s_k, const float* s_v,
    const float* s_lse, const float* s_delta, float* s_p, float* s_ds,
    int q0, int k0, int q_off, int sq_len, int sk_len, int window,
    float scale, int rg, int cg) {
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
    const int qpos = q0 + r;        // local row
    const int qabs = q_off + qpos;  // its absolute position
    const float row_lse = s_lse[r];
    const float row_delta = s_delta[r];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = cg + kGrid * j;
      const bool keep = (kMask == kFull ? k0 + c < sk_len : k0 + c <= qabs) &&
                        qpos < sq_len &&
                        (window == 0 || qabs - (k0 + c) < window);
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

template <int HD, int kMask>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int sq_len,
              int sk_len, int q_off, int n_heads, int n_kv, int window_arg,
              float scale) {
  const int window = kMask == kWindowed ? window_arg : 0;  // 0: folds away
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
  // Key tile 0 sees every query: the costliest blocks come first.
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int rg = threadIdx.x / kGrid;
  const int cg = threadIdx.x - rg * kGrid;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * sk_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;
  stage<HD>(s_k, k + kv_base, kv_row, k0, sk_len);
  stage<HD>(s_v, v + kv_base, kv_row, k0, sk_len);

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

  // Local query tiles from the first whose absolute positions reach key k0
  // (from 0 unmasked) to the end of Sq or, with a window, to the tile of
  // the last key's last visible query; none when that query lies before
  // the call's rows (the tile's dK and dV are then written as zeros).
  int n_qt = (sq_len + kTile - 1) / kTile;
  if (window > 0) {
    const int last = min(k0 + kTile, sk_len) + window - 2 - q_off;
    n_qt = last < 0 ? 0 : min(n_qt, last / kTile + 1);
  }
  const int qt0 = kMask == kFull ? 0 : max(0, k0 - q_off) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t q_base = static_cast<int64_t>(b) * sq_len * q_row +
                           static_cast<int64_t>(h) * HD;
    const int64_t row_base =
        (static_cast<int64_t>(b) * n_heads + h) * sq_len;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the last tile's q, dO, p and dS are read
      stage<HD>(s_q, q + q_base, q_row, q0, sq_len);
      stage<HD>(s_do, dout + q_base, q_row, q0, sq_len);
      stage_rows(s_lse, s_delta, lse + row_base, delta + row_base, q0,
                 sq_len);
      __syncthreads();
      score_tile<HD, kMask>(s_q, s_do, s_k, s_v, s_lse, s_delta, s_p, s_ds,
                            q0, k0, q_off, sq_len, sk_len, window, scale, rg,
                            cg);
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
    if (kpos >= sk_len) continue;
    const int64_t at = kv_base + kpos * kv_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + cg + kGrid * c] = acc_k[a][c] * scale;
      dv[at + cg + kGrid * c] = acc_v[a][c];
    }
  }
}

template <int HD, int kMask>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int sq_len, int sk_len, int q_off,
            int n_heads, int n_kv, int window_arg, float scale) {
  const int window = kMask == kWindowed ? window_arg : 0;  // 0: folds away
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
  const int64_t q_base = static_cast<int64_t>(b) * sq_len * q_row +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * sk_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;
  const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * sq_len;
  stage<HD>(s_q, q + q_base, q_row, q0, sq_len);
  stage<HD>(s_do, dout + q_base, q_row, q0, sq_len);
  stage_rows(s_lse, s_delta, lse + row_base, delta + row_base, q0, sq_len);

  // Thread (rg, cg) accumulates queries rg + 16 a, head dims cg + 16 c.
  float acc[kPer][kCols];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;
  }

  // KV tiles up to the diagonal of the tile's last real query, at
  // absolute positions (to the end of Sk unmasked), from the tile of the
  // first query's first visible key.
  const int kt0 = window > 0 ? max(0, q_off + q0 - window + 1) / kTile : 0;
  const int kt_last = kMask == kFull
                          ? (sk_len - 1) / kTile
                          : (q_off + min(q0 + kTile, sq_len) - 1) / kTile;
  for (int kt = kt0; kt <= kt_last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // q, dO staged; the last tile's k and dS are read
    stage<HD>(s_k, k + kv_base, kv_row, k0, sk_len);
    stage<HD>(s_v, v + kv_base, kv_row, k0, sk_len);
    __syncthreads();
    score_tile<HD, kMask>(s_q, s_do, s_k, s_v, s_lse, s_delta, nullptr,
                          s_ds, q0, k0, q_off, sq_len, sk_len, window, scale,
                          rg, cg);
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
    if (qpos >= sq_len) continue;
    const int64_t at = q_base + qpos * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dq[at + cg + kGrid * c] = acc[a][c] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;  // 128
constexpr int kMmaRows = 16 * kMmaWarps;     // 64 keys (dK/dV), queries (dQ)
constexpr float kLog2e = 1.4426950408889634f;

// The inner tile of each walk.  dK/dV steps over 64 query rows, 32 at hd
// 128, where the fp32 dK and dV of 16 keys x 128 already take 128
// registers a thread.  dQ steps over 32 keys: its S and dP then take 32
// registers, which keeps it unspilled at 3 blocks an SM at hd 64.
template <int HD>
constexpr int kQStep = HD <= 64 ? 64 : 32;
constexpr int kKStep = 32;
// Blocks an SM the register budget is sized for (launch bounds): 3 at hd
// <= 64; at hd 128 the compiler's choice (2, at 236-242 registers).
template <int HD>
constexpr int kMinBlocks = HD <= 64 ? 3 : 1;

// dK/dV warps hold their k and v A fragments (hd / 2 registers) for the
// whole block at hd <= 64; at hd 128 they re-read them by ldmatrix.
template <int HD>
constexpr bool kMmaHoldKV = HD <= 64;

template <int HD>
constexpr int64_t dkdv_mma_smem_bytes() {
  // k and v, two stages of q and of dO, rows padded to hd + 8 bf16; two
  // stages of lse and of delta.
  return static_cast<int64_t>(2 * kMmaRows + 4 * kQStep<HD>) * (HD + 8) *
             2 +
         4 * kQStep<HD> * 4;
}

template <int HD>
constexpr int64_t dq_mma_smem_bytes() {
  // q and dO, two stages of k and of v, rows padded to hd + 8 bf16.
  return static_cast<int64_t>(2 * kMmaRows + 4 * kKStep) * (HD + 8) * 2;
}

// 4 bytes from global to shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// Copies rows [row0, row0 + ROWS) of one head of a (B, S, heads, HD) bf16
// tensor (src already at the batch and head) into dst, row stride HD + 8,
// by 16-byte cp.async; rows past S are zero-filled (their source address
// stays in bounds).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    int64_t row_stride, int row0, int s_len) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int pos = row0 + r;
    cp_async16(smem_addr(dst + r * (HD + 8) + c * 8),
               src + min(pos, s_len - 1) * row_stride + c * 8,
               pos < s_len ? 16 : 0);
  }
}

// The A fragment of k16 step d of tile rows row0 .. row0 + 15.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int d, int lane) {
  ldmatrix_x4(a, smem_addr(tile + (row0 + (lane & 15)) * (HD + 8) + 16 * d +
                           8 * (lane >> 4)));
}

// b0, b1 of n8 tiles n and n + 1 at k16 step d of B = tile^T (the tile's
// rows are B's columns): lanes 8 i .. 8 i + 7 address rows 8 (n + i / 2)
// .. + 7 at columns 16 d + 8 (i % 2).
template <int HD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int n,
                                       int d, int lane) {
  ldmatrix_x4(b, smem_addr(tile + (8 * (n + (lane >> 4)) + (lane & 7)) *
                                      (HD + 8) +
                           16 * d + 8 * ((lane >> 3) & 1)));
}

// b0, b1 of n8 tiles n and n + 1 at k16 step j of B = tile (the tile's
// rows are B's rows): lanes 8 i .. 8 i + 7 address rows 16 j + 8 (i % 2)
// .. + 7 at columns 8 (n + i / 2).
template <int HD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* tile, int n,
                                             int j, int lane) {
  ldmatrix_x4_trans(b, smem_addr(tile + (16 * j + 8 * ((lane >> 3) & 1) +
                                         (lane & 7)) *
                                            (HD + 8) +
                                 8 * (n + (lane >> 4))));
}

// The A fragment of k16 step j of the next product, from the fp32 C
// fragments of n8 tiles 2 j (lo) and 2 j + 1 (hi), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// dK and dV of one 64-key tile over the query heads h0 .. h0 + n_heads_split
// - 1 of its KV head.  With partial null, dk = acc_k * scale and dv = acc_v
// are written as bf16; otherwise acc_k and acc_v go, fp32 and unscaled, to
// partial[0][split] and partial[1][split], each (B, S, K, hd).
template <int HD, int kMask>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<HD>)
attn_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ partial,
                  int sq_len, int sk_len, int q_off, int n_heads, int n_kv,
                  int splits, int window_arg, float scale,
                  float scale_log2) {
  const int window = kMask == kWindowed ? window_arg : 0;  // 0: folds away
  constexpr int kStride = HD + 8;
  constexpr int kStep = kQStep<HD>;  // queries a tile
  constexpr int kDSteps = HD / 16;       // k16 steps of S^T, dP^T
  constexpr int kQTiles = kStep / 8;     // n8 tiles of S^T, dP^T
  constexpr int kDTiles = HD / 8;        // n8 tiles of dK, dV
  constexpr bool kHold = kMmaHoldKV<HD>;
  constexpr int kQElems = kStep * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kMmaRows * kStride;
  __nv_bfloat16* s_q = s_v + kMmaRows * kStride;  // 2 stages
  __nv_bfloat16* s_do = s_q + 2 * kQElems;        // 2 stages
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * kQElems);  // 2 stages
  float* s_delta = s_lse + 2 * kStep;                           // 2 stages

  const int split = blockIdx.x % splits;
  const int bk = blockIdx.x / splits;
  const int b = bk / n_kv;
  const int kvh = bk - b * n_kv;
  const int per_split = n_heads / n_kv / splits;
  const int h0 = kvh * (n_heads / n_kv) + split * per_split;
  // Key tile 0 sees every query tile: the costliest blocks come first.
  const int k0 = blockIdx.y * kMmaRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kw0 = k0 + 16 * warp;  // this warp's first key
  const int key_lo = kw0 + g;      // the lane's two keys
  const int key_hi = key_lo + 8;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * sk_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;

  // The walk: the split's heads, and for each the local query tiles from
  // the one whose absolute positions reach key k0 (earlier tiles are all
  // masked; from tile 0 unmasked) to the end of Sq or, with a window, to
  // the tile of the block's last key's last visible query.  A block that
  // no query of the call sees copies nothing (no copy may be in flight
  // when it exits) and writes zeros.
  const int qt0 = kMask == kFull ? 0 : max(0, k0 - q_off) / kStep;
  int qt_end = (sq_len + kStep - 1) / kStep;
  if (window > 0) {
    const int last = min(k0 + kMmaRows, sk_len) + window - 2 - q_off;
    qt_end = last < 0 ? 0 : min(qt_end, last / kStep + 1);
  }
  const int per_head = max(qt_end - qt0, 0);
  const int n_it = per_split * per_head;
  auto load_q = [&](int it, int stage) {
    const int h = h0 + it / per_head;
    const int q0 = (qt0 + it % per_head) * kStep;
    const int64_t q_base = static_cast<int64_t>(b) * sq_len * q_row +
                           static_cast<int64_t>(h) * HD;
    load_tile<HD, kStep>(s_q + stage * kQElems, q + q_base, q_row, q0,
                         sq_len);
    load_tile<HD, kStep>(s_do + stage * kQElems, dout + q_base, q_row, q0,
                         sq_len);
    const int64_t row_base =
        (static_cast<int64_t>(b) * n_heads + h) * sq_len;
    for (int i = tid; i < 2 * kStep; i += kMmaThreads) {
      const int r = i < kStep ? i : i - kStep;
      const int pos = q0 + r;
      const float* src = (i < kStep ? lse : delta) + row_base +
                         min(pos, sq_len - 1);
      float* dst = (i < kStep ? s_lse : s_delta) + stage * kStep + r;
      cp_async4(smem_addr(dst), src, pos < sq_len ? 4 : 0);
    }
  };
  if (n_it > 0) {
    load_tile<HD, kMmaRows>(s_k, k + kv_base, kv_row, k0, sk_len);
    load_tile<HD, kMmaRows>(s_v, v + kv_base, kv_row, k0, sk_len);
    load_q(0, 0);
  }
  cp_async_commit();

  float acc_k[kDTiles][4];
  float acc_v[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.0f;
      acc_v[n][e] = 0.0f;
    }
  }
  uint32_t kf[kHold ? kDSteps : 1][4];
  uint32_t vf[kHold ? kDSteps : 1][4];

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHold) {
      if (it == 0) {
#pragma unroll
        for (int d = 0; d < kDSteps; ++d) {
          load_a<HD>(kf[d], s_k, 16 * warp, d, lane);
          load_a<HD>(vf[d], s_v, 16 * warp, d, lane);
        }
      }
    }
    const int q0 = (qt0 + it % per_head) * kStep;  // local
    const int qa0 = q_off + q0;                     // absolute
    // A warp whose keys all lie past this tile's queries (causal), or past
    // Sk, skips it; so does a warp whose keys all lie below the window of
    // the tile's first query.
    if ((kMask == kFull || qa0 + kStep - 1 >= kw0) && kw0 < sk_len &&
        (window == 0 || qa0 - (kw0 + 15) < window)) {
      const __nv_bfloat16* sq = s_q + (it & 1) * kQElems;
      const __nv_bfloat16* sdo = s_do + (it & 1) * kQElems;
      const float* sl = s_lse + (it & 1) * kStep;
      const float* sd = s_delta + (it & 1) * kStep;
      float st[kQTiles][4];   // S^T, then P^T
      float dpt[kQTiles][4];  // dP^T, then dS^T
#pragma unroll
      for (int n = 0; n < kQTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] = 0.0f;
          dpt[n][e] = 0.0f;
        }
      }
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
        uint32_t ka[4], va[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[d][e];
            va[e] = vf[d][e];
          }
        } else {
          load_a<HD>(ka, s_k, 16 * warp, d, lane);
          load_a<HD>(va, s_v, 16 * warp, d, lane);
        }
#pragma unroll
        for (int n = 0; n < kQTiles; n += 2) {
          uint32_t bq[4], bd[4];
          load_b<HD>(bq, sq, n, d, lane);
          mma_bf16(st[n], ka, bq[0], bq[1]);
          mma_bf16(st[n + 1], ka, bq[2], bq[3]);
          load_b<HD>(bd, sdo, n, d, lane);
          mma_bf16(dpt[n], va, bd[0], bd[1]);
          mma_bf16(dpt[n + 1], va, bd[2], bd[3]);
        }
      }
      // P^T and dS^T; the mask where the tile crosses the warp's diagonal
      // (a key after a query), the end of Sq (a query past it) or the
      // window's lower edge (a key window or more before a query).
      const bool edge = (kMask != kFull && kw0 + 15 > qa0) ||
                        q0 + kStep > sq_len ||
                        (window > 0 && qa0 + kStep - 1 - kw0 >= window);
#pragma unroll
      for (int n = 0; n < kQTiles; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t4 + c;
          const int query = q0 + col;       // local
          const int qabs = q_off + query;   // absolute
          const float lse2 = sl[col] * kLog2e;
          const float dl = sd[col];
          float p_lo = exp2_approx(fmaf(st[n][c], scale_log2, -lse2));
          float p_hi = exp2_approx(fmaf(st[n][2 + c], scale_log2, -lse2));
          if (edge) {
            if ((kMask != kFull && key_lo > qabs) || query >= sq_len ||
                (window > 0 && qabs - key_lo >= window)) {
              p_lo = 0.0f;
            }
            if ((kMask != kFull && key_hi > qabs) || query >= sq_len ||
                (window > 0 && qabs - key_hi >= window)) {
              p_hi = 0.0f;
            }
          }
          st[n][c] = p_lo;
          st[n][2 + c] = p_hi;
          dpt[n][c] = p_lo * (dpt[n][c] - dl);
          dpt[n][2 + c] = p_hi * (dpt[n][2 + c] - dl);
        }
      }
      // dV += P^T dO and dK += dS^T q over the tile's queries.
#pragma unroll
      for (int j = 0; j < kStep / 16; ++j) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * j], st[2 * j + 1]);
        c_to_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < kDTiles; n += 2) {
          uint32_t bd[4], bq[4];
          load_b_trans<HD>(bd, sdo, n, j, lane);
          mma_bf16(acc_v[n], pa, bd[0], bd[1]);
          mma_bf16(acc_v[n + 1], pa, bd[2], bd[3]);
          load_b_trans<HD>(bq, sq, n, j, lane);
          mma_bf16(acc_k[n], da, bq[0], bq[1]);
          mma_bf16(acc_k[n + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const int64_t n_elems = static_cast<int64_t>(gridDim.x / splits) / n_kv *
                          sk_len * kv_row;
  float* part_k = partial == nullptr ? nullptr : partial + split * n_elems;
  float* part_v =
      partial == nullptr ? nullptr : partial + (splits + split) * n_elems;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key_hi : key_lo;
      if (key >= sk_len) continue;
      const int64_t at = kv_base + key * kv_row + col;
      const float k0v = acc_k[n][2 * half], k1v = acc_k[n][2 * half + 1];
      const float v0v = acc_v[n][2 * half], v1v = acc_v[n][2 * half + 1];
      if (partial == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(k0v * scale, k1v * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(v0v, v1v);
      } else {
        *reinterpret_cast<float2*>(part_k + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(part_v + at) = make_float2(v0v, v1v);
      }
    }
  }
}

// dk = scale * (partial[0][0] + ... + partial[0][splits - 1]) and dv = the
// same sum of partial[1], each (B, S, K, hd) of n elements, added in split
// order (deterministic) and rounded once: 4 elements a thread.
__global__ void __launch_bounds__(256)
attn_bwd_sum_splits(const float* __restrict__ partial,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int64_t n, int splits,
                    float scale) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int kind = i >= n;  // 0: dk, 1: dv (n is a multiple of 4)
  const int64_t e = i - kind * n;
  const float* src = partial + kind * splits * n + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float f = kind ? 1.0f : scale;
  __nv_bfloat162* out =
      reinterpret_cast<__nv_bfloat162*>((kind ? dv : dk) + e);
  out[0] = __floats2bfloat162_rn(acc.x * f, acc.y * f);
  out[1] = __floats2bfloat162_rn(acc.z * f, acc.w * f);
}

// dQ of one 64-query tile of one head.
template <int HD, int kMask>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<HD>)
attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int sq_len, int sk_len,
                int q_off, int n_heads, int n_kv, int window_arg,
                float scale, float scale_log2) {
  const int window = kMask == kWindowed ? window_arg : 0;  // 0: folds away
  constexpr int kStride = HD + 8;
  constexpr int kStep = kKStep;  // keys a tile
  constexpr int kDSteps = HD / 16;       // k16 steps of S, dP
  constexpr int kKTiles = kStep / 8;     // n8 tiles of S, dP
  constexpr int kDTiles = HD / 8;        // n8 tiles of dQ
  constexpr int kKElems = kStep * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_do = s_q + kMmaRows * kStride;
  __nv_bfloat16* s_k = s_do + kMmaRows * kStride;  // 2 stages
  __nv_bfloat16* s_v = s_k + 2 * kKElems;          // 2 stages

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  // The last query tile walks the most KV tiles: issued first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int64_t q_row = static_cast<int64_t>(n_heads) * HD;
  const int64_t kv_row = static_cast<int64_t>(n_kv) * HD;
  const int64_t q_base = static_cast<int64_t>(b) * sq_len * q_row +
                         static_cast<int64_t>(h) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * sk_len * kv_row +
                          static_cast<int64_t>(kvh) * HD;
  load_tile<HD, kMmaRows>(s_q, q + q_base, q_row, q0, sq_len);
  load_tile<HD, kMmaRows>(s_do, dout + q_base, q_row, q0, sq_len);
  auto load_kv = [&](int tile, int stage) {
    load_tile<HD, kStep>(s_k + stage * kKElems, k + kv_base, kv_row,
                         tile * kStep, sk_len);
    load_tile<HD, kStep>(s_v + stage * kKElems, v + kv_base, kv_row,
                         tile * kStep, sk_len);
  };
  // KV tiles from the one holding the first query's first visible key (0
  // without a window) up to the causal frontier of the tile's last real
  // query (to the end of Sk unmasked), at absolute positions.
  const int q_last = q_off + min(q0 + kMmaRows, sq_len) - 1;
  const int t_first =
      window > 0 ? max(0, q_off + q0 - window + 1) / kStep : 0;
  const int n_it =
      (kMask == kFull ? sk_len - 1 : q_last) / kStep + 1 - t_first;
  load_kv(t_first, 0);
  cp_async_commit();

  // This warp's 16 queries: g and g + 8 of them are this lane's, with
  // their lse (log2 units) and delta.  w_ and row_ are absolute positions,
  // w_local and loc_ the rows' local indices (without the offset).
  const int w_local = q0 + 16 * warp;
  const int w_first = q_off + w_local;
  const int w_last = w_first + 15;
  const int loc_lo = w_local + g;
  const int loc_hi = loc_lo + 8;
  const int row_lo = q_off + loc_lo;
  const int row_hi = row_lo + 8;
  const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h) * sq_len;
  const float lse2_lo =
      loc_lo < sq_len ? lse[row_base + loc_lo] * kLog2e : 0.0f;
  const float lse2_hi =
      loc_hi < sq_len ? lse[row_base + loc_hi] * kLog2e : 0.0f;
  const float d_lo = loc_lo < sq_len ? delta[row_base + loc_lo] : 0.0f;
  const float d_hi = loc_hi < sq_len ? delta[row_base + loc_hi] : 0.0f;
  uint32_t qf[kDSteps][4];
  uint32_t df[kDSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int t = t_first + it;
    if (it + 1 < n_it) {
      load_kv(t + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
        load_a<HD>(qf[d], s_q, 16 * warp, d, lane);
        load_a<HD>(df[d], s_do, 16 * warp, d, lane);
      }
    }
    const int k0 = t * kStep;
    // A warp whose queries all lie before this tile (causal), or past Sq,
    // skips it; so does a warp whose first query's window starts after the
    // tile.
    if ((kMask == kFull || k0 <= w_last) && w_local < sq_len &&
        (window == 0 || w_first - (k0 + kStep - 1) < window)) {
      const __nv_bfloat16* sk = s_k + (it & 1) * kKElems;
      const __nv_bfloat16* sv = s_v + (it & 1) * kKElems;
      float s[kKTiles][4];   // S, then dS
      float dp[kKTiles][4];  // dP
#pragma unroll
      for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.0f;
          dp[n][e] = 0.0f;
        }
      }
#pragma unroll
      for (int d = 0; d < kDSteps; ++d) {
#pragma unroll
        for (int n = 0; n < kKTiles; n += 2) {
          uint32_t bk[4], bv[4];
          load_b<HD>(bk, sk, n, d, lane);
          mma_bf16(s[n], qf[d], bk[0], bk[1]);
          mma_bf16(s[n + 1], qf[d], bk[2], bk[3]);
          load_b<HD>(bv, sv, n, d, lane);
          mma_bf16(dp[n], df[d], bv[0], bv[1]);
          mma_bf16(dp[n + 1], df[d], bv[2], bv[3]);
        }
      }
      // dS = P (dP - delta); the mask where the tile crosses the warp's
      // diagonal, the end of Sk (a key past it) or the window's lower edge.
      const bool edge = (kMask != kFull && k0 + kStep - 1 > w_first) ||
                        k0 + kStep > sk_len ||
                        (window > 0 && w_last - k0 >= window);
#pragma unroll
      for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float p = exp2_approx(
              fmaf(s[n][e], scale_log2, -(lo ? lse2_lo : lse2_hi)));
          const int key = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = lo ? row_lo : row_hi;
          if (edge && ((kMask != kFull && key > row) || key >= sk_len ||
                       (window > 0 && row - key >= window))) {
            p = 0.0f;
          }
          s[n][e] = p * (dp[n][e] - (lo ? d_lo : d_hi));
        }
      }
      // dQ += dS k over the tile's keys.
#pragma unroll
      for (int j = 0; j < kStep / 16; ++j) {
        uint32_t da[4];
        c_to_a(da, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < kDTiles; n += 2) {
          uint32_t bk[4];
          load_b_trans<HD>(bk, sk, n, j, lane);
          mma_bf16(acc[n], da, bk[0], bk[1]);
          mma_bf16(acc[n + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int col = 8 * n + 2 * t4;
    if (loc_lo < sq_len) {
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + loc_lo * q_row + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    }
    if (loc_hi < sq_len) {
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + loc_hi * q_row + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
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
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int64_t batch, int s_len, int n_heads,
                         cudaStream_t stream) {
  const int64_t rows = batch * s_len * n_heads;
  const int64_t blocks = (rows * kDeltaLanes + kThreads - 1) / kThreads;
  attn_bwd_delta<T, HD><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      s_len, n_heads);
  return cudaGetLastError();
}

template <int HD, int kMask>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv,
                       int64_t batch, int sq_len, int sk_len, int q_off,
                       int n_heads, int n_kv, int window, float scale,
                       cudaStream_t stream) {
  constexpr int64_t dkdv_smem = dkdv_smem_bytes<HD>();
  constexpr int64_t dq_smem = dq_smem_bytes<HD>();
  static bool dkdv_set = false;  // per instantiation
  static bool dq_set = false;
  cudaError_t err =
      allow_smem(attn_bwd_dkdv<HD, kMask>, dkdv_smem, &dkdv_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dq<HD, kMask>, dq_smem, &dq_set);
  if (err != cudaSuccess) return err;
  err = launch_delta<float, HD>(o, dout, delta, batch, sq_len, n_heads,
                                stream);
  if (err != cudaSuccess) return err;

  const unsigned k_tiles =
      static_cast<unsigned>((sk_len + kTile - 1) / kTile);
  const unsigned q_tiles =
      static_cast<unsigned>((sq_len + kTile - 1) / kTile);
  attn_bwd_dkdv<HD, kMask>
      <<<dim3(static_cast<unsigned>(batch * n_kv), k_tiles), kThreads,
         static_cast<size_t>(dkdv_smem), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), sq_len,
      sk_len, q_off, n_heads, n_kv, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  attn_bwd_dq<HD, kMask>
      <<<dim3(static_cast<unsigned>(batch * n_heads), q_tiles), kThreads,
         static_cast<size_t>(dq_smem), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), sq_len, sk_len, q_off, n_heads, n_kv,
      window, scale);
  return cudaGetLastError();
}

template <int HD, int kMask>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv,
                       float* partial, int64_t batch, int sq_len, int sk_len,
                       int q_off, int n_heads, int n_kv, int splits,
                       int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int64_t dkdv_smem = dkdv_mma_smem_bytes<HD>();
  constexpr int64_t dq_smem = dq_mma_smem_bytes<HD>();
  static bool dkdv_set = false;  // per instantiation
  static bool dq_set = false;
  cudaError_t err =
      allow_smem(attn_bwd_dkdv_mma<HD, kMask>, dkdv_smem, &dkdv_set);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dq_mma<HD, kMask>, dq_smem, &dq_set);
  if (err != cudaSuccess) return err;
  err = launch_delta<bf16, HD>(o, dout, delta, batch, sq_len, n_heads,
                               stream);
  if (err != cudaSuccess) return err;

  const float scale_log2 = scale * kLog2e;
  const unsigned k_tiles =
      static_cast<unsigned>((sk_len + kMmaRows - 1) / kMmaRows);
  const unsigned q_tiles =
      static_cast<unsigned>((sq_len + kMmaRows - 1) / kMmaRows);
  attn_bwd_dkdv_mma<HD, kMask>
      <<<dim3(static_cast<unsigned>(batch * n_kv * splits), k_tiles),
         kMmaThreads, static_cast<size_t>(dkdv_smem), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
          splits > 1 ? partial : nullptr, sq_len, sk_len, q_off, n_heads,
          n_kv, splits, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const int64_t n = batch * sk_len * n_kv * HD;
    const int64_t blocks = (2 * n / 4 + 255) / 256;
    attn_bwd_sum_splits<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        partial, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  attn_bwd_dq_mma<HD, kMask>
      <<<dim3(static_cast<unsigned>(batch * n_heads), q_tiles), kMmaThreads,
         static_cast<size_t>(dq_smem), stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
          delta, static_cast<bf16*>(dq), sq_len, sk_len, q_off, n_heads,
          n_kv, window, scale, scale_log2);
  return cudaGetLastError();
}

// The shapes of one call: batch, query rows, keys, the queries' offset.
struct Dims {
  int64_t batch;
  int sq_len;
  int sk_len;
  int q_off;
  int n_heads;
  int n_kv;
};

template <int HD, int kMask>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         const float* lse, float* delta, void* dq, void* dk,
                         void* dv, float* partial, const Dims& d, int splits,
                         int window, float scale, cudaStream_t stream) {
  return dtype == 0
             ? launch_fma<HD, kMask>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, d.batch, d.sq_len, d.sk_len,
                                     d.q_off, d.n_heads, d.n_kv, window,
                                     scale, stream)
             : launch_mma<HD, kMask>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, partial, d.batch, d.sq_len,
                                     d.sk_len, d.q_off, d.n_heads, d.n_kv,
                                     splits, window, scale, stream);
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   float* partial, const Dims& d, int splits, int window,
                   bool causal, float scale, cudaStream_t stream) {
  if (!causal) {
    return launch_dtype<HD, kFull>(dtype, q, k, v, o, dout, lse, delta, dq,
                                   dk, dv, partial, d, splits, 0, scale,
                                   stream);
  }
  if (window > 0) {
    return launch_dtype<HD, kWindowed>(dtype, q, k, v, o, dout, lse, delta,
                                       dq, dk, dv, partial, d, splits,
                                       window, scale, stream);
  }
  return launch_dtype<HD, kCausal>(dtype, q, k, v, o, dout, lse, delta, dq,
                                   dk, dv, partial, d, splits, 0, scale,
                                   stream);
}

}  // namespace

extern "C" {

// q, o, dout, dq (batch, sq_len, n_heads, head_dim); k, v, dk, dv (batch,
// sk_len, n_kv, head_dim); contiguous, all float32 (dtype 0) or all
// bfloat16 (dtype 1; q, k, v and dout 16-byte aligned, for the 16-byte
// copies).  q_offset: the absolute position of query row 0 (the keys sit
// at 0 .. sk_len - 1); causal needs q_offset + sq_len <= sk_len.  lse
// (batch, n_heads, sq_len) float32 from the forward of the same offset;
// delta a float32 scratch of the same shape, overwritten.  n_heads % n_kv
// == 0, head_dim in {16, 32, 64, 128}, scale the forward's softmax scale.
// splits: the number of blocks over which each KV head's n_heads / n_kv
// query heads are split for dK and dV (bf16 only; it divides n_heads /
// n_kv); with splits > 1, partial is a float32 scratch of 2 * splits *
// batch * sk_len * n_kv * head_dim elements, overwritten.  window: 0 is
// causal; 1 .. sk_len the forward's sliding window (larger values are
// refused: the caller passes sk_len for them).  causal: 1, or 0 for the
// unmasked forward's gradients (window 0 only).
int repro_flash_attention_bwd_split(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    void* partial, int64_t batch,
                                    int64_t sq_len, int64_t sk_len,
                                    int64_t q_offset, int n_heads, int n_kv,
                                    int head_dim, int dtype, float scale,
                                    int splits, int window, int causal,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || sq_len < 1 || sk_len < 1 || q_offset < 0 || n_kv < 1 ||
      n_heads < n_kv || n_heads % n_kv != 0 ||
      batch * n_heads > 0x7fffffffLL || sk_len > 0x7fffffffLL ||
      q_offset + sq_len > 0x7fffffffLL ||
      (causal == 1 && q_offset + sq_len > sk_len) ||
      (sq_len + kTile - 1) / kTile > kMaxTiles ||
      (sk_len + kTile - 1) / kTile > kMaxTiles ||
      (dtype != 0 && dtype != 1) || splits < 1 ||
      (n_heads / n_kv) % splits != 0 ||
      (splits > 1 && (dtype != 1 || partial == nullptr)) || window < 0 ||
      window > sk_len || (causal != 0 && causal != 1) ||
      (causal == 0 && window != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Dims d{batch, static_cast<int>(sq_len), static_cast<int>(sk_len),
               static_cast<int>(q_offset), n_heads, n_kv};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(partial);
  const bool c = causal == 1;
  cudaError_t err;
  switch (head_dim) {
    case 16:
      err = launch<16>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, part, d,
                       splits, window, c, scale, s);
      break;
    case 32:
      err = launch<32>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, part, d,
                       splits, window, c, scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, part, d,
                       splits, window, c, scale, s);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, o, dout, l, dl, dq, dk, dv, part, d,
                        splits, window, c, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The same with the G query heads of a KV head in one block (splits 1),
// Sq = Sk = s_len at offset 0.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int64_t batch,
                              int64_t s_len, int n_heads, int n_kv,
                              int head_dim, int dtype, float scale,
                              int window, int causal, void* stream) {
  return repro_flash_attention_bwd_split(q, k, v, o, dout, lse, delta, dq,
                                         dk, dv, nullptr, batch, s_len,
                                         s_len, 0, n_heads, n_kv, head_dim,
                                         dtype, scale, 1, window, causal,
                                         stream);
}

}  // extern "C"
