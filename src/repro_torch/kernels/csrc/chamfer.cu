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
// What bounds it on this card: bytes at large B, latency at the path's B.
// A row is tiny (P = 5, W = 15, F = 25: 2 KB of inputs, 375 multiply-adds
// per pair set), so at B = 65,536 the 137 MB moved take 41 us at 3.35 TB/s
// while the arithmetic takes ~1 us.  At the training batch (B = 256) the
// whole call is 0.5 MB: what it costs is one trip to device memory and the
// chain of dependent steps that follows.  The (P, W, F) differences and the
// (P, W) distances never leave the SM; only the loss and the argmins are
// written.
//
// What held the first port back: one warp owned one row, so B = 256 ran as
// 32 blocks on a quarter of the 132 SMs, and inside the warp every step was
// serial: the row staged in 16 rounds of 4-byte loads, the 75 pairs in three
// rounds of 25-step sums of scalar shared loads, the minima on 5 (then 15)
// lanes each looping over the other side, and one lane summing the minima.
// It read 0.0123 ms against a 0.0048 ms timer floor.
//
// The design now:
//   * a row is a group of G lanes, G the power of two at or above W (at
//     least 2, at most 32): 16 lanes at W = 15, two rows a warp, so nothing
//     a row does waits for another row, and every barrier is a __syncwarp.
//     Blocks hold as many rows as still give every SM a block (one at
//     B = 256, so the batch spreads over 256 blocks; 8 at B = 65,536);
//   * each row's po and w are staged into shared memory by 16-byte cp.async
//     copies from the 16-byte boundary at or below the row (the tail
//     zero-filled, nothing past the row read), all issued before one wait;
//     po and w start on a 16-byte boundary (the wrapper copies a view that
//     does not);
//   * lane l owns the w points l, l + G, ...: for each it computes the
//     distances to the P points of po up to eight at a time (independent
//     sums that share each loaded w value; all five of the path's P in one
//     pass), each summed over F in index order with one rounding per
//     operation (__fsub_rn, __fmul_rn, __fadd_rn: no contraction into FMAs);
//   * minima and argmins compare one 64-bit key a distance: its bits plus
//     one above (a distance is +0 .. +inf, so its bits order as its value;
//     a NaN is 0, before any number, as the plain min propagates it), the
//     index below.  Keys are distinct, so any reduction order gives the same
//     minimum and the lowest index among ties.  The backward minimum of a w
//     point stays in its lane's registers over the P points; the forward
//     minimum of each p is a shuffle tree over the G lanes;
//   * two lanes sum the P and the W minima, each in index order, at once,
//     and the divisions are IEEE divisions,
// so the distances, the argmins and the loss equal the plain version's
// (kernels/ref.py, which sums in the same order) bit for bit.  Ragged
// batches need no padding: a row past the end stages nothing and writes
// nothing.
//
// Not kept: a thread for each (p, w) pair (128 threads a row, distances in
// shared memory, block barriers between the phases) was a little faster at
// B = 256 but slower than the first port at B = 65,536, its reductions
// costing more instructions than the staging cost time; splitting a row's
// P points over a whole warp at small B gained as little at B = 256 and
// cost the large batch its per-point indexing.
//
// Shared memory: a row takes pad4(P F + 3) + pad4(W F + 3) + pad4(2 P + W)
// floats (pad4 rounds up to a multiple of 4); a block stays within the
// 48 KB it gets without opting in to more, so one row may take at most
// 12,288 floats (P = 5, W = 15: F up to 612).  A larger row returns
// cudaErrorInvalidValue.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

// At most 4 warps a block.
constexpr int kMaxBlockThreads = 128;
// Points of po a lane measures against its w point in one pass.
constexpr int kPoints = 8;
// Shared memory a block gets without cudaFuncSetAttribute.
constexpr int64_t kMaxSmem = 48 * 1024;
constexpr uint64_t kNoKey = ~uint64_t{0};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The floats [0, count) of src (16-byte aligned) into dst (16-byte
// aligned) in 16-byte copies by the g lanes of a row; the last copy reads
// only what is left and zero-fills the rest.
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        int count, int lane, int g) {
  for (int i = lane; 4 * i < count; i += g) {
    const int left = count - 4 * i;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + 4 * i)),
                 "l"(src + 4 * i), "r"(left >= 4 ? 16 : 4 * left));
  }
}

__device__ __forceinline__ uint64_t make_key(float v, int i) {
  const uint32_t hi = v != v ? 0u : __float_as_uint(v) + 1u;
  return (uint64_t{hi} << 32) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ float key_value(uint64_t k) {
  const uint32_t hi = static_cast<uint32_t>(k >> 32);
  return hi == 0 ? __int_as_float(0x7fffffff) : __uint_as_float(hi - 1u);
}

__device__ __forceinline__ int key_index(uint64_t k) {
  return static_cast<int>(static_cast<uint32_t>(k));
}

__device__ __forceinline__ uint64_t min_key(uint64_t a, uint64_t b) {
  return b < a ? b : a;
}

// The least key over each aligned group of g lanes (a power of two, at most
// 32); every lane of the warp calls it.
__device__ __forceinline__ uint64_t group_min(uint64_t k, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) {
    k = min_key(k, __shfl_xor_sync(0xffffffffu, k, off));
  }
  return k;
}

__host__ __device__ __forceinline__ int64_t pad4(int64_t x) {
  return (x + 3) & ~int64_t{3};
}

// Shared-memory floats of one row: po and w, each with room for the shift
// to its 16-byte boundary, the P forward keys (64-bit) and the W backward
// minima; a multiple of 4, so every row starts on a 16-byte boundary.
__host__ __device__ __forceinline__ int64_t row_floats(int n_p, int n_w,
                                                      int n_f) {
  return pad4(int64_t{n_p} * n_f + 3) + pad4(int64_t{n_w} * n_f + 3) +
         pad4(2 * int64_t{n_p} + n_w);
}

// K distances at once, from the K points of po at a (rows of n_f floats)
// to the w point at b: sums over the first len features in index order.
// The sums start at +0, and +0 + sq is sq exactly (sq >= +0), as if they
// began with the first square.
template <int K>
__device__ __forceinline__ void dist2(const float* a, const float* b, int n_f,
                                      int len, float (&acc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int f = 0; f < len; ++f) {
    const float y = b[f];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = __fsub_rn(a[k * n_f + f], y);
      acc[k] = __fadd_rn(acc[k], __fmul_rn(d, d));
    }
  }
}

// Points p0 .. p0 + K - 1 of po against this lane's w point q: the forward
// minima of those points (over the group's lanes) into fkey, and the
// backward minimum of q into bbest.  len is n_f, or 0 for a group that owns
// no row: it reads nothing (its shared memory is not staged) but takes part
// in the shuffles.
template <int K>
__device__ __forceinline__ void points(const float* a, const float* b,
                                       int n_f, int len, int p0, int q,
                                       bool live_q, bool lead, int g,
                                       uint64_t* fkey, uint64_t& bbest) {
  float d[K];
  dist2<K>(a + p0 * n_f, b, n_f, len, d);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t fk = group_min(live_q ? make_key(d[k], q) : kNoKey, g);
    if (lead) fkey[p0 + k] = min_key(fkey[p0 + k], fk);
    bbest = min_key(bbest, make_key(d[k], p0 + k));
  }
}

int log2_ceil(int x) {
  int lg = 0;
  while ((1 << lg) < x) ++lg;
  return lg;
}

// rb rows a block, each a group of g = 2^g_log2 lanes.
__global__ void __launch_bounds__(kMaxBlockThreads)
chamfer_kernel(const float* __restrict__ po, const float* __restrict__ w,
               float* __restrict__ loss, int32_t* __restrict__ arg_fwd,
               int32_t* __restrict__ arg_bwd, int64_t n, int n_p, int n_w,
               int n_f, float alpha, float beta, int rb, int g_log2) {
  extern __shared__ float4 smem4[];
  const int g = 1 << g_log2;
  const int lane = threadIdx.x & (g - 1);
  const int r = threadIdx.x >> g_log2;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rb + r;
  // Groups past the block's rows or the batch's end run the shuffles with
  // the rest of their warp, and stage, read and write nothing.
  const bool mine = r < rb && row < n;
  const int pf = n_p * n_f;
  const int wf = n_w * n_f;
  float* sa = reinterpret_cast<float*>(smem4) +
              (mine ? r : 0) * row_floats(n_p, n_w, n_f);
  float* sb = sa + pad4(pf + 3);
  uint64_t* fkey = reinterpret_cast<uint64_t*>(sb + pad4(wf + 3));
  float* bmin = reinterpret_cast<float*>(fkey + n_p);
  const float* ga = po + (mine ? row : 0) * pf;
  const float* gb = w + (mine ? row : 0) * wf;
  // Floats from the 16-byte boundary at or below each row to the row.
  const int sha = (reinterpret_cast<uintptr_t>(ga) >> 2) & 3;
  const int shb = (reinterpret_cast<uintptr_t>(gb) >> 2) & 3;
  if (mine) {
    stage16(sa, ga - sha, sha + pf, lane, g);
    stage16(sb, gb - shb, shb + wf, lane, g);
    for (int p = lane; p < n_p; p += g) fkey[p] = kNoKey;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const float* a = sa + sha;
  const float* b = sb + shb;
  const bool lead = mine && lane == 0;
  const int len = mine ? n_f : 0;
  for (int q0 = 0; q0 < n_w; q0 += g) {
    const int q = q0 + lane;
    const bool live_q = mine && q < n_w;
    const float* bq = b + (q < n_w ? q : 0) * n_f;
    uint64_t bbest = kNoKey;
    int p0 = 0;
    for (; p0 + kPoints <= n_p; p0 += kPoints) {
      points<kPoints>(a, bq, n_f, len, p0, q, live_q, lead, g, fkey, bbest);
    }
    // The last 1 .. kPoints - 1 points in one pass.
    switch (n_p - p0) {
#define REPRO_POINTS(K)                                               \
  case K:                                                             \
    points<K>(a, bq, n_f, len, p0, q, live_q, lead, g, fkey, bbest);  \
    break;
      REPRO_POINTS(1) REPRO_POINTS(2) REPRO_POINTS(3) REPRO_POINTS(4)
      REPRO_POINTS(5) REPRO_POINTS(6) REPRO_POINTS(7)
#undef REPRO_POINTS
      default:
        break;
    }
    if (live_q) {
      bmin[q] = key_value(bbest);
      arg_bwd[row * n_w + q] = key_index(bbest);
    }
  }
  __syncwarp();

  if (mine) {
    for (int p = lane; p < n_p; p += g) {
      arg_fwd[row * n_p + p] = key_index(fkey[p]);
    }
  }
  // Lane 0 sums the P forward minima and lane 1 the W backward minima,
  // each in index order.
  float s = 0.0f;
  if (mine && lane == 0) {
    s = key_value(fkey[0]);
    for (int p = 1; p < n_p; ++p) s = __fadd_rn(s, key_value(fkey[p]));
  } else if (mine && lane == 1) {
    s = bmin[0];
#pragma unroll 4
    for (int q = 1; q < n_w; ++q) s = __fadd_rn(s, bmin[q]);
  }
  const float bs = __shfl_sync(0xffffffffu, s, 1, g);
  if (lead) {
    const float fwd = __fdiv_rn(s, static_cast<float>(n_p));
    const float bwd = __fdiv_rn(bs, static_cast<float>(n_w));
    loss[row] = __fadd_rn(__fmul_rn(alpha, fwd), __fmul_rn(beta, bwd));
  }
}

}  // namespace

extern "C" {

// po (n, n_p, n_f) and w (n, n_w, n_f) float32, contiguous, each starting
// on a 16-byte boundary; loss (n,) float32; arg_fwd (n, n_p) and arg_bwd
// (n, n_w) int32.  alpha and beta weigh the two directions (beta = 1 -
// alpha, rounded on the host as the plain version rounds it).  n >= 1, n_p >= 1, n_w >= 1, n_f >= 1, and a
// row's pad4(n_p n_f + 3) + pad4(n_w n_f + 3) + pad4(2 n_p + n_w) floats
// (pad4 rounds up to a multiple of 4) at most 12,288 (48 KB); otherwise it
// returns cudaErrorInvalidValue and launches nothing.
int repro_chamfer(const float* po, const float* w, float* loss,
                  int32_t* arg_fwd, int32_t* arg_bwd, int64_t n, int n_p,
                  int n_w, int n_f, float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = row_floats(n_p, n_w, n_f) * 4;
  if (n < 1 || n_p < 1 || n_w < 1 || n_f < 1 || row_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Lanes a row: the w points a lane takes at once, at least 2 (lane 1
  // sums the backward minima).
  const int g_log2 = log2_ceil(n_w < 2 ? 2 : (n_w > 32 ? 32 : n_w));
  // The most rows a block can hold that still gives every SM a block.
  int rb = kMaxBlockThreads >> g_log2;
  while (rb > 1 && (rb * row_bytes > kMaxSmem || (n + rb - 1) / rb <
                                                     sm_count())) {
    rb >>= 1;
  }
  const int threads = ((rb << g_log2) + 31) / 32 * 32;
  chamfer_kernel<<<static_cast<unsigned>((n + rb - 1) / rb), threads,
                   static_cast<size_t>(rb * row_bytes), s>>>(
      po, w, loss, arg_fwd, arg_bwd, n, n_p, n_w, n_f, alpha, beta, rb,
      g_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
