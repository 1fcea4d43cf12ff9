// Backward of the mamba-1 selective scan for Hopper (sm_90a), bound to
// Python through a plain C interface.
//
// No TPU kernel is replaced: JAX differentiates src/repro/models/layers.py::
// selective_scan (:612-657), a chunked lax.associative_scan, in XLA.  The
// forward here is selective_scan.cu; this is its gradient.  With
// g_t = silu(z_t), r_t = sum_n h_t[n] C_t[n] + D x_t, y_t = r_t g_t and
// e_t = dy_t g_t, walking t from S - 1 down to 0 per channel d:
//   dz_t     = dy_t r_t silu'(z_t)
//   dD      += e_t x_t
//   dC_t[n] += h_t[n] e_t                                   (over d)
//   dh_t[n]  = e_t C_t[n] + exp(dt_{t+1} a[n]) dh_{t+1}[n]  (from dh_last)
//   ddt_t    = sum_n dh_t[n] (a[n] exp(dt_t a[n]) h_{t-1}[n] + x_t B_t[n])
//   da[n]   += dh_t[n] dt_t exp(dt_t a[n]) h_{t-1}[n]
//   dx_t     = e_t D + sum_n dh_t[n] dt_t B_t[n]
//   dB_t[n] += dh_t[n] dt_t x_t                             (over d)
// and dh0 = exp(dt_0 a) dh_0.  dx and dz are written in x's dtype, the rest
// in fp32.
//
// What bounds it.
//   * Bytes: per (b, t, d) x, z and dy are read and dx and dz written in
//     x's dtype, dt read and ddt written in fp32, and the saved states read
//     (N fp32 every 16 steps): 22 bytes at bf16, N = 16.  At
//     falcon-mamba-7b's training microbatch (B = 4, S = 4096, Di = 8192)
//     2.95 GB, 0.88 ms at 3.35 TB/s; at hymba-1.5b's (Di = 3200) 0.34 ms.
//   * The SFU: the function's N exponentials per (b, t, d) and the gate's
//     exponential and reciprocal, as the forward's; this kernel takes N
//     more to recompute the states (2 N + 2 a (b, t, d)).
// Design: correct and simple first.
//   * One thread per (b, channel), 64 channels of one batch row a block,
//     its N states, a, carry dh and da sums in registers.
//   * States in reverse order: the forward saved the state entering every
//     tile of 16 steps (its optional states output).  Walking the tiles
//     from the last, a thread recomputes its tile's 16 states from the
//     saved one with the forward's own arithmetic (ex2.approx on a scaled
//     by log2(e), the same fmaf), keeping each h_{t-1} in shared memory
//     ([step][n][thread]: a thread's column, conflict-free, no barrier),
//     then walks the tile back.  The recurrence is never inverted
//     (exp(dt a) flushes to 0 for large dt); a dt = 0 step stays an exact
//     identity (ex2(0) = 1).
//   * No float atomics, so a call gives the same bits every time (a
//     resumed training run repeats the uninterrupted one's losses bit for
//     bit): dB and dC of a step are summed over a warp's 32 channels by a
//     shuffle reduce-scatter (lane j ends with value j of the 2 N), over
//     the block's 2 warps through shared memory in warp order, and written
//     as per-block partials (ceil(Di / 64), B, S, 2 N); da and dD go out
//     per batch row, (B, Di, N) and (B, Di).  The wrapper sums the
//     partials' leading axis (torch.sum, a fixed order).
//   * Each tile's x, z, dy and dt (a thread its channel's, coalesced over
//     the block's channels, all 64 loads of a thread in flight at once)
//     and B and C (the block's) are staged in shared memory before the
//     tile's two passes, so a step waits on shared memory, not on device
//     memory.
// Budget a block: shared memory 16 steps x N x 64 threads fp32 for the
// states (64 KB at N = 16, 32 KB at N = 8), the staged tile (10 KB bf16,
// 16 KB fp32, and 2 KB of B and C) and 2 warps x 16 steps x 2 N for the
// reduction: 80 KB (88 KB fp32), 2 blocks an SM at N = 16.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 64;  // channels a block, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;    // steps between saved states (forward's tile)
constexpr float kExpScale = 1.4426950408889634f;  // log2(e)

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One round of the reduce-scatter below: lanes whose place j in the group
// has bit W set keep the upper W of their values, the others the lower W,
// each adding its partner's (lane ^ W) copy of the half it keeps.  Written
// as a template recursion so that every index into p is a constant and p
// stays in registers.
template <int W, int V>
__device__ __forceinline__ void halve(float (&p)[V], int j) {
  if constexpr (W >= 1) {
    const bool upper = (j & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = upper ? p[i] : p[i + W];
      const float keep = upper ? p[i + W] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    halve<W / 2, V>(p, j);
  }
}

// p: V values of this lane.  Returns, in lane j of the warp, the sum over
// the warp's 32 lanes of value j % V: a reduce-scatter by recursive halving
// within groups of V lanes, then a butterfly across the groups.  Every sum
// is taken in a fixed order.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float (&p)[V],
                                                     int lane) {
  halve<V / 2, V>(p, lane % V);
  float r = p[0];
#pragma unroll
  for (int w = V; w < 32; w *= 2) r += __shfl_xor_sync(0xffffffffu, r, w);
  return r;
}

// Shared memory a block: the tile's h_{t-1} ([step][n][thread] fp32), its
// x, z and dy ([step][thread] in T) and dt ([step][thread] fp32), its B and
// C ([step][n] fp32) and the warps' dB and dC ([warp][step][2 N] fp32).
template <typename T, int N>
constexpr int64_t smem_bytes() {
  return static_cast<int64_t>(kChunk * N * kThreads + kChunk * kThreads +
                              2 * kChunk * N + kWarps * kChunk * 2 * N) * 4 +
         static_cast<int64_t>(3 * kChunk * kThreads) * sizeof(T);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ z,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ dskip,
                          const float* __restrict__ states,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          T* __restrict__ dx, T* __restrict__ dz,
                          float* __restrict__ ddt,
                          float* __restrict__ da_part,
                          float* __restrict__ dbc_part,
                          float* __restrict__ dd_part,
                          float* __restrict__ dh0, int s_len, int di) {
  constexpr int V = 2 * N;  // dB and dC of a step
  static_assert(V <= 32 && (V & (V - 1)) == 0, "2 N lanes of a warp");
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                               // [kChunk][N][kThreads]
  float* s_dt = s_h + kChunk * N * kThreads;       // [kChunk][kThreads]
  float* s_b = s_dt + kChunk * kThreads;           // [kChunk][N]
  float* s_c = s_b + kChunk * N;                   // [kChunk][N]
  float* s_red = s_c + kChunk * N;                 // [kWarps][kChunk][V]
  T* s_x = reinterpret_cast<T*>(s_red + kWarps * kChunk * V);
  T* s_z = s_x + kChunk * kThreads;                // [kChunk][kThreads]
  T* s_dy = s_z + kChunk * kThreads;               // [kChunk][kThreads]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < di;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int64_t row0 = static_cast<int64_t>(b) * s_len;  // (b, t = 0)
  const float* bmb = bm + row0 * N;
  const float* cmb = cm + row0 * N;
  const int64_t own = (static_cast<int64_t>(b) * di + d) * N;

  float an[N], a2[N], carry[N], da_acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = active ? a[static_cast<int64_t>(d) * N + n] : 0.0f;
    a2[n] = an[n] * kExpScale;
    carry[n] = active && dh_last != nullptr ? dh_last[own + n] : 0.0f;
    da_acc[n] = 0.0f;
  }
  const float dsk = active ? dskip[d] : 0.0f;
  float dd_acc = 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, s_len - t0);
    // Stage the tile: each thread its channel's x, z, dy and dt (every
    // load of the tile in flight at once, zeros past S and Di), the block
    // the tile's B and C.  The barrier before it: the last tile's reads of
    // the stage and of s_red are done.
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool ok = active && u < len;
      const int64_t at = (row0 + t0 + u) * di + d;
      const int i = u * kThreads + tid;
      s_x[i] = ok ? x[at] : narrow<T>(0.0f);
      s_z[i] = ok ? z[at] : narrow<T>(0.0f);
      s_dy[i] = ok ? dy[at] : narrow<T>(0.0f);
      s_dt[i] = ok ? dt[at] : 0.0f;
    }
    for (int i = tid; i < len * N; i += kThreads) {
      s_b[i] = bmb[static_cast<int64_t>(t0) * N + i];
      s_c[i] = cmb[static_cast<int64_t>(t0) * N + i];
    }
    __syncthreads();
    // h_{t-1} of each step of the tile, from the state saved entering it,
    // with the forward's arithmetic.
    {
      float h[N];
      const float* st =
          states + ((static_cast<int64_t>(b) * n_chunks + c) * di + d) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = active ? st[n] : 0.0f;
      for (int u = 0; u < len; ++u) {
        const float dtv = s_dt[u * kThreads + tid];
        const float dtx = widen(s_x[u * kThreads + tid]) * dtv;
        const float* brow = s_b + u * N;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s_h[(u * N + n) * kThreads + tid] = h[n];
          h[n] = fmaf(exp2_approx(dtv * a2[n]), h[n], dtx * brow[n]);
        }
      }
    }
    // The tile's steps backwards.
    for (int u = len - 1; u >= 0; --u) {
      const int64_t at = (row0 + t0 + u) * di + d;
      const int i = u * kThreads + tid;
      const float xv = widen(s_x[i]);
      const float zv = widen(s_z[i]);
      const float dyv = widen(s_dy[i]);
      const float dtv = s_dt[i];
      const float* brow = s_b + u * N;
      const float* crow = s_c + u * N;
      const float dtx = xv * dtv;
      float p[V];  // dB_t[n] in p[n], dC_t[n] in p[N + n]
      float ea[N], hp[N];
      float r = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hp[n] = s_h[(u * N + n) * kThreads + tid];
        ea[n] = exp2_approx(dtv * a2[n]);
        const float ht = fmaf(ea[n], hp[n], dtx * brow[n]);
        r = fmaf(ht, crow[n], r);
        p[N + n] = ht;
      }
      r = fmaf(dsk, xv, r);
      const float sig = rcp_approx(1.0f + exp2_approx(-kExpScale * zv));
      const float e = dyv * (zv * sig);
      const float dzv = dyv * r * sig * fmaf(zv, 1.0f - sig, 1.0f);
      dd_acc = fmaf(e, xv, dd_acc);
      float dxv = e * dsk;
      float ddtv = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float dh = fmaf(e, crow[n], carry[n]);
        p[N + n] *= e;
        const float w = dh * ea[n] * hp[n];
        ddtv = fmaf(w, an[n], fmaf(dh * xv, brow[n], ddtv));
        da_acc[n] = fmaf(w, dtv, da_acc[n]);
        dxv = fmaf(dh * dtv, brow[n], dxv);
        p[n] = dh * dtx;
        carry[n] = ea[n] * dh;
      }
      if (active) {
        dx[at] = narrow<T>(dxv);
        dz[at] = narrow<T>(dzv);
        ddt[at] = ddtv;
      }
      const float red = warp_reduce_scatter<V>(p, lane);
      if (lane < V) s_red[(warp * kChunk + u) * V + lane] = red;
    }
    __syncthreads();
    // The block's dB and dC of the tile, its warps added in order.
    float* part = dbc_part + ((static_cast<int64_t>(blockIdx.x) * gridDim.y +
                               b) * s_len + t0) * V;
    for (int i = tid; i < len * V; i += kThreads) {
      const int u = i / V;
      const int j = i - u * V;
      float sum = s_red[u * V + j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += s_red[(w * kChunk + u) * V + j];
      part[i] = sum;
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[own + n] = carry[n];
      da_part[own + n] = da_acc[n];
    }
    dd_part[static_cast<int64_t>(b) * di + d] = dd_acc;
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* z, const void* dt,
                   const void* a, const void* bm, const void* cm,
                   const void* dskip, const void* states, const void* dy,
                   const void* dh_last, void* dx, void* dz, void* ddt,
                   void* da_part, void* dbc_part, void* dd_part, void* dh0,
                   int batch, int s_len, int di, cudaStream_t stream) {
  constexpr int64_t smem = smem_bytes<T, N>();
  static bool set = false;  // per instantiation
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    set = true;
  }
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  selective_scan_bwd_kernel<T, N>
      <<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(z),
          static_cast<const float*>(dt), static_cast<const float*>(a),
          static_cast<const float*>(bm), static_cast<const float*>(cm),
          static_cast<const float*>(dskip),
          static_cast<const float*>(states), static_cast<const T*>(dy),
          static_cast<const float*>(dh_last), static_cast<T*>(dx),
          static_cast<T*>(dz), static_cast<float*>(ddt),
          static_cast<float*>(da_part), static_cast<float*>(dbc_part),
          static_cast<float*>(dd_part), static_cast<float*>(dh0), s_len, di);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dtype(int dtype, const void* x, const void* z,
                         const void* dt, const void* a, const void* bm,
                         const void* cm, const void* dskip,
                         const void* states, const void* dy,
                         const void* dh_last, void* dx, void* dz, void* ddt,
                         void* da_part, void* dbc_part, void* dd_part,
                         void* dh0, int batch, int s_len, int di,
                         cudaStream_t stream) {
  return dtype == 0
             ? launch<float, N>(x, z, dt, a, bm, cm, dskip, states, dy,
                                dh_last, dx, dz, ddt, da_part, dbc_part,
                                dd_part, dh0, batch, s_len, di, stream)
             : launch<__nv_bfloat16, N>(x, z, dt, a, bm, cm, dskip, states,
                                        dy, dh_last, dx, dz, ddt, da_part,
                                        dbc_part, dd_part, dh0, batch, s_len,
                                        di, stream);
}

}  // namespace

extern "C" {

// The layout the wrapper allocates by: steps between saved states (it must
// equal the forward's, repro_selective_scan_state_chunk) and channels a
// block (the leading extent of dbc_part is ceil(d_inner / channels)).
void repro_selective_scan_bwd_layout(int* chunk, int* channels) {
  *chunk = kChunk;
  *channels = kThreads;
}

// x, z, dy, dx, dz (batch, s_len, d_inner), all float32 (dtype 0) or all
// bfloat16 (dtype 1); dt and ddt (batch, s_len, d_inner), a (d_inner,
// n_state), bm and cm (batch, s_len, n_state), d_skip (d_inner,), states
// (batch, ceil(s_len / 16), d_inner, n_state) from the forward, dh_last
// (null, or batch, d_inner, n_state) and dh0 (batch, d_inner, n_state), all
// float32; the partials, float32 and overwritten: da_part (batch, d_inner,
// n_state), dbc_part (ceil(d_inner / 64), batch, s_len, 2 n_state: dB then
// dC) and dd_part (batch, d_inner).  All contiguous.  n_state 8 or 16.
int repro_selective_scan_bwd(const void* x, const void* z, const void* dt,
                             const void* a, const void* bm, const void* cm,
                             const void* dskip, const void* states,
                             const void* dy, const void* dh_last, void* dx,
                             void* dz, void* ddt, void* da_part,
                             void* dbc_part, void* dd_part, void* dh0,
                             int64_t batch, int64_t s_len, int64_t di,
                             int n_state, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || s_len < 1 || s_len > 0x7fffffffLL ||
      di < 1 || di > 0x7fffffffLL - kThreads || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = static_cast<int>(batch);
  const int sl = static_cast<int>(s_len);
  const int nd = static_cast<int>(di);
  switch (n_state) {
    case 8:
      return static_cast<int>(launch_dtype<8>(
          dtype, x, z, dt, a, bm, cm, dskip, states, dy, dh_last, dx, dz,
          ddt, da_part, dbc_part, dd_part, dh0, nb, sl, nd, s));
    case 16:
      return static_cast<int>(launch_dtype<16>(
          dtype, x, z, dt, a, bm, cm, dskip, states, dy, dh_last, dx, dz,
          ddt, da_part, dbc_part, dd_part, dh0, nb, sl, nd, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
