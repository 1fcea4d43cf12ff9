// Mamba-1 selective scan for Hopper (sm_90a), bound to Python through a
// plain C interface.
//
// No TPU kernel is replaced: JAX computes src/repro/models/layers.py::
// selective_scan (:612-657) in XLA.  It builds dA = exp(dt A) and
// dBx = dt x B as (B, S, Di, N) fp32 arrays and runs lax.associative_scan
// over chunks of ssm_chunk steps.  This kernel computes the same function
// from the block's inputs in one pass, the (S, Di, N) state never leaving
// the chip:
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t          (per channel d, state n)
//   y_t = (sum_n h_t[n] C_t[n] + D x_t) silu(z_t)
// with h_{-1} = h0 (zeros when absent), y in x's dtype and the last state
// h_{S-1} written in fp32.  JAX pads S to whole chunks with identity steps
// (dt = 0); a sequential scan needs no padding and stops at S.
//
// What bounds it.
//   * Bytes: per (b, t, d) x and z are read and y written in x's dtype and
//     dt read in fp32, 10 bytes at bf16 (16 at fp32): at falcon-mamba-7b's
//     prefill layer (B = 8, S = 2048, Di = 8192, N = 16) 1.34 GB, 0.40 ms
//     at 3.35 TB/s; at hymba-1.5b's (Di = 3200) 0.16 ms.
//   * The SFU: N exponentials per (b, t, d) and the gate's exponential and
//     reciprocal, 18 at N = 16, at 16 a clock on each SM (an eighth of the
//     FMA rate): 134 M (b, t, d) x 18 / (16 x 132 SMs) = 1.14 M clocks at
//     falcon's layer, 0.58 ms at 1,980 MHz; 0.23 ms at hymba's.  Above the
//     byte bound.
//   * Issue: per state and step dt A, the exponential, two products and a
//     sum (4 FMA-pipe instructions beside the SFU's one), ~90 instructions
//     per (b, t, d) at the least, ~0.7 clocks at 128 a clock on an SM;
//     each instruction of data movement, address arithmetic or reduction
//     is added to that.  On the card the kernel runs near the SFU's and
//     the issue's times added, not the larger of the two (PERF.md).
// The chain over t cannot be split without doing the SFU's work twice
// (each chunk's carry-in needs exp(A sum dt) per step and state), so the
// scan stays sequential over S within a channel.  The design:
//   * Exponentials on the SFU: each channel's row of A is scaled by
//     log2(e) once, in registers, and dA = 2^(dt A log2 e) is one
//     ex2.approx.ftz (an accurate expf is one ex2 and ~7 FMA-pipe
//     instructions of range reduction).  ex2(+-0) = 1, so dt = 0 stays an
//     exact identity step.  silu(z) = z rcp(1 + 2^(-z log2 e)): one ex2
//     and one rcp.approx.  Relative errors ~2^-22, well inside the 1e-5
//     the kernel is held to; a dA below 2^-126 flushes to 0 (the state is
//     then the new input alone).
//   * A channel's N states split across a group of L = N / 4 lanes, 4
//     states a lane, and each lane takes K = 2 adjacent channels: one
//     load of a step's 4 B and 4 C serves both channels, dt and x of both
//     come in one load each, and the two channels' chains are independent
//     work between the SFU's results.  Against one thread per channel this
//     doubles the warps: 12 an SM at hymba's layer (6 before), 24 at
//     falcon's.  The group's sum over n is a reduce-scatter over L steps at
//     once: after log2(L) shuffle rounds lane j holds the whole sums of
//     step j of the chunk for its channels, and computes their gates and
//     y, so the gate runs once per (b, t, d), not L times.
//   * A block is 64 threads: 64 / L x K channels of one batch row (32 at
//     N = 16, 64 at N = 8).  Small blocks balance the grid over 132 SMs:
//     falcon 2,048 blocks (15.5 an SM, at most 16), hymba 800 (6.06, at
//     most 7).
//   * Movement: tiles of 16 steps of x, z, dt (steps x the block's
//     channels), Bm and Cm are staged in shared memory by 16-byte cp.async,
//     double-buffered, so the next tile's copies run under this tile's
//     steps; y goes through a shared tile written out as 16-byte stores.
//     Reads of Bm, Cm, dt and x are broadcasts within a group.  When Di x
//     the element size is not a multiple of 16 bytes, or a pointer is off a
//     16-byte boundary, x, z, dt and y move an element at a time (Bm and Cm
//     always 16 bytes: the wrapper aligns them).
//   * Steps past S and channels past Di read zeros: dt = 0 keeps the state
//     exactly, so the steps need no bounds test; they are never written.
// Budget a block: shared memory, two stages of Bm and Cm (16 x N x 4 bytes
// each) and of dt (16 x C x 4) and x and z (16 x C x elt each), one of y
// (16 x C x elt), C channels a block: 13 KB at N = 16 bf16, 18 KB fp32
// (20 / 30 KB at N = 8); the carveout is set to the most shared memory.
// Registers: at most 80 a thread (12 blocks, 24 warps an SM): a lane holds
// 8 states, 8 scaled A, 8 partial sums and 2 D.
//
// Training: given a states pointer, the kernel also writes the state
// entering every tile of 16 steps, states (B, ceil(S / 16), Di, N) fp32
// (h0, or zeros, for the first), one float4 store a lane and channel per
// tile.  The backward (selective_scan_bwd.cu) recomputes each tile's steps
// from it.  That path is a template instantiation of its own, so the serve
// path (a null states pointer) runs the same instructions as without it
// and gives the same bits.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 64;  // threads a block
constexpr int kTile = 16;     // time steps a shared stage
// Blocks an SM must hold: caps registers at 80 a thread.
constexpr int kMinBlocks = 12;
constexpr int kK = 2;  // adjacent channels a lane

// Lanes that share a channel's N states.
template <int N>
__host__ __device__ constexpr int lanes() {
  return N / 4;
}
// Channels a block.
template <int N>
__host__ __device__ constexpr int channels() {
  return kThreads / lanes<N>() * kK;
}

constexpr float kExpScale = 1.4426950408889634f;  // log2(e)
// exp(v / log2 e) for a v already scaled by log2(e).
__device__ __forceinline__ float exp_scaled(float v) {
  return exp2_approx(v);
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float silu(float z) {
  return z * rcp_approx(1.0f + exp2_approx(-kExpScale * z));
}

// A channel pair's values from shared memory as fp32, in one load.
__device__ __forceinline__ void load_k(const float* p, float (&o)[kK]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void load_k(const __nv_bfloat16* p,
                                       float (&o)[kK]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = v.x;
  o[1] = v.y;
}
// A channel pair's values to shared memory in T, in one store.
__device__ __forceinline__ void store_k(float* p, const float (&v)[kK]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_k(__nv_bfloat16* p,
                                        const float (&v)[kK]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// p[u K + k]: this lane's partial sums of step u, channel k, for L steps.
// Leaves in p[0 .. K-1] the sums over the L lanes of the group of step j,
// j this lane's place in the group: a reduce-scatter by recursive halving,
// (L - 1) K shuffles for L K sums.
template <int L, int K>
__device__ __forceinline__ void reduce_scatter(float (&p)[L * K], int j) {
#pragma unroll
  for (int w = L / 2; w >= 1; w /= 2) {
    const bool upper = (j & w) != 0;
#pragma unroll
    for (int i = 0; i < w * K; ++i) {
      const float send = upper ? p[i] : p[i + w * K];
      const float keep = upper ? p[i + w * K] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
}

template <typename T, int N, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ z,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ dskip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last,
                      float* __restrict__ states, int s_len, int di,
                      bool vec) {
  constexpr int L = lanes<N>();
  constexpr int K = kK;
  constexpr int C = channels<N>();
  constexpr int kSpl = N / L;            // states a lane
  constexpr int kPerX = 16 / sizeof(T);  // elements of x a copy
  constexpr int kRowX = C / kPerX;       // copies of a row of x
  constexpr int kRowDt = C / 4;          // copies of a row of dt
  constexpr int kRowBc = N / 4;          // copies of a row of Bm
  static_assert(kSpl % 4 == 0 && kTile % L == 0 && C % kPerX == 0,
                "a lane takes whole float4s of Bm, Cm; chunks fill tiles");
  __shared__ __align__(16) float s_b[2][kTile * N];
  __shared__ __align__(16) float s_c[2][kTile * N];
  __shared__ __align__(16) float s_dt[2][kTile * C];
  __shared__ __align__(16) T s_x[2][kTile * C];
  __shared__ __align__(16) T s_z[2][kTile * C];
  __shared__ __align__(16) T s_y[kTile * C];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int c = tid / L * K;  // this lane's first channel in the block
  const int j = tid % L;      // place in the lane group
  // The block's (b, t = 0, d0) in x, z, dt and y; (b, t, d0 + i) is
  // t di + i further.
  const int64_t base = static_cast<int64_t>(b) * s_len * di + d0;
  const float* bmb = bm + static_cast<int64_t>(b) * s_len * N;
  const float* cmb = cm + static_cast<int64_t>(b) * s_len * N;

  // Stage `st` <- tile `tile`; steps past S and channels past Di are zeros
  // (the source address of a zero-filled copy stays in bounds).
  auto load_stage = [&](int tile, int st) {
    const int t0 = tile * kTile;
    const int64_t at0 = base + static_cast<int64_t>(t0) * di;
#pragma unroll
    for (int i = tid; i < kTile * kRowBc; i += kThreads) {
      const int r = i / kRowBc;
      const int q = 4 * (i % kRowBc);
      const bool ok = t0 + r < s_len;
      const int64_t at = ok ? static_cast<int64_t>(t0 + r) * N + q : 0;
      cp_async16(smem_addr(&s_b[st][r * N + q]), bmb + at, ok ? 16 : 0);
      cp_async16(smem_addr(&s_c[st][r * N + q]), cmb + at, ok ? 16 : 0);
    }
    if (vec) {
#pragma unroll
      for (int i = tid; i < kTile * kRowX; i += kThreads) {
        const int r = i / kRowX;
        const int q = kPerX * (i % kRowX);
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = ok ? at0 + static_cast<int64_t>(r) * di + q
                              : base;
        cp_async16(smem_addr(&s_x[st][r * C + q]), x + at, ok ? 16 : 0);
        cp_async16(smem_addr(&s_z[st][r * C + q]), z + at, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = tid; i < kTile * kRowDt; i += kThreads) {
        const int r = i / kRowDt;
        const int q = 4 * (i % kRowDt);
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = ok ? at0 + static_cast<int64_t>(r) * di + q
                              : base;
        cp_async16(smem_addr(&s_dt[st][r * C + q]), dt + at, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTile * C; i += kThreads) {
        const int r = i / C;
        const int q = i % C;
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = at0 + static_cast<int64_t>(r) * di + q;
        s_x[st][i] = ok ? x[at] : zero<T>();
        s_z[st][i] = ok ? z[at] : zero<T>();
        s_dt[st][i] = ok ? dt[at] : 0.0f;
      }
    }
  };
  // y of tile `tile` <- s_y, its rows up to S and channels up to Di.
  auto store_y = [&](int tile) {
    const int t0 = tile * kTile;
    const int64_t at0 = base + static_cast<int64_t>(t0) * di;
    if (vec) {
#pragma unroll
      for (int i = tid; i < kTile * kRowX; i += kThreads) {
        const int r = i / kRowX;
        const int q = kPerX * (i % kRowX);
        if (t0 + r < s_len && d0 + q < di) {
          *reinterpret_cast<uint4*>(y + at0 + static_cast<int64_t>(r) * di +
                                    q) =
              *reinterpret_cast<const uint4*>(&s_y[r * C + q]);
        }
      }
    } else {
      for (int i = tid; i < kTile * C; i += kThreads) {
        const int r = i / C;
        const int q = i % C;
        if (t0 + r < s_len && d0 + q < di) {
          y[at0 + static_cast<int64_t>(r) * di + q] = s_y[i];
        }
      }
    }
  };

  load_stage(0, 0);
  cp_async_commit();

  // This lane's channels d0 + c + k and states n = j kSpl .. + kSpl - 1.
  float a2[K][kSpl];
  float h[K][kSpl];
  float dsk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + c + k;
    const bool active = d < di;
    const int64_t own = static_cast<int64_t>(d) * N + j * kSpl;
    const int64_t state = (static_cast<int64_t>(b) * di + d) * N + j * kSpl;
    dsk[k] = active ? dskip[d] : 0.0f;
#pragma unroll
    for (int v = 0; v < kSpl; ++v) {
      a2[k][v] = active ? a[own + v] * kExpScale : 0.0f;
      h[k][v] = active && h0 != nullptr ? h0[state + v] : 0.0f;
    }
  }

  const int n_tiles = (s_len + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if constexpr (kSave) {
      // The state entering this tile, for the backward.
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + c + k;
        if (d < di) {
          float* dst = states + ((static_cast<int64_t>(b) * n_tiles + tile) *
                                     di + d) * N + j * kSpl;
#pragma unroll
          for (int v = 0; v < kSpl; v += 4) {
            *reinterpret_cast<float4*>(dst + v) =
                make_float4(h[k][v], h[k][v + 1], h[k][v + 2], h[k][v + 3]);
          }
        }
      }
    }
    if (tile + 1 < n_tiles) {
      load_stage(tile + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = s_b[st];
    const float* sc = s_c[st];
    const float* sdt = s_dt[st];
    const T* sx = s_x[st];
    const T* sz = s_z[st];
#pragma unroll
    for (int r0 = 0; r0 < kTile; r0 += L) {
      float part[L * K];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int r = r0 + u;
        float dtv[K], dtx[K], acc[K];
        load_k(sdt + r * C + c, dtv);
        load_k(sx + r * C + c, dtx);  // x, then dt x below
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dtx[k] *= dtv[k];
          acc[k] = 0.0f;
        }
#pragma unroll
        for (int v = 0; v < kSpl; v += 4) {
          const float4 bv =
              *reinterpret_cast<const float4*>(sb + r * N + j * kSpl + v);
          const float4 cv =
              *reinterpret_cast<const float4*>(sc + r * N + j * kSpl + v);
          const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
          const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float da = exp_scaled(dtv[k] * a2[k][v + e]);
              h[k][v + e] = fmaf(da, h[k][v + e], dtx[k] * bn[e]);
              acc[k] = fmaf(h[k][v + e], cn[e], acc[k]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) part[u * K + k] = acc[k];
      }
      // Lane j finishes step r0 + j: the group's sums, D x and the gate.
      reduce_scatter<L, K>(part, j);
      const int o = (r0 + j) * C + c;
      float xg[K], zg[K], out[K];
      load_k(sx + o, xg);
      load_k(sz + o, zg);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        out[k] = fmaf(dsk[k], xg[k], part[k]) * silu(zg[k]);
      }
      store_k(s_y + o, out);
    }
    __syncthreads();  // this stage is refilled next; s_y is complete
    store_y(tile);
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + c + k;
    if (d < di) {
      const int64_t state =
          (static_cast<int64_t>(b) * di + d) * N + j * kSpl;
#pragma unroll
      for (int v = 0; v < kSpl; ++v) h_last[state + v] = h[k][v];
    }
  }
}

template <typename T, int N, bool kSave>
void set_carveout() {
  // The most shared memory for the L1/shared split, so that the blocks the
  // registers allow also fit the SM's shared memory.
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(selective_scan_kernel<T, N, kSave>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    done = true;
  }
}

template <typename T, int N, bool kSave>
cudaError_t launch_save(const void* x, const void* z, const void* dt,
                        const void* a, const void* bm, const void* cm,
                        const void* dskip, const void* h0, void* y,
                        void* h_last, void* states, int batch, int s_len,
                        int di, cudaStream_t stream) {
  constexpr int C = channels<N>();
  const bool vec =
      (static_cast<int64_t>(di) * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(z) |
        reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  set_carveout<T, N, kSave>();
  const dim3 grid(static_cast<unsigned>((di + C - 1) / C),
                  static_cast<unsigned>(batch));
  selective_scan_kernel<T, N, kSave><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(dskip), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last),
      static_cast<float*>(states), s_len, di, vec);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* z, const void* dt,
                   const void* a, const void* bm, const void* cm,
                   const void* dskip, const void* h0, void* y, void* h_last,
                   void* states, int batch, int s_len, int di,
                   cudaStream_t stream) {
  return states == nullptr
             ? launch_save<T, N, false>(x, z, dt, a, bm, cm, dskip, h0, y,
                                        h_last, states, batch, s_len, di,
                                        stream)
             : launch_save<T, N, true>(x, z, dt, a, bm, cm, dskip, h0, y,
                                       h_last, states, batch, s_len, di,
                                       stream);
}

template <int N>
cudaError_t launch_dtype(int dtype, const void* x, const void* z,
                         const void* dt, const void* a, const void* bm,
                         const void* cm, const void* dskip, const void* h0,
                         void* y, void* h_last, void* states, int batch,
                         int s_len, int di, cudaStream_t stream) {
  return dtype == 0
             ? launch<float, N>(x, z, dt, a, bm, cm, dskip, h0, y, h_last,
                                states, batch, s_len, di, stream)
             : launch<__nv_bfloat16, N>(x, z, dt, a, bm, cm, dskip, h0, y,
                                        h_last, states, batch, s_len, di,
                                        stream);
}

template <typename T, int N>
int geometry(int* threads, int* chans, int* blocks_per_sm) {
  set_carveout<T, N, false>();
  *threads = kThreads;
  *chans = channels<N>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, selective_scan_kernel<T, N, false>, kThreads, 0));
}

}  // namespace

extern "C" {

// x, z, y (batch, s_len, d_inner), all float32 (dtype 0) or all bfloat16
// (dtype 1); dt (batch, s_len, d_inner), a (d_inner, n_state), bm and cm
// (batch, s_len, n_state; 16-byte aligned, for the 16-byte copies),
// d_skip (d_inner,), h0 (null, or batch, d_inner, n_state) and h_last
// (batch, d_inner, n_state), all float32; states null (serving), or
// (batch, ceil(s_len / 16), d_inner, n_state) float32, 16-byte aligned,
// written with the state entering each tile of 16 steps (training); all
// contiguous.  n_state 8 (the reduced configs) or 16 (falcon-mamba-7b's
// and hymba-1.5b's).
int repro_selective_scan(const void* x, const void* z, const void* dt,
                         const void* a, const void* bm, const void* cm,
                         const void* dskip, const void* h0, void* y,
                         void* h_last, void* states, int64_t batch,
                         int64_t s_len, int64_t di, int n_state, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || s_len < 1 || s_len > 0x7fffffffLL ||
      di < 1 || di > 0x7fffffffLL - kThreads || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm) |
       reinterpret_cast<uintptr_t>(states)) &
      15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int nb = static_cast<int>(batch);
  const int sl = static_cast<int>(s_len);
  const int nd = static_cast<int>(di);
  switch (n_state) {
    case 8:
      return static_cast<int>(launch_dtype<8>(dtype, x, z, dt, a, bm, cm,
                                              dskip, h0, y, h_last, states,
                                              nb, sl, nd, s));
    case 16:
      return static_cast<int>(launch_dtype<16>(dtype, x, z, dt, a, bm, cm,
                                               dskip, h0, y, h_last, states,
                                               nb, sl, nd, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Steps between the states that the saving forward writes: the backward's
// library exports its own, and the wrapper refuses a pair that differs.
int repro_selective_scan_state_chunk(void) { return kTile; }

// The launch geometry of n_state and dtype: threads a block, channels a
// block (the grid is ceil(d_inner / channels) x batch blocks) and the
// blocks an SM holds at once (the runtime's occupancy, from the kernel's
// registers and shared memory).
int repro_selective_scan_geometry(int n_state, int dtype, int* threads,
                                  int* chans, int* blocks_per_sm) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_state) {
    case 8:
      return dtype == 0 ? geometry<float, 8>(threads, chans, blocks_per_sm)
                        : geometry<__nv_bfloat16, 8>(threads, chans,
                                                     blocks_per_sm);
    case 16:
      return dtype == 0 ? geometry<float, 16>(threads, chans, blocks_per_sm)
                        : geometry<__nv_bfloat16, 16>(threads, chans,
                                                      blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
