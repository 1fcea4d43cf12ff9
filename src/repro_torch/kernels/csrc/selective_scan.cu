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
// What bounds it: bytes.  Per (b, t, d) it reads x and z (2 bytes each at
// bf16) and dt (4) and writes y (2): at falcon-mamba-7b's prefill layer
// (B = 8, S = 2048, Di = 8192, N = 16) 1.34 GB, 0.40 ms at 3.35 TB/s; its
// ~136 fp32 operations per (b, t, d) (an exp counted as one) take 0.27 ms
// at 67 TFLOP/s.  The first design is the simple one:
//   * one thread per (batch, channel): its N states, its row of A and its
//     D stay in registers for the whole sequence, so the recurrence runs
//     in fp32 registers in the order t = 0 .. S-1, as the plain version's;
//   * a block is 128 channels of one batch row, so B_t and C_t are the
//     same for all its threads: tiles of 64 time steps of Bm and Cm are
//     staged in shared memory by 16-byte cp.async copies, double-buffered,
//     so the next tile's copy runs under this tile's steps, and every read
//     of them is a broadcast;
//   * x, z and dt of 8 steps are read into registers one chunk ahead of
//     the steps that use them (neighbouring threads read neighbouring
//     channels: coalesced), so their latency is off the recurrence;
//   * exp is the accurate expf (not __expf), silu is z / (1 + exp(-z)):
//     the plain version's functions, so the two agree to a few ulps.
// A dt of 0 is an exact identity step (exp(0) = 1, 0 * x = 0).  The grid
// is (Di / 128, B): B x Di threads, 65,536 at falcon's layer (~16 warps an
// SM) and 25,600 at hymba-1.5b's (~6 warps an SM), so at hymba the card
// is thinly occupied; this design does nothing about it.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;  // channels a block, one a thread
constexpr int kTile = 64;      // time steps of Bm and Cm a shared stage
constexpr int kChunk = 8;      // time steps of x, z and dt in registers
static_assert(kTile % kChunk == 0, "chunks do not straddle tiles");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ z,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ dskip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, int s_len, int di) {
  constexpr int kRowChunks = N / 4;  // 16-byte chunks of one step's B (or C)
  constexpr int kTileChunks = kTile * kRowChunks;
  __shared__ __align__(16) float s_b[2][kTile * N];
  __shared__ __align__(16) float s_c[2][kTile * N];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < di;
  const int64_t bc_base = static_cast<int64_t>(b) * s_len * N;
  // x, z, dt and y of (b, t, d) sit at base + t * di.
  const int64_t base = static_cast<int64_t>(b) * s_len * di + (active ? d : 0);

  // Steps past S are zero-filled (their source address stays in bounds).
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kTile;
    for (int i = threadIdx.x; i < kTileChunks; i += kThreads) {
      const int r = i / kRowChunks;
      const int c = i - r * kRowChunks;
      const int t = t0 + r;
      const int64_t at =
          bc_base + static_cast<int64_t>(min(t, s_len - 1)) * N + 4 * c;
      const int n = t < s_len ? 16 : 0;
      cp_async16(smem_addr(&s_b[stage][r * N + 4 * c]), bm + at, n);
      cp_async16(smem_addr(&s_c[stage][r * N + 4 * c]), cm + at, n);
    }
  };
  // x, z and dt of steps t0 .. t0 + kChunk - 1; zeros past S and for a
  // thread without a channel.
  auto load_chunk = [&](int t0, float (&xo)[kChunk], float (&zo)[kChunk],
                        float (&dto)[kChunk]) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      const bool ok = active && t < s_len;
      const int64_t at = base + static_cast<int64_t>(ok ? t : 0) * di;
      xo[u] = ok ? to_f32(x[at]) : 0.0f;
      zo[u] = ok ? to_f32(z[at]) : 0.0f;
      dto[u] = ok ? dt[at] : 0.0f;
    }
  };

  load_tile(0, 0);
  cp_async_commit();

  float av[N];
  float h[N];
  float dsk = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = 0.0f;
    h[n] = 0.0f;
  }
  if (active) {
    const int64_t row = static_cast<int64_t>(d) * N;
    const int64_t state = (static_cast<int64_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      av[n] = a[row + n];
      if (h0 != nullptr) h[n] = h0[state + n];
    }
    dsk = dskip[d];
  }

  float xr[kChunk], zr[kChunk], dtr[kChunk];
  load_chunk(0, xr, zr, dtr);

  const int n_tiles = (s_len + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, (tile + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = s_b[tile & 1];
    const float* sc = s_c[tile & 1];
    const int t_tile = tile * kTile;
    const int steps = min(kTile, s_len - t_tile);
    for (int c0 = 0; c0 < steps; c0 += kChunk) {
      // The next chunk's loads are issued before this chunk's steps.
      float xn[kChunk], zn[kChunk], dtn[kChunk];
      load_chunk(t_tile + c0 + kChunk, xn, zn, dtn);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = c0 + u;
        if (j < steps) {
          const float dtv = dtr[u];
          const float xv = xr[u];
          const float dtx = dtv * xv;
          const float* bt = sb + j * N;
          const float* ct = sc + j * N;
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float da = expf(dtv * av[n]);
            h[n] = fmaf(da, h[n], dtx * bt[n]);
            acc = fmaf(h[n], ct[n], acc);
          }
          const float zv = zr[u];
          const float out = fmaf(dsk, xv, acc) * (zv / (1.0f + expf(-zv)));
          if (active) {
            y[base + static_cast<int64_t>(t_tile + j) * di] =
                from_f32<T>(out);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        xr[u] = xn[u];
        zr[u] = zn[u];
        dtr[u] = dtn[u];
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  if (active) {
    const int64_t state = (static_cast<int64_t>(b) * di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

template <int N, typename T>
cudaError_t launch(const void* x, const void* z, const void* dt,
                   const void* a, const void* bm, const void* cm,
                   const void* dskip, const void* h0, void* y, void* h_last,
                   int batch, int s_len, int di, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  selective_scan_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(dskip), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), s_len, di);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dtype(int dtype, const void* x, const void* z,
                         const void* dt, const void* a, const void* bm,
                         const void* cm, const void* dskip, const void* h0,
                         void* y, void* h_last, int batch, int s_len, int di,
                         cudaStream_t stream) {
  return dtype == 0
             ? launch<N, float>(x, z, dt, a, bm, cm, dskip, h0, y, h_last,
                                batch, s_len, di, stream)
             : launch<N, __nv_bfloat16>(x, z, dt, a, bm, cm, dskip, h0, y,
                                        h_last, batch, s_len, di, stream);
}

}  // namespace

extern "C" {

// x, z, y (batch, s_len, d_inner), all float32 (dtype 0) or all bfloat16
// (dtype 1); dt (batch, s_len, d_inner), a (d_inner, n_state), bm and cm
// (batch, s_len, n_state; 16-byte aligned, for the 16-byte copies),
// d_skip (d_inner,), h0 (null, or batch, d_inner, n_state) and h_last
// (batch, d_inner, n_state), all float32; all contiguous.  n_state 8 (the
// reduced configs) or 16 (falcon-mamba-7b's and hymba-1.5b's).
int repro_selective_scan(const void* x, const void* z, const void* dt,
                         const void* a, const void* bm, const void* cm,
                         const void* dskip, const void* h0, void* y,
                         void* h_last, int64_t batch, int64_t s_len,
                         int64_t di, int n_state, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || s_len < 1 || s_len > 0x7fffffffLL ||
      di < 1 || di > 0x7fffffffLL - kThreads || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm)) &
      15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int nb = static_cast<int>(batch);
  const int sl = static_cast<int>(s_len);
  const int nd = static_cast<int>(di);
  switch (n_state) {
    case 8:
      return static_cast<int>(launch_dtype<8>(dtype, x, z, dt, a, bm, cm,
                                              dskip, h0, y, h_last, nb, sl,
                                              nd, s));
    case 16:
      return static_cast<int>(launch_dtype<16>(dtype, x, z, dt, a, bm, cm,
                                               dskip, h0, y, h_last, nb, sl,
                                               nd, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
