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
//   ddt_t    = sum_n dh_t[n] a[n] exp(dt_t a[n]) h_{t-1}[n]
//              + x_t sum_n dh_t[n] B_t[n]
//   da[n]   += dh_t[n] dt_t exp(dt_t a[n]) h_{t-1}[n]
//   dx_t     = e_t D + dt_t sum_n dh_t[n] B_t[n]
//   dB_t[n] += dh_t[n] dt_t x_t                             (over d)
// and dh0 = exp(dt_0 a) dh_0.  dx and dz are written in x's dtype, the rest
// in fp32.
//
// What bounds it.
//   * Bytes: per (b, t, d) x, z and dy are read and dx and dz written in
//     x's dtype, dt read and ddt written in fp32: 18 bytes at bf16 (28 at
//     fp32).  At falcon-mamba-7b's training microbatch (B = 4, S = 4096,
//     Di = 8192, N = 16) 2.43 GB, 0.72 ms at 3.35 TB/s; at hymba-1.5b's
//     (Di = 3200) 0.28 ms.  The design adds the saved states (N fp32
//     every 16 steps, 0.54 GB at falcon) and the per-block dB, dC partials
//     (written, then read by the wrapper's sum: 0.54 GB): ~1.04 ms.
//   * The SFU: the gate's exponential and reciprocal and N exponentials
//     per (b, t, d) to walk the states back, N more to recompute them
//     from the saved ones (2 N + 2 = 34): 1.09 ms at falcon's microbatch
//     at 16 a clock an SM and 1,980 MHz.
//   * Issue: per state and step the recompute's 4 instructions and the
//     backward's 12; per lane and step the dB and dC sums over channels
//     (7 shuffles, 7 adds and their selects), loads and moves: the
//     compiled tile body is 130 instructions a lane and step, 520 a
//     (b, t, d), 2.1 ms at falcon's microbatch at 4 warp instructions a
//     clock an SM.  This bounds the design, above the bytes and the SFU.
//     On the card it runs at ~64% of that rate: at 16 warps an SM the
//     schedulers still wait on the shuffle rounds of the sums over lanes
//     (8 warps an SM run 1.2x slower; scripts/scan_bwd_variants.py).  One
//     thread a channel (the first design: 4 warps an SM, every step a
//     chain of dependent shared loads, FMAs and 31 shuffles) ran at a
//     third of it.
// Design.
//   * A channel's N states over a group of L = N / 4 lanes, 4 states a
//     lane, as the forward holds them: a lane's chains over n are 4 deep.
//     A block is 64 channels of one batch row, 64 L threads (8 warps at
//     N = 16), registers capped at 128 a thread so that 2 blocks (16
//     warps) fit an SM.
//   * The tile's states in registers: kChunk = 16 steps between saved
//     states is a compile-time constant, so both passes over a tile are
//     unrolled and a lane keeps h_{t-1} of the tile's first step and h_t
//     of every step, 17 x 4 floats, indexed by constants.  The recompute
//     runs forward from the saved state with the forward's own arithmetic
//     (ex2.approx on a scaled by log2(e), the same fmaf), so h_t has the
//     forward's bits; the recurrence is never inverted (exp(dt a) flushes
//     to 0 for a large dt).
//   * Sums over n by the group: each lane keeps its partials of r, sum
//     dh B and sum dh a exp(dt a) h_{t-1} for L steps, then one shuffle
//     reduce-scatter leaves lane j with step j's whole sums; lane j also
//     computes step j's gate before the L steps and hands e_t to the
//     group by a shuffle (e does not wait on r), so the gate, dz, dx,
//     ddt and their stores run once per (b, t, d).
//   * dB and dC of a step, summed over channels without float atomics:
//     a lane holds 8 values (4 dB, 4 dC) of its channel; a reduce-scatter
//     over the warp's 32 / L channels (3 halving rounds, 7 shuffles, and
//     at N = 8 one butterfly round) leaves one sum in each lane, which
//     goes to shared memory; at the tile's end the block adds its warps
//     in warp order and writes per-block partials (ceil(Di / 64), B, S,
//     2 N), which the wrapper sums over the leading axis (torch.sum, a
//     fixed order).  da and dD go out per batch row, (B, Di, N) and
//     (B, Di).  Two calls give the same bits.
//   * Movement: each tile's x, z, dy and dt (steps x the block's 64
//     channels), B and C and the 64 channels' saved states are staged in
//     shared memory by 16-byte cp.async, double-buffered, so the next
//     (earlier) tile's copies run under this tile's steps; dx, dz and ddt
//     go through a shared tile written out as 16-byte stores.  Rows of 72
//     elements keep a group of lanes reading or writing 4 (or 2) steps
//     of 8 channels free of bank conflicts.  When Di x the element size
//     is not a multiple of 16 bytes, or a pointer is off a 16-byte
//     boundary, x, z, dy, dt and the outputs move an element at a time.
//   * Steps past S and channels past Di are staged as zeros: dt = 0 makes
//     ex2(0) = 1, so both passes keep the state and the carried dh
//     exactly, and x = dy = B = C = 0 add nothing; no bounds test is
//     needed inside the unrolled passes, and such steps are never
//     written.
// Budget a block (N = 16): shared memory two stages of (x, z, dy in T, dt,
// 16 x 72 each; B and C, 16 x N fp32; the states, 64 x N fp32), the output
// tile (dx, dz in T, ddt fp32) and 8 warps x 16 steps x 2 N fp32 for dB and
// dC: 60 KB at bf16, 78 KB at fp32, 2 blocks an SM.  Registers: the 68
// states of the tile, 4 each of a log2(e), the carried dh and da, the 12
// partial sums of a group and a step's temporaries, under the cap of 128.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kChannels = 64;  // channels a block
constexpr int kChunk = 16;     // steps between saved states (forward's tile)
constexpr int kSpl = 4;        // states a lane
constexpr int kRow = 72;       // shared row of a tile: 64 channels, padded
constexpr float kExpScale = 1.4426950408889634f;  // log2(e)
constexpr float kLn2 = 0.6931471805599453f;

// Lanes that share a channel's N states.
template <int N>
__host__ __device__ constexpr int lanes() {
  return N / kSpl;
}
template <int N>
__host__ __device__ constexpr int threads() {
  return kChannels * lanes<N>();
}
// Blocks an SM must hold: caps registers at 128 a thread.
template <int N>
__host__ __device__ constexpr int min_blocks() {
  return 512 / threads<N>();
}

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

// p[u K + k]: this lane's partial sums of step u, value k, for L steps.
// Leaves in p[0 .. K-1] the sums over the group's L lanes of step j, j
// this lane's place in the group: a reduce-scatter by recursive halving,
// (L - 1) K shuffles for L K sums (as the forward's).
template <int L, int K>
__device__ __forceinline__ void group_reduce_scatter(float (&p)[L * K],
                                                     int j) {
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

// p: the 8 values (dB of the lane's 4 states, then dC) of the lane's
// channel.  Returns, in the lane of channel c (c = lane / L), the sum over
// the warp's 32 / L channels of value c % 8: halving rounds over the
// channel bits (partners lane ^ 4 L, ^ 2 L, ^ L), then at L = 2 a
// butterfly over the last bit.  Every sum is taken in a fixed order.
template <int L>
__device__ __forceinline__ float channel_reduce_scatter(float (&p)[8],
                                                        int lane) {
#pragma unroll
  for (int w = 4; w >= 1; w /= 2) {
    const bool upper = (lane & (w * L)) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? p[i] : p[i + w];
      const float keep = upper ? p[i + w] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w * L);
    }
  }
  float r = p[0];
#pragma unroll
  for (int o = 8 * L; o < 32; o *= 2) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

// f(i) for each of the K slots i = tid, tid + kT, ... of a block of kT
// threads: a compile-time count of straight-line iterations (a loop with a
// runtime bound compiles to a generic unrolled loop with remainder code).
template <int K, int kT, typename F>
__device__ __forceinline__ void for_slots(int tid, F&& f) {
#pragma unroll
  for (int it = 0; it < (K + kT - 1) / kT; ++it) {
    const int i = tid + it * kT;
    if (K % kT == 0 || i < K) f(i);
  }
}

// Shared memory a block, in floats then in T: two stages of (B, C
// [kChunk][N], the states [kChannels][N], dt [kChunk][kRow]) and of (x, z,
// dy [kChunk][kRow] each), the output tile (ddt [kChunk][kRow] fp32; dx, dz
// [kChunk][kRow] in T) and the warps' dB and dC ([warp][kChunk][2 N]).
template <typename T, int N>
struct Smem {
  static constexpr int kStageF = 2 * kChunk * N + kChannels * N +
                                 kChunk * kRow;
  static constexpr int kStageT = 3 * kChunk * kRow;
  static constexpr int kFloats = 2 * kStageF + kChunk * kRow +
                                 threads<N>() / 32 * kChunk * 2 * N;
  static constexpr int kTs = 2 * kStageT + 2 * kChunk * kRow;
  static constexpr int64_t kBytes =
      static_cast<int64_t>(kFloats) * 4 +
      static_cast<int64_t>(kTs) * static_cast<int64_t>(sizeof(T));
};

template <typename T, int N>
__global__ void __launch_bounds__(threads<N>(), min_blocks<N>())
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
                          float* __restrict__ dh0, int s_len, int di,
                          bool vec) {
  using S = Smem<T, N>;
  constexpr int L = lanes<N>();
  constexpr int kT = threads<N>();
  constexpr int V = 2 * N;                  // dB and dC of a step
  constexpr int kPerX = 16 / sizeof(T);     // elements of x a copy
  constexpr int kRowX = kChannels / kPerX;  // copies of a row of x
  constexpr int kRowF = kChannels / 4;      // copies of a row of dt
  constexpr int kRowBc = N / 4;             // copies of a row of B
  static_assert(kChunk % L == 0 && (L & (L - 1)) == 0 && 8 * L <= 32,
                "groups fill the tile and the warp");
  extern __shared__ __align__(16) float smem[];
  float* s_ddt = smem + 2 * S::kStageF;      // [kChunk][kRow]
  float* s_red = s_ddt + kChunk * kRow;      // [warp][kChunk][V]
  T* s_t = reinterpret_cast<T*>(smem + S::kFloats);
  T* s_dx = s_t + 2 * S::kStageT;            // [kChunk][kRow]
  T* s_dz = s_dx + kChunk * kRow;            // [kChunk][kRow]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = lane % L;                    // place in the lane group
  const int cw = lane / L;                   // channel in the warp
  const int cb = warp * (32 / L) + cw;       // channel in the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + cb;
  const bool active = d < di;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  // The block's (b, t = 0, d0) in x, z, dy, dt and the outputs; (b, t,
  // d0 + i) is t di + i further.
  const int64_t base = static_cast<int64_t>(b) * s_len * di + d0;
  const float* bmb = bm + static_cast<int64_t>(b) * s_len * N;
  const float* cmb = cm + static_cast<int64_t>(b) * s_len * N;

  // Stage `st` <- tile `tile`; steps past S and channels past Di are zeros
  // (the source address of a zero-filled copy stays in bounds).
  auto load_stage = [&](int tile, int st) {
    const int t0 = tile * kChunk;
    const int64_t at0 = base + static_cast<int64_t>(t0) * di;
    float* f = smem + st * S::kStageF;
    T* tt = s_t + st * S::kStageT;
    for_slots<kChunk * kRowBc, kT>(tid, [&](int i) {
      const int r = i / kRowBc;
      const int q = 4 * (i % kRowBc);
      const bool ok = t0 + r < s_len;
      const int64_t at = ok ? static_cast<int64_t>(t0 + r) * N + q : 0;
      cp_async16(smem_addr(f + r * N + q), bmb + at, ok ? 16 : 0);
      cp_async16(smem_addr(f + kChunk * N + r * N + q), cmb + at,
                 ok ? 16 : 0);
    });
    for_slots<kChannels * kRowBc, kT>(tid, [&](int i) {
      const int ch = i / kRowBc;
      const int q = 4 * (i % kRowBc);
      const bool ok = d0 + ch < di;
      const float* src =
          ok ? states + ((static_cast<int64_t>(b) * n_chunks + tile) * di +
                         d0 + ch) * N + q
             : states;
      cp_async16(smem_addr(f + 2 * kChunk * N + ch * N + q), src,
                 ok ? 16 : 0);
    });
    float* sdt = f + 2 * kChunk * N + kChannels * N;
    if (vec) {
      for_slots<kChunk * kRowX, kT>(tid, [&](int i) {
        const int r = i / kRowX;
        const int q = kPerX * (i % kRowX);
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = ok ? at0 + static_cast<int64_t>(r) * di + q
                              : base;
        const int o = r * kRow + q;
        cp_async16(smem_addr(tt + o), x + at, ok ? 16 : 0);
        cp_async16(smem_addr(tt + kChunk * kRow + o), z + at, ok ? 16 : 0);
        cp_async16(smem_addr(tt + 2 * kChunk * kRow + o), dy + at,
                   ok ? 16 : 0);
      });
      for_slots<kChunk * kRowF, kT>(tid, [&](int i) {
        const int r = i / kRowF;
        const int q = 4 * (i % kRowF);
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = ok ? at0 + static_cast<int64_t>(r) * di + q
                              : base;
        cp_async16(smem_addr(sdt + r * kRow + q), dt + at, ok ? 16 : 0);
      });
    } else {
      for_slots<kChunk * kChannels, kT>(tid, [&](int i) {
        const int r = i / kChannels;
        const int q = i % kChannels;
        const bool ok = t0 + r < s_len && d0 + q < di;
        const int64_t at = at0 + static_cast<int64_t>(r) * di + q;
        const int o = r * kRow + q;
        tt[o] = ok ? x[at] : narrow<T>(0.0f);
        tt[kChunk * kRow + o] = ok ? z[at] : narrow<T>(0.0f);
        tt[2 * kChunk * kRow + o] = ok ? dy[at] : narrow<T>(0.0f);
        sdt[o] = ok ? dt[at] : 0.0f;
      });
    }
  };
  // dx, dz and ddt of tile `tile` <- the output tile, rows up to S and
  // channels up to Di.
  auto store_out = [&](int tile) {
    const int t0 = tile * kChunk;
    const int64_t at0 = base + static_cast<int64_t>(t0) * di;
    if (vec) {
      for_slots<kChunk * kRowX, kT>(tid, [&](int i) {
        const int r = i / kRowX;
        const int q = kPerX * (i % kRowX);
        if (t0 + r < s_len && d0 + q < di) {
          const int64_t at = at0 + static_cast<int64_t>(r) * di + q;
          *reinterpret_cast<uint4*>(dx + at) =
              *reinterpret_cast<const uint4*>(s_dx + r * kRow + q);
          *reinterpret_cast<uint4*>(dz + at) =
              *reinterpret_cast<const uint4*>(s_dz + r * kRow + q);
        }
      });
      for_slots<kChunk * kRowF, kT>(tid, [&](int i) {
        const int r = i / kRowF;
        const int q = 4 * (i % kRowF);
        if (t0 + r < s_len && d0 + q < di) {
          *reinterpret_cast<float4*>(ddt + at0 +
                                     static_cast<int64_t>(r) * di + q) =
              *reinterpret_cast<const float4*>(s_ddt + r * kRow + q);
        }
      });
    } else {
      for_slots<kChunk * kChannels, kT>(tid, [&](int i) {
        const int r = i / kChannels;
        const int q = i % kChannels;
        if (t0 + r < s_len && d0 + q < di) {
          const int64_t at = at0 + static_cast<int64_t>(r) * di + q;
          const int o = r * kRow + q;
          dx[at] = s_dx[o];
          dz[at] = s_dz[o];
          ddt[at] = s_ddt[o];
        }
      });
    }
  };

  load_stage(n_chunks - 1, 0);
  cp_async_commit();

  // This lane's channel d and states n = j kSpl .. j kSpl + 3.
  const int64_t own = (static_cast<int64_t>(b) * di + d) * N + j * kSpl;
  float a2[kSpl], carry[kSpl], da_acc[kSpl];
#pragma unroll
  for (int v = 0; v < kSpl; ++v) {
    a2[v] = active ? a[static_cast<int64_t>(d) * N + j * kSpl + v] *
                         kExpScale
                   : 0.0f;
    carry[v] = active && dh_last != nullptr ? dh_last[own + v] : 0.0f;
    da_acc[v] = 0.0f;
  }
  const float dsk = active ? dskip[d] : 0.0f;
  float dd_acc = 0.0f;
  const int gbase = lane - j;  // the group's first lane

  for (int k = 0; k < n_chunks; ++k) {
    const int c = n_chunks - 1 - k;  // tiles from the last
    const int st = k & 1;
    if (k + 1 < n_chunks) {
      load_stage(c - 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // The stage is complete; the last tile's reads of the output tile and
    // of s_red are done.
    __syncthreads();
    const float* sb = smem + st * S::kStageF;
    const float* sc = sb + kChunk * N;
    const float* sst = sc + kChunk * N;
    const float* sdt = sst + kChannels * N;
    const T* sx = s_t + st * S::kStageT;
    const T* sz = sx + kChunk * kRow;
    const T* sdy = sz + kChunk * kRow;

    // hs[0]: h_{t-1} of the tile's first step (the saved state); hs[u + 1]:
    // h_t of step u, with the forward's arithmetic.
    float hs[kChunk + 1][kSpl];
    {
      const float4 h0v =
          *reinterpret_cast<const float4*>(sst + cb * N + j * kSpl);
      hs[0][0] = h0v.x;
      hs[0][1] = h0v.y;
      hs[0][2] = h0v.z;
      hs[0][3] = h0v.w;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float dtv = sdt[u * kRow + cb];
      const float dtx = widen(sx[u * kRow + cb]) * dtv;
      const float4 bv =
          *reinterpret_cast<const float4*>(sb + u * N + j * kSpl);
      const float bn[kSpl] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int v = 0; v < kSpl; ++v) {
        hs[u + 1][v] =
            fmaf(exp2_approx(dtv * a2[v]), hs[u][v], dtx * bn[v]);
      }
    }

    // The tile's steps backwards, L at a time: lane j owns step r0 + j
    // (its gate, its sums over n and its outputs).
#pragma unroll
    for (int r0 = kChunk - L; r0 >= 0; r0 -= L) {
      const int o = (r0 + j) * kRow + cb;
      const float zg = widen(sz[o]);
      const float dyg = widen(sdy[o]);
      const float xg = widen(sx[o]);
      const float dtg = sdt[o];
      const float sig = rcp_approx(1.0f + exp2_approx(-kExpScale * zg));
      const float eg = dyg * (zg * sig);
      dd_acc = fmaf(eg, xg, dd_acc);
      float part[L * 3];  // r, sum dh B, sum dh a2 exp(dt a) h_{t-1}
#pragma unroll
      for (int i = L - 1; i >= 0; --i) {
        const int u = r0 + i;
        const float e = __shfl_sync(0xffffffffu, eg, gbase + i);
        const float dtv = sdt[u * kRow + cb];
        const float dtx = widen(sx[u * kRow + cb]) * dtv;
        const float4 bv =
            *reinterpret_cast<const float4*>(sb + u * N + j * kSpl);
        const float4 cv =
            *reinterpret_cast<const float4*>(sc + u * N + j * kSpl);
        const float bn[kSpl] = {bv.x, bv.y, bv.z, bv.w};
        const float cn[kSpl] = {cv.x, cv.y, cv.z, cv.w};
        float p[8];  // dB of the lane's states in p[v], dC in p[4 + v]
        float r = 0.0f, q = 0.0f, s = 0.0f;
#pragma unroll
        for (int v = 0; v < kSpl; ++v) {
          const float ea = exp2_approx(dtv * a2[v]);
          const float ht = hs[u + 1][v];
          r = fmaf(ht, cn[v], r);
          const float dh = fmaf(e, cn[v], carry[v]);
          p[kSpl + v] = ht * e;
          p[v] = dh * dtx;
          const float w = dh * (ea * hs[u][v]);
          s = fmaf(w, a2[v], s);
          da_acc[v] = fmaf(w, dtv, da_acc[v]);
          q = fmaf(dh, bn[v], q);
          carry[v] = ea * dh;
        }
        part[i * 3] = r;
        part[i * 3 + 1] = q;
        part[i * 3 + 2] = s;
        const float red = channel_reduce_scatter<L>(p, lane);
        if (lane < 8 * L) {
          s_red[(warp * kChunk + u) * V + ((cw & 4) ? N : 0) + j * kSpl +
                (cw & 3)] = red;
        }
      }
      group_reduce_scatter<L, 3>(part, j);
      const float rg = fmaf(dsk, xg, part[0]);
      s_dz[o] = narrow<T>(dyg * rg * sig * fmaf(zg, 1.0f - sig, 1.0f));
      s_dx[o] = narrow<T>(fmaf(dtg, part[1], eg * dsk));
      s_ddt[o] = fmaf(part[2], kLn2, xg * part[1]);
    }
    __syncthreads();  // the output tile and s_red are complete
    store_out(c);
    // The block's dB and dC of the tile, its warps added in order.
    const int t0 = c * kChunk;
    const int len = min(kChunk, s_len - t0);
    float* part = dbc_part + ((static_cast<int64_t>(blockIdx.x) * gridDim.y +
                               b) * s_len + t0) * V;
    for_slots<kChunk * V, kT>(tid, [&](int i) {
      const int u = i / V;
      if (u < len) {
        float sum = s_red[i];
#pragma unroll
        for (int w = 1; w < kT / 32; ++w) sum += s_red[w * kChunk * V + i];
        part[i] = sum;
      }
    });
  }

  // dD: the group's partials (each lane's gate steps) in a fixed order.
#pragma unroll
  for (int w = 1; w < L; w *= 2) {
    dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, w);
  }
  if (active) {
    *reinterpret_cast<float4*>(dh0 + own) =
        make_float4(carry[0], carry[1], carry[2], carry[3]);
    *reinterpret_cast<float4*>(da_part + own) =
        make_float4(da_acc[0], da_acc[1], da_acc[2], da_acc[3]);
    if (j == 0) dd_part[static_cast<int64_t>(b) * di + d] = dd_acc;
  }
}

// Sets the kernel's dynamic shared memory limit and the carveout, once per
// instantiation.
template <typename T, int N>
cudaError_t prepare() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<T, N>::kBytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* z, const void* dt,
                   const void* a, const void* bm, const void* cm,
                   const void* dskip, const void* states, const void* dy,
                   const void* dh_last, void* dx, void* dz, void* ddt,
                   void* da_part, void* dbc_part, void* dd_part, void* dh0,
                   int batch, int s_len, int di, cudaStream_t stream) {
  const cudaError_t err = prepare<T, N>();
  if (err != cudaSuccess) return err;
  const bool vec =
      (static_cast<int64_t>(di) * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(z) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dt) |
        reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dz) |
        reinterpret_cast<uintptr_t>(ddt)) &
       15) == 0;
  const dim3 grid(static_cast<unsigned>((di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(batch));
  selective_scan_bwd_kernel<T, N>
      <<<grid, threads<N>(), static_cast<size_t>(Smem<T, N>::kBytes),
         stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(z),
          static_cast<const float*>(dt), static_cast<const float*>(a),
          static_cast<const float*>(bm), static_cast<const float*>(cm),
          static_cast<const float*>(dskip),
          static_cast<const float*>(states), static_cast<const T*>(dy),
          static_cast<const float*>(dh_last), static_cast<T*>(dx),
          static_cast<T*>(dz), static_cast<float*>(ddt),
          static_cast<float*>(da_part), static_cast<float*>(dbc_part),
          static_cast<float*>(dd_part), static_cast<float*>(dh0), s_len, di,
          vec);
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

template <typename T, int N>
int geometry(int* thr, int* chans, int* blocks_per_sm) {
  const cudaError_t err = prepare<T, N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *thr = threads<N>();
  *chans = kChannels;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, selective_scan_bwd_kernel<T, N>, threads<N>(),
      static_cast<size_t>(Smem<T, N>::kBytes)));
}

}  // namespace

extern "C" {

// The layout the wrapper allocates by: steps between saved states (it must
// equal the forward's, repro_selective_scan_state_chunk) and channels a
// block (the leading extent of dbc_part is ceil(d_inner / channels)).
void repro_selective_scan_bwd_layout(int* chunk, int* channels) {
  *chunk = kChunk;
  *channels = kChannels;
}

// The launch geometry of n_state and dtype: threads a block, channels a
// block (the grid is ceil(d_inner / channels) x batch blocks) and the
// blocks an SM holds at once (the runtime's occupancy, from the kernel's
// registers and shared memory).
int repro_selective_scan_bwd_geometry(int n_state, int dtype, int* thr,
                                      int* chans, int* blocks_per_sm) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_state) {
    case 8:
      return dtype == 0 ? geometry<float, 8>(thr, chans, blocks_per_sm)
                        : geometry<__nv_bfloat16, 8>(thr, chans,
                                                     blocks_per_sm);
    case 16:
      return dtype == 0 ? geometry<float, 16>(thr, chans, blocks_per_sm)
                        : geometry<__nv_bfloat16, 16>(thr, chans,
                                                      blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, z, dy, dx, dz (batch, s_len, d_inner), all float32 (dtype 0) or all
// bfloat16 (dtype 1); dt and ddt (batch, s_len, d_inner), a (d_inner,
// n_state), bm and cm (batch, s_len, n_state), d_skip (d_inner,), states
// (batch, ceil(s_len / 16), d_inner, n_state) from the forward, dh_last
// (null, or batch, d_inner, n_state) and dh0 (batch, d_inner, n_state), all
// float32; the partials, float32 and overwritten: da_part (batch, d_inner,
// n_state), dbc_part (ceil(d_inner / 64), batch, s_len, 2 n_state: dB then
// dC) and dd_part (batch, d_inner).  All contiguous; bm, cm and states
// 16-byte aligned (the kernel stages them 16 bytes at a time).  n_state 8
// or 16.
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
      di < 1 || di > 0x7fffffffLL - kChannels ||
      (dtype != 0 && dtype != 1)) {
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
