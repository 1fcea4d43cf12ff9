// Quantized fast-tier kernels for Hopper (sm_90a), bound to Python through
// a plain C interface: one byte per element (int8, or fp8 e4m3) and one
// fp32 scale per row.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/embedding_gather.py:
//   * repro_quantize_scatter    <- quantize_rows, fused with the two
//     scatters into the code buffer and the scale vector that
//     src/repro/core/tiered.py wraps around it (_kernel_scatter_q).
//   * repro_gather_rows_dequant <- gather_rows_dequant, with the inverse
//     expansion and overflow select of _JIT_GATHER_Q(_OV) folded in.
//   * repro_gather_pool_dequant <- gather_pool_dequant.
//
// All three are bound by device-memory bytes: per element they do one
// division (quantize) or one multiply and at most one add (the reads), far
// below the card's arithmetic rate.  So, as in embedding_gather.cu, a group
// of threads owns one row (the smallest power of two covering the row in
// 4-element pieces, at most a warp), neighbouring threads touch
// neighbouring addresses, codes move as 4-byte words and fp32 values as
// 16-byte vectors, and each output is written once from registers.  No
// shared memory and no barriers.
//
// quantize_scatter, the admit of a batch's rows into the quantized store
// (at the serve batch: 226,377 fp32 rows of D = 128 read, 29 MB of codes
// and the scales written to random slots, 44 us at 3.35 TB/s).  What held
// its first port back was latency, not bytes: a warp owned one row (one
// 16-byte load a lane at D = 128, so one 512-byte request in flight), and
// each row ran a dependent chain: the row's load, the absmax shuffles, only
// then the slot's load, the scale's division, a second read of the row, the
// divisions of the codes and the stores.  Its 28,298 short blocks spent
// most of their time waiting, and it reached 41% of the bound.  Now each
// group of lanes takes R rows at once (R = 2 at D <= 128, kQuantPieces
// pieces a lane in flight; R = 1 when the admit would give the card fewer
// than kQuantBlocksPerSm blocks an SM, as the per-table facade's admits of
// a few hundred rows do) and issues all their loads, the slots' included,
// before the first reduction, keeps the rows in registers from the absmax
// to the codes (up to 4 pieces a lane: D <= 512 at 4 elements a piece,
// D <= 128 at 1), and reads them with streaming loads.  Wider rows take the
// first port's two-pass loop inside the same kernel.  Not kept: 4 rows a
// group, or one wave of resident blocks striding over the rows, were slower
// at the serve batch.  A build without the code and scale stores ran much
// nearer the bound: the scattered stores (each scale a 4-byte write to a
// random slot) take most of the rest.
//
// Bits: every step is the plain version's (kernels/ref.py) in the same
// order, with IEEE division (the build passes no fast-math flag) and
// products rounded on their own (__fmul_rn: no fused multiply-add), so the
// kernels give the plain version's bits.  Indices are clamped into range
// as XLA's gather clamps them; a scatter row whose slot is out of range is
// dropped, as XLA's scatter drops it.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise; each C function returns cudaGetLastError() after its launch.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kBlock = 256;
// Row pieces (4 or 1 elements each) a lane of quantize_scatter keeps in
// flight: R = kQuantPieces / CH rows of CH pieces.
constexpr int kQuantPieces = 2;
// Fewer rows a group when the grid would give fewer blocks an SM: R = 1 is
// the faster at a few hundred rows, R = 2 at the serve batch.
constexpr int kQuantBlocksPerSm = 4;
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

int threads_per_row_log2(int64_t chunks) {
  int lg = 0;
  while (lg < 5 && (int64_t{1} << lg) < chunks) ++lg;
  return lg;
}

bool aligned(const void* ptr, int64_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// One code byte <-> fp32, per format.
template <int FMT>
struct Code;

template <>
struct Code<kInt8> {
  static constexpr float kQmax = 127.0f;
  __device__ static __forceinline__ float to_float(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(b));
  }
  // Round half to even, then clip: jnp.clip(jnp.round(y), -127, 127).
  __device__ static __forceinline__ uint8_t from_scaled(float y) {
    const float r = fminf(fmaxf(rintf(y), -kQmax), kQmax);
    return static_cast<uint8_t>(static_cast<int8_t>(r));
  }
};

template <>
struct Code<kFp8> {
  static constexpr float kQmax = 448.0f;
  __device__ static __forceinline__ float to_float(uint8_t b) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  }
  // Round to nearest even; a value an ulp past 448 saturates to 448, as
  // the plain cast rounds it.
  __device__ static __forceinline__ uint8_t from_scaled(float y) {
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
  }
};

// VEC consecutive codes of a row, as fp32.
template <int FMT, int VEC>
__device__ __forceinline__ void load_codes(const uint8_t* p, float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = Code<FMT>::to_float((w >> (8 * k)) & 0xff);
  } else {
    f[0] = Code<FMT>::to_float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    f[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *p = f[0];
  }
}

// ---------------------------------------------------------------------------
// Quantize + scatter.  A group of tpr lanes (a power of two, at most a warp)
// owns a row, 32 / tpr groups a warp, and each group takes R rows.  A warp
// issues all its rows' loads (streaming loads: each row is read once) and
// their slots before any reduction.  With CH > 0 each lane keeps its CH
// pieces of every row in registers from the absmax (each lane over its
// pieces, then a butterfly of shuffles inside the group: max is exact in any
// order) to the codes.  CH = 0 is the generic branch for wider rows: one row
// a group, read twice (the second time from L1/L2).  Every lane of a warp
// runs the shuffles; rows past the end only mask their loads and stores.
// ---------------------------------------------------------------------------
template <int VEC>
__device__ __forceinline__ void load_f32_once(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    f[0] = __ldcs(p);
  }
}

// IEEE division, then the add: never a multiply by a reciprocal.
template <int FMT>
__device__ __forceinline__ float row_scale(float amax) {
  return __fadd_rn(__fdiv_rn(amax, Code<FMT>::kQmax), 1e-12f);
}

// VEC codes of f / scale, one IEEE division each, stored as one word.
template <int FMT, int VEC>
__device__ __forceinline__ void store_codes(uint8_t* dst, const float (&f)[VEC],
                                            float scale) {
  if constexpr (VEC == 4) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w |= static_cast<uint32_t>(Code<FMT>::from_scaled(__fdiv_rn(f[k], scale)))
           << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    *dst = Code<FMT>::from_scaled(__fdiv_rn(f[0], scale));
  }
}

// Rows a group carries at most: kQuantPieces pieces a lane in flight.
__host__ __device__ constexpr int rows_per_group(int ch) {
  return ch == 0 || ch >= kQuantPieces ? 1 : kQuantPieces / ch;
}

template <int FMT, int VEC, int CH, int R>
__global__ void __launch_bounds__(kBlock)
quantize_scatter_kernel(uint8_t* __restrict__ buf, float* __restrict__ scales,
                        int64_t n_rows, int64_t d,
                        const int32_t* __restrict__ slots,
                        const float* __restrict__ rows, int64_t m,
                        int tpr_log2) {
  constexpr int NC = CH > 0 ? CH : 1;
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int groups = 32 >> tpr_log2;
  const int group = (threadIdx.x & 31) >> tpr_log2;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  const int64_t first = warp * groups * R;
  const int64_t chunks = d / VEC;
  int64_t row[R], slot[R];
  float amax[R];
  float f[R][NC][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // Each load instruction covers `groups` neighbouring rows.
    row[r] = first + r * groups + group;
    slot[r] = row[r] < m ? slots[row[r]] : -1;
  }
  if constexpr (CH > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int64_t ch = lane + int64_t{c} * tpr;
        if (row[r] < m && ch < chunks) {
          load_f32_once<VEC>(rows + row[r] * d + ch * VEC, f[r][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) f[r][c][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      amax[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) amax[r] = fmaxf(amax[r], fabsf(f[r][c][k]));
      }
    }
  } else {
    amax[0] = 0.f;
    if (row[0] < m) {
      for (int64_t c = lane; c < chunks; c += tpr) {
        float g[VEC];
        load_f32<VEC>(rows + row[0] * d + c * VEC, g);
#pragma unroll
        for (int k = 0; k < VEC; ++k) amax[0] = fmaxf(amax[0], fabsf(g[k]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int off = tpr >> 1; off > 0; off >>= 1) {
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], off));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // A row past the end has slot -1: dropped with the out-of-range ones.
    if (slot[r] < 0 || slot[r] >= n_rows) continue;
    const float scale = row_scale<FMT>(amax[r]);
    uint8_t* dst = buf + slot[r] * d;
    if constexpr (CH > 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int64_t ch = lane + int64_t{c} * tpr;
        if (ch < chunks) store_codes<FMT, VEC>(dst + ch * VEC, f[r][c], scale);
      }
    } else {
      const float* src = rows + row[r] * d;
      for (int64_t c = lane; c < chunks; c += tpr) {
        float g[VEC];
        load_f32<VEC>(src + c * VEC, g);
        store_codes<FMT, VEC>(dst + c * VEC, g, scale);
      }
    }
    if (lane == 0) scales[slot[r]] = scale;
  }
}

// ---------------------------------------------------------------------------
// Dequantizing row gather with optional inverse expansion and overflow
// rows: out[i] = ov[u] ? host_rows[u] : float(table[r]) * scales[r], with
// u = inv[i] (or i) and r = slots[u].
// ---------------------------------------------------------------------------
template <int FMT, int VEC>
__global__ void __launch_bounds__(kBlock)
gather_rows_dequant_kernel(const uint8_t* __restrict__ table,
                           const float* __restrict__ scales, int64_t n_rows,
                           int64_t d, const int32_t* __restrict__ slots,
                           int64_t n_slots, const int32_t* __restrict__ inv,
                           const uint8_t* __restrict__ ov,
                           const float* __restrict__ host_rows,
                           float* __restrict__ out, int64_t m, int tpr_log2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock >> tpr_log2) +
                      (threadIdx.x >> tpr_log2);
  if (row >= m) return;
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t chunks = d / VEC;
  const int64_t u = inv == nullptr ? row : clamp_index(inv[row], n_slots);
  float* dst = out + row * d;
  if (ov != nullptr && ov[u]) {
    const float* src = host_rows + u * d;
    for (int64_t c = lane; c < chunks; c += tpr) {
      float f[VEC];
      load_f32<VEC>(src + c * VEC, f);
      store_f32<VEC>(dst + c * VEC, f);
    }
    return;
  }
  const int64_t r = clamp_index(slots[u], n_rows);
  const float s = scales[r];
  const uint8_t* src = table + r * d;
  for (int64_t c = lane; c < chunks; c += tpr) {
    float f[VEC];
    load_codes<FMT, VEC>(src + c * VEC, f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __fmul_rn(f[k], s);
    store_f32<VEC>(dst + c * VEC, f);
  }
}

// ---------------------------------------------------------------------------
// Dequantizing sum-pool: out[b] = sum_p float(table[idx[b,p]]) * scale,
// each product rounded, summed in fp32 registers in the order p = 0..P-1.
// ---------------------------------------------------------------------------
template <int FMT, int VEC>
__global__ void __launch_bounds__(kBlock)
gather_pool_dequant_kernel(const uint8_t* __restrict__ table,
                           const float* __restrict__ scales, int64_t n_rows,
                           int64_t d, const int32_t* __restrict__ idx,
                           int64_t b, int p, float* __restrict__ out,
                           int tpr_log2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock >> tpr_log2) +
                      (threadIdx.x >> tpr_log2);
  if (row >= b) return;
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t chunks = d / VEC;
  const int32_t* ix = idx + row * p;
  for (int64_t c = lane; c < chunks; c += tpr) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < p; ++j) {
      const int64_t r = clamp_index(ix[j], n_rows);
      const float s = scales[r];
      float f[VEC];
      load_codes<FMT, VEC>(table + r * d + c * VEC, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], s));
    }
    store_f32<VEC>(out + row * d + c * VEC, acc);
  }
}

unsigned blocks_for(int64_t rows, int lg) {
  const int64_t per_block = kBlock >> lg;
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

// R rows a group, halved while the grid would give the card fewer than
// kQuantBlocksPerSm blocks an SM (a small admit spreads its rows instead).
template <int FMT, int VEC, int CH, int R>
void launch_quantize_rows(uint8_t* buf, float* scales, int64_t n_rows,
                          int64_t d, const int32_t* slots, const float* rows,
                          int64_t m, int lg, cudaStream_t s) {
  const int64_t per_block = int64_t{kBlock >> lg} * R;
  const int64_t blocks = (m + per_block - 1) / per_block;
  if constexpr (R > 1) {
    if (blocks < int64_t{kQuantBlocksPerSm} * sm_count()) {
      launch_quantize_rows<FMT, VEC, CH, R / 2>(buf, scales, n_rows, d, slots,
                                                rows, m, lg, s);
      return;
    }
  }
  quantize_scatter_kernel<FMT, VEC, CH, R>
      <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
          buf, scales, n_rows, d, slots, rows, m, lg);
}

// Pieces a lane holds of a row: 1, 2 or 4 in registers, else the generic
// branch.
template <int FMT, int VEC>
void launch_quantize(uint8_t* buf, float* scales, int64_t n_rows, int64_t d,
                     const int32_t* slots, const float* rows, int64_t m,
                     cudaStream_t s) {
  const int64_t chunks = d / VEC;
  const int lg = threads_per_row_log2(chunks);
  const int64_t per_lane = (chunks + (int64_t{1} << lg) - 1) >> lg;
#define REPRO_QUANTIZE(CH)                                                  \
  launch_quantize_rows<FMT, VEC, CH, rows_per_group(CH)>(                   \
      buf, scales, n_rows, d, slots, rows, m, lg, s)
  if (per_lane <= 1) {
    REPRO_QUANTIZE(1);
  } else if (per_lane <= 2) {
    REPRO_QUANTIZE(2);
  } else if (per_lane <= 4) {
    REPRO_QUANTIZE(4);
  } else {
    REPRO_QUANTIZE(0);
  }
#undef REPRO_QUANTIZE
}

template <int FMT, int VEC>
void launch_gather(const uint8_t* table, const float* scales, int64_t n_rows,
                   int64_t d, const int32_t* slots, int64_t n_slots,
                   const int32_t* inv, const uint8_t* ov,
                   const float* host_rows, float* out, int64_t m,
                   cudaStream_t s) {
  const int lg = threads_per_row_log2(d / VEC);
  gather_rows_dequant_kernel<FMT, VEC><<<blocks_for(m, lg), kBlock, 0, s>>>(
      table, scales, n_rows, d, slots, n_slots, inv, ov, host_rows, out, m, lg);
}

template <int FMT, int VEC>
void launch_pool(const uint8_t* table, const float* scales, int64_t n_rows,
                 int64_t d, const int32_t* idx, int64_t b, int p, float* out,
                 cudaStream_t s) {
  const int lg = threads_per_row_log2(d / VEC);
  gather_pool_dequant_kernel<FMT, VEC><<<blocks_for(b, lg), kBlock, 0, s>>>(
      table, scales, n_rows, d, idx, b, p, out, lg);
}

// Picks the format and the vector width (4 elements where D and the
// pointers allow it, else 1) and calls LAUNCH<FMT, VEC>.
#define REPRO_DISPATCH(fmt, vec4, LAUNCH, ...)                      \
  do {                                                              \
    if ((fmt) == kInt8) {                                           \
      if (vec4) LAUNCH<kInt8, 4>(__VA_ARGS__);                      \
      else LAUNCH<kInt8, 1>(__VA_ARGS__);                           \
    } else if ((fmt) == kFp8) {                                     \
      if (vec4) LAUNCH<kFp8, 4>(__VA_ARGS__);                       \
      else LAUNCH<kFp8, 1>(__VA_ARGS__);                            \
    } else {                                                        \
      return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                               \
  } while (0)

}  // namespace

extern "C" {

// buf (n_rows, d) codes of format fmt (0 = int8, 1 = fp8 e4m3); scales
// (n_rows,) fp32; slots (m,) int32; rows (m, d) fp32.  Writes buf[slots[i]]
// and scales[slots[i]] for each i.
int repro_quantize_scatter(uint8_t* buf, float* scales, int64_t n_rows,
                           int64_t d, int fmt, const int32_t* slots,
                           const float* rows, int64_t m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && aligned(buf, 4) && aligned(rows, 16);
  REPRO_DISPATCH(fmt, vec4, launch_quantize, buf, scales, n_rows, d, slots,
                 rows, m, s);
  return static_cast<int>(cudaGetLastError());
}

// table (n_rows, d) codes; scales (n_rows,) fp32; slots (n_slots,) int32;
// inv (m,) int32 or null (then m == n_slots); ov (n_slots,) bytes and
// host_rows (n_slots, d) fp32, both null or both given; out (m, d) fp32.
int repro_gather_rows_dequant(const uint8_t* table, const float* scales,
                              int64_t n_rows, int64_t d, int fmt,
                              const int32_t* slots, int64_t n_slots,
                              const int32_t* inv, const uint8_t* ov,
                              const float* host_rows, float* out, int64_t m,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && aligned(table, 4) &&
                    aligned(host_rows, 16) && aligned(out, 16);
  REPRO_DISPATCH(fmt, vec4, launch_gather, table, scales, n_rows, d, slots,
                 n_slots, inv, ov, host_rows, out, m, s);
  return static_cast<int>(cudaGetLastError());
}

// table (n_rows, d) codes; scales (n_rows,) fp32; idx (b, p) int32;
// out (b, d) fp32.
int repro_gather_pool_dequant(const uint8_t* table, const float* scales,
                              int64_t n_rows, int64_t d, int fmt,
                              const int32_t* idx, int64_t b, int p, float* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && aligned(table, 4) && aligned(out, 16);
  REPRO_DISPATCH(fmt, vec4, launch_pool, table, scales, n_rows, d, idx, b, p,
                 out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
