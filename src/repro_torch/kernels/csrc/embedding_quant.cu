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

namespace {

constexpr int kBlock = 256;
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
// Quantize + scatter.  Pass 1 takes the row's absmax (each thread over its
// pieces, then a butterfly of shuffles inside the group: max is exact in
// any order); pass 2 reads the row again (from L1/L2) and writes the codes.
// Every lane of the warp runs the shuffles, so rows past the end only mask
// their loads and stores.
// ---------------------------------------------------------------------------
template <int FMT, int VEC>
__global__ void __launch_bounds__(kBlock)
quantize_scatter_kernel(uint8_t* __restrict__ buf, float* __restrict__ scales,
                        int64_t n_rows, int64_t d,
                        const int32_t* __restrict__ slots,
                        const float* __restrict__ rows, int64_t m,
                        int tpr_log2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock >> tpr_log2) +
                      (threadIdx.x >> tpr_log2);
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const bool live = row < m;
  const int64_t chunks = d / VEC;
  const float* src = rows + (live ? row : 0) * d;
  float amax = 0.f;
  if (live) {
    for (int64_t c = lane; c < chunks; c += tpr) {
      float f[VEC];
      load_f32<VEC>(src + c * VEC, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) amax = fmaxf(amax, fabsf(f[k]));
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (!live) return;
  const int64_t slot = slots[row];
  if (slot < 0 || slot >= n_rows) return;
  // IEEE division, then the add: never a multiply by a reciprocal.
  const float scale = __fadd_rn(__fdiv_rn(amax, Code<FMT>::kQmax), 1e-12f);
  uint8_t* dst = buf + slot * d;
  for (int64_t c = lane; c < chunks; c += tpr) {
    float f[VEC];
    load_f32<VEC>(src + c * VEC, f);
    if constexpr (VEC == 4) {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w |= static_cast<uint32_t>(Code<FMT>::from_scaled(__fdiv_rn(f[k], scale)))
             << (8 * k);
      }
      *reinterpret_cast<uint32_t*>(dst + c * 4) = w;
    } else {
      dst[c] = Code<FMT>::from_scaled(__fdiv_rn(f[0], scale));
    }
  }
  if (lane == 0) scales[slot] = scale;
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

template <int FMT, int VEC>
void launch_quantize(uint8_t* buf, float* scales, int64_t n_rows, int64_t d,
                     const int32_t* slots, const float* rows, int64_t m,
                     cudaStream_t s) {
  const int lg = threads_per_row_log2(d / VEC);
  quantize_scatter_kernel<FMT, VEC><<<blocks_for(m, lg), kBlock, 0, s>>>(
      buf, scales, n_rows, d, slots, rows, m, lg);
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
