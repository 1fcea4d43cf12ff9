// Embedding row gathers for the tiered DLRM store and the pooled lookup,
// for Hopper (sm_90a), bound to Python through a plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/embedding_gather.py:
//   * repro_gather_rows  <- gather_rows (one row per grid step), together
//     with the jitted inverse expansion and overflow select that
//     src/repro/core/tiered.py wraps around it (_JIT_GATHER,
//     _JIT_GATHER_OV, _kernel_gathers): out[i] = ov[inv[i]] ?
//     host_rows[inv[i]] : table[slots[inv[i]]], written in request order
//     by one launch.  With no inverse it is the plain gather
//     out[i] = table[idx[i]].
//   * repro_gather_pool  <- gather_pool: out[b] = sum_p float(table[idx[b,p]]).
//     With skip_negative it is also the body of the row-sharded lookup's
//     per-shard pool (src/repro/models/dlrm.py:86-98, XLA inside a
//     shard_map there): an id < 0 marks a row another shard owns and adds
//     nothing, where JAX adds a zero row (where(ok, rows, 0).sum).
//
// Both are bound by device-memory bytes: they do no arithmetic beyond one
// add per gathered element.  The design therefore only moves bytes well:
// a group of threads owns an output row, each thread moves 16-byte
// vectors, neighbouring threads touch neighbouring addresses, and each
// output row is written once, straight from registers.  The expanded rows
// never round-trip through a unique-row intermediate, and the pooled sum
// stays in fp32 registers across the P gathered rows.  Indices are clamped
// into range, as XLA's gather clamps them in the JAX package; the pool's
// shard window (kSkipNegative) skips a negative id instead, a template flag
// so that the unmasked instantiations compile to the code they had.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise; each C function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Threads per row: the smallest power of two covering `chunks` vectors,
// at most one warp.
int threads_per_row_log2(int64_t chunks) {
  int lg = 0;
  while (lg < 5 && (int64_t{1} << lg) < chunks) ++lg;
  return lg;
}

// ---------------------------------------------------------------------------
// Row gather with optional inverse expansion and overflow rows.  V is the
// copy unit (16, 8, 4, 2 or 1 bytes), picked on the host from the row size
// and the pointers' alignment: rows are copied as bytes, whatever their type.
// ---------------------------------------------------------------------------
template <typename V>
__global__ void __launch_bounds__(kBlock)
gather_rows_kernel(const V* __restrict__ table, int64_t n_rows,
                   const int32_t* __restrict__ slots, int64_t n_slots,
                   const int32_t* __restrict__ inv,
                   const uint8_t* __restrict__ ov,
                   const V* __restrict__ host_rows,
                   V* __restrict__ out, int64_t m, int64_t vecs, int tpr_log2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock >> tpr_log2) +
                      (threadIdx.x >> tpr_log2);
  if (row >= m) return;
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const int64_t u = inv == nullptr ? row : clamp_index(inv[row], n_slots);
  const V* src;
  if (ov != nullptr && ov[u]) {
    src = host_rows + u * vecs;
  } else {
    src = table + clamp_index(slots[u], n_rows) * vecs;
  }
  V* dst = out + row * vecs;
  for (int64_t v = lane; v < vecs; v += (1 << tpr_log2)) dst[v] = src[v];
}

template <typename V>
void launch_gather_rows(const void* table, int64_t n_rows, int64_t row_bytes,
                        const int32_t* slots, int64_t n_slots,
                        const int32_t* inv, const uint8_t* ov,
                        const void* host_rows, void* out, int64_t m,
                        cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  const int lg = threads_per_row_log2(vecs);
  const int64_t rows_per_block = kBlock >> lg;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const V*>(table), n_rows, slots, n_slots, inv, ov,
      static_cast<const V*>(host_rows), static_cast<V*>(out), m, vecs, lg);
}

// ---------------------------------------------------------------------------
// Sum-pooled gather.  VEC elements of T make one 16-byte load (or VEC = 1
// where D or the pointers do not allow it); the group of threads that owns
// an output row splits D into VEC-wide chunks, and each thread sums its
// chunks over the P gathered rows in fp32 registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[1]) { f[0] = *p; }

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(*p);
}

template <typename T, int VEC, bool kSkipNegative>
__global__ void __launch_bounds__(kBlock)
gather_pool_kernel(const T* __restrict__ table, int64_t n_rows, int64_t d,
                   const int32_t* __restrict__ idx, int64_t b, int p,
                   float* __restrict__ out, int tpr_log2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBlock >> tpr_log2) +
                      (threadIdx.x >> tpr_log2);
  if (row >= b) return;
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const int64_t chunks = d / VEC;
  const int32_t* ix = idx + row * p;
  for (int64_t c = lane; c < chunks; c += (1 << tpr_log2)) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < p; ++j) {
      const int32_t id = ix[j];
      if constexpr (kSkipNegative) {
        if (id < 0) continue;
      }
      const int64_t r = clamp_index(id, n_rows);
      float f[VEC];
      load_vec(table + r * d + c * VEC, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += f[k];
    }
    float* o = out + row * d + c * VEC;
    if constexpr (VEC == 1) {
      o[0] = acc[0];
    } else {
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        *reinterpret_cast<float4*>(o + k) =
            make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
      }
    }
  }
}

template <typename T, int VEC>
void launch_gather_pool(const void* table, int64_t n_rows, int64_t d,
                        const int32_t* idx, int64_t b, int p, float* out,
                        bool skip_negative, cudaStream_t stream) {
  const int lg = threads_per_row_log2(d / VEC);
  const int64_t rows_per_block = kBlock >> lg;
  const unsigned blocks =
      static_cast<unsigned>((b + rows_per_block - 1) / rows_per_block);
  if (skip_negative) {
    gather_pool_kernel<T, VEC, true><<<blocks, kBlock, 0, stream>>>(
        static_cast<const T*>(table), n_rows, d, idx, b, p, out, lg);
  } else {
    gather_pool_kernel<T, VEC, false><<<blocks, kBlock, 0, stream>>>(
        static_cast<const T*>(table), n_rows, d, idx, b, p, out, lg);
  }
}

bool aligned(const void* ptr, int64_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// table (n_rows, row_bytes) bytes; slots (n_slots,) int32; inv (m,) int32
// or null (then m == n_slots and out[i] = table[slots[i]]); ov (n_slots,)
// bytes and host_rows (n_slots, row_bytes), both null or both given;
// out (m, row_bytes).
int repro_gather_rows(const void* table, int64_t n_rows, int64_t row_bytes,
                      const int32_t* slots, int64_t n_slots,
                      const int32_t* inv, const uint8_t* ov,
                      const void* host_rows, void* out, int64_t m,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t w = 16;
  while (w > 1 && !(row_bytes % w == 0 && aligned(table, w) &&
                    aligned(host_rows, w) && aligned(out, w))) {
    w >>= 1;
  }
  switch (w) {
    case 16: launch_gather_rows<uint4>(table, n_rows, row_bytes, slots, n_slots, inv, ov, host_rows, out, m, s); break;
    case 8: launch_gather_rows<uint2>(table, n_rows, row_bytes, slots, n_slots, inv, ov, host_rows, out, m, s); break;
    case 4: launch_gather_rows<uint32_t>(table, n_rows, row_bytes, slots, n_slots, inv, ov, host_rows, out, m, s); break;
    case 2: launch_gather_rows<uint16_t>(table, n_rows, row_bytes, slots, n_slots, inv, ov, host_rows, out, m, s); break;
    default: launch_gather_rows<uint8_t>(table, n_rows, row_bytes, slots, n_slots, inv, ov, host_rows, out, m, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// table (n_rows, d) of dtype 0 = float32 or 1 = bfloat16; idx (b, p)
// int32; out (b, d) float32.  skip_negative != 0: an id < 0 adds nothing
// (the shard window); else every id is clamped into [0, n_rows).
int repro_gather_pool(const void* table, int64_t n_rows, int64_t d, int dtype,
                      const int32_t* idx, int64_t b, int p, float* out,
                      int skip_negative, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t itemsize = dtype == 0 ? 4 : 2;
  const bool vec = (d * itemsize) % 16 == 0 && aligned(table, 16) && aligned(out, 16);
  const bool skip = skip_negative != 0;
  if (dtype == 0) {
    if (vec) launch_gather_pool<float, 4>(table, n_rows, d, idx, b, p, out, skip, s);
    else launch_gather_pool<float, 1>(table, n_rows, d, idx, b, p, out, skip, s);
  } else if (dtype == 1) {
    if (vec) launch_gather_pool<__nv_bfloat16, 8>(table, n_rows, d, idx, b, p, out, skip, s);
    else launch_gather_pool<__nv_bfloat16, 1>(table, n_rows, d, idx, b, p, out, skip, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
