// Pieces shared by the two attention kernels (flash_attention.cu,
// decode_attention.cu): element strides, the mask value, conversions,
// shared-memory addresses, the asynchronous 16-byte copy (cp.async) that
// fills the decode kernel's ring, and the tile loader of the f32 flash
// body, which stages rows of a strided [rows, D] slice in shared memory as
// f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn_common {

constexpr float NEG_INF = -1e30f;  // the reference's mask value

// element strides of the batch, head and sequence dims; the last dim is
// contiguous
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; when
// `valid` is false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a slice whose row r starts at base + r * row_stride
// -> dst[r - r0][0, D) as f32 (leading dim ld); rows at or past `limit` are
// zero-filled, so a ragged edge needs no padding in device memory.  Each
// thread moves 16 bytes per step: the caller guarantees 16-byte aligned
// rows (the wrapper checks the pointers and strides).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ base, long long row_stride,
                                          int r0, int limit, float* __restrict__ dst, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(D % VEC == 0, "head_dim must be a multiple of the 16-byte vector");
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * VEC;
    float* o = dst + r * ld + c;
    if (r0 + r < limit) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (r0 + r) * row_stride + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = 0.0f;
    }
  }
}

}  // namespace attn_common
