// Flash decode: one new query token per sequence against its KV cache,
// with a valid length per sequence, f32 math, read in bf16 or f32 and
// written in the input's dtype.
//
//   q [B, Hkv, G, D] (G = Hq / Hkv query heads per kv head, contiguous)
//   k/v: row s of (b, h) at k + b*sb + h*sh + s*ss (explicit strides, the
//        last dim contiguous), s < S; lengths [B] int32
//   out [B, Hkv, G, D] (contiguous)
//
// The model's cache layout [B, S_cap, Hkv, D] goes in through its strides,
// so a decode step transposes no cache.
//
// Replaces: src/repro/kernels/decode_attention.py : _decode_kernel
//           (decode_attention_pallas).  In the port it is on the decode path:
//           models/attention.py's `attn_decode` calls it under
//           attn_impl="pallas".
//
// Semantics (those of _decode_kernel / kernels/ref.py decode_ref): the
// cache rows s < lengths[b] are visible; chunks wholly past the length are
// never read; a sequence of length 0 writes acc / max(l, 1e-30) = 0.
//
// Bound on the H100: every visible K and V row is read once (2 * len * D
// elements per (b, kv head)) for 4 * G * len * D FLOPs, about G / 2 FLOPs
// per byte in bf16: bytes bound it.  At the serving step (B 8, Hkv 8, D 128,
// lengths up to ~1600) that is some 50 MB of K/V, ~15 us at 3.35 TB/s.
//
// Design (simple and right first):
//   * one block of 128 threads per (kv head, sequence): the G query heads of
//     a kv head share the block, so each K/V row is read from device memory
//     once;
//   * K/V stream through shared memory in 64-row chunks converted to f32
//     (16-byte global loads; K rows padded to D + 1 floats so the per-row
//     dots of the score step hit 32 different banks);
//   * scores [G, 64] one dot per thread, the online-softmax update of each
//     head by one warp (shuffles), and the PV product with thread t owning
//     output column t % D of heads t / D, t / D + 128 / D, ... in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

using attn_common::load_rows;
using attn_common::NEG_INF;
using attn_common::store_out;
using attn_common::Strides;

constexpr int BKD = 64;  // cache rows per chunk (two per lane in the softmax step)
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int G_MAX = 16;

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (G * D + BKD * (D + 1) + BKD * D + G * BKD + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, Strides sk, Strides sv, int Hkv, int G,
    int S, float scale) {
  constexpr int LDK = D + 1;
  constexpr int TPD = THREADS / D;                    // threads per output column
  constexpr int NG = (G_MAX + TPD - 1) / TPD;         // heads per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [G][D]
  float* ks = qs + G * D;           // [BKD][D + 1]
  float* vs = ks + BKD * LDK;       // [BKD][D]
  float* ps = vs + BKD * D;         // [G][BKD]
  float* ms = ps + G * BKD;         // running max per head
  float* ls = ms + G;               // running sum per head
  float* as = ls + G;               // this chunk's rescale per head

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const long long qo = (b * Hkv + h) * static_cast<long long>(G) * D;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < G * D; i += THREADS) qs[i] = attn_common::to_f32(q[qo + i]);
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.0f;
  }
  const int d = tid % D;
  const int g0 = tid / D;
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < len; c0 += BKD) {
    __syncthreads();  // the previous chunk's readers are done (and q is in)
    load_rows<T, D, BKD>(kb, sk.s, c0, len, ks, LDK);
    load_rows<T, D, BKD>(vb, sv.s, c0, len, vs, D);
    __syncthreads();

    for (int p = tid; p < G * BKD; p += THREADS) {
      const int g = p / BKD, c = p - g * BKD;
      const float* qr = qs + g * D;
      const float* kr = ks + c * LDK;
      float dot = 0.0f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kr[e], dot);
      ps[p] = c0 + c < len ? dot * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float* pr = ps + g * BKD;
      const float a0 = pr[lane], a1 = pr[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = c0 + lane < len ? expf(a0 - m_new) : 0.0f;
      const float p1 = c0 + lane + 32 < len ? expf(a1 - m_new) : 0.0f;
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
        as[g] = alpha;
      }
    }
    __syncthreads();

    const int n_rows = min(BKD, len - c0);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = g0 + i * TPD;
      if (g >= G) break;
      const float* pr = ps + g * BKD;
      float a = acc[i] * as[g];
      for (int c = 0; c < n_rows; ++c) a = fmaf(pr[c], vs[c * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();  // ls is final

#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + i * TPD;
    if (g >= G) break;
    store_out(out + qo + g * D + d, acc[i] / fmaxf(ls[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           const Strides* st, int B, int Hkv, int G, int S, float scale, cudaStream_t stream) {
  static_assert(THREADS % D == 0, "head_dim must divide the block");
  const size_t smem = smem_bytes<D>(G);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes<D>(G_MAX)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), st[0], st[1], Hkv, G, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const int* lengths, void* o,
             const Strides* st, int B, int Hkv, int G, int S, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, st, B, Hkv, G, S, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, o, st, B, Hkv, G, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, o, st, B, Hkv, G, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, o, st, B, Hkv, G, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kv_strides: 6 element strides, (b, h, s) of k then v; q and out are
// contiguous [B, Hkv, G, D].  is_bf16: q, k, v and out are bf16, else f32.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* lengths,
                                void* o, int is_bf16, int D, const long long* kv_strides, int B,
                                int Hkv, int G, int S, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > G_MAX || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[2] = {Strides{kv_strides[0], kv_strides[1], kv_strides[2]},
                         Strides{kv_strides[3], kv_strides[4], kv_strides[5]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(D, q, k, v, lengths, o, st, B, Hkv, G, S, scale, s);
  return dispatch<float>(D, q, k, v, lengths, o, st, B, Hkv, G, S, scale, s);
}
