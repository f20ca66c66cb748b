// Split-KV flash decode: one new query token per sequence against its KV
// cache, with a valid length per sequence, f32 math, read in bf16 or f32
// and written in the input's dtype.
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
// cache rows s < lengths[b] are visible; rows past the length are never
// read; a sequence of length 0 writes acc / max(l, 1e-30) = 0.
//
// Bound on the H100: every visible K and V row is read once (2 * len * D
// elements per (b, kv head)) for 4 * G * len * D FLOPs, about G / 2 FLOPs
// per byte in bf16: bytes bound it.  At the serving shape (B 8, Hkv 8, D
// 128, a full 2048-row cache) that is 67 MB of K/V, 20 us at 3.35 TB/s.
//
// Design:
//   * the cache rows [0, S) of each (b, kv head) are cut into n_split even
//     splits (the wrapper's `decode_splits`, a function of B * Hkv and the
//     capacity S, never of the lengths), one block of 128 threads each:
//     grid (n_split, Hkv, B), so a few (b, kv head) pairs still fill the
//     card.  A split that starts at or past its sequence's length writes an
//     empty partial (m = -1e30, l = 0) and reads nothing;
//   * a block streams its rows through a three-stage cp.async ring of
//     32-row K and V tiles kept in the cache's dtype (16-byte copies, rows
//     past the split's end zero-filled), two tiles ahead of the math;
//   * scores: a warp takes rows in groups of 32 / (D * bytes / 16), its
//     lanes split a row into 16-byte vectors and reduce with shuffles; the
//     G query heads of the kv head share every K/V row;
//   * online softmax per head by one warp, then the PV product over the
//     whole tile (rows past the end are zeros in V and in P) with thread t
//     owning output column t % D of heads t / D, t / D + 128 / D, ...;
//   * each split writes its partial (acc[G, D], m[G], l[G]) in f32 to the
//     wrapper's scratch, and a second kernel merges the splits of each
//     (b, kv head) in split order: no atomics, so two calls give the same
//     bits.  With one split the block writes the output directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

using attn_common::NEG_INF;
using attn_common::store_out;
using attn_common::Strides;
using attn_common::to_f32;

constexpr int TR = 32;        // cache rows per tile (one per lane in the softmax step)
constexpr int STAGES = 3;     // K/V ring depth
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int G_MAX = 16;

template <typename T, int D>
struct DecodeLayout {
  static constexpr int TILE = TR * D;                          // elements of one K or V tile
  static constexpr size_t RING = sizeof(T) * 2 * STAGES * TILE;
  static size_t smem(int G) { return RING + sizeof(float) * (G * D + G * TR + 3 * G); }
};

// rows [r0, r0 + TR) of a strided slice -> a dense [TR, D] tile at `dst`,
// asynchronously; rows at or past `end` are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride, int r0, int end,
                                           T* dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < TR * CPR; i += THREADS) {
    const int r = i / CPR, c = (i - (i / CPR) * CPR) * VEC;
    const bool ok = r0 + r < end;
    attn_common::cp_async16(attn_common::smem_addr(dst + r * D + c),
                            ok ? base + (r0 + r) * row_stride + c : base, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part, Strides sk,
    Strides sv, int Hkv, int G, int S, int n_split, float scale) {
  using L = DecodeLayout<T, D>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPR = D / VEC;        // lanes per row in the score step
  constexpr int RPW = 32 / LPR;       // rows per warp step
  constexpr int TPD = THREADS / D;    // threads per output column
  constexpr int NG = (G_MAX + TPD - 1) / TPD;
  static_assert(LPR <= 32 && THREADS % D == 0, "head_dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);          // stage i: K at 2 i TILE, V at (2 i + 1) TILE
  float* qs = reinterpret_cast<float*>(smem_raw + L::RING);   // [G][D]
  float* ps = qs + G * D;                                      // [G][TR]
  float* ms = ps + G * TR;                                     // running max per head
  float* ls = ms + G;                                          // running sum per head
  float* as = ls + G;                                          // this tile's rescale per head

  const int split = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), S);
  const int start = static_cast<int>(static_cast<long long>(split) * S / n_split);
  const int end = min(static_cast<int>(static_cast<long long>(split + 1) * S / n_split), len);
  const int n_tiles = end > start ? (end - start + TR - 1) / TR : 0;
  const long long qo = (b * Hkv + h) * static_cast<long long>(G) * D;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) {
      load_tile<T, D>(kb, sk.s, start + j * TR, end, ring + (2 * j) * L::TILE);
      load_tile<T, D>(vb, sv.s, start + j * TR, end, ring + (2 * j + 1) * L::TILE);
    }
    attn_common::cp_async_commit();
  }
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f32(q[qo + i]);
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.0f;
  }
  const int d = tid % D;
  const int g0 = tid / D;
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    attn_common::cp_async_wait<STAGES - 2>();   // tile t landed (this thread's copies)
    __syncthreads();   // ... everyone's; and every thread is past tile t - 1
    {
      const int tn = t + STAGES - 1;   // into the stage tile t - 1 used
      if (tn < n_tiles) {
        const int st = tn % STAGES;
        load_tile<T, D>(kb, sk.s, start + tn * TR, end, ring + (2 * st) * L::TILE);
        load_tile<T, D>(vb, sv.s, start + tn * TR, end, ring + (2 * st + 1) * L::TILE);
      }
      attn_common::cp_async_commit();
    }
    const T* ks = ring + (2 * (t % STAGES)) * L::TILE;
    const T* vs = ks + L::TILE;
    const int r0 = start + t * TR;

    // scores: the LPR lanes of a row each hold one 16-byte vector of it
    for (int rb = warp * RPW; rb < TR; rb += NWARPS * RPW) {
      const int r = rb + lane / LPR;
      const int e0 = (lane % LPR) * VEC;
      const uint4 raw = *reinterpret_cast<const uint4*>(ks + r * D + e0);
      const T* kv = reinterpret_cast<const T*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = to_f32(kv[e]);
#pragma unroll 2
      for (int g = 0; g < G; ++g) {
        const float* qr = qs + g * D + e0;
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[e], kf[e], dot);
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
        if (lane % LPR == 0) ps[g * TR + r] = r0 + r < end ? dot * scale : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      float* pr = ps + g * TR;
      const float s = pr[lane];
      float mx = s;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = r0 + lane < end ? expf(s - m_new) : 0.0f;
      pr[lane] = p;
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
        as[g] = alpha;
      }
    }
    __syncthreads();

    // rows past the end hold zeros in V and in P, so every tile is summed whole
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = g0 + i * TPD;
      if (g >= G) break;
      const float4* pr = reinterpret_cast<const float4*>(ps + g * TR);
      float a = acc[i] * as[g];
#pragma unroll
      for (int c = 0; c < TR; c += 4) {
        const float4 p4 = pr[c / 4];
        a = fmaf(p4.x, to_f32(vs[c * D + d]), a);
        a = fmaf(p4.y, to_f32(vs[(c + 1) * D + d]), a);
        a = fmaf(p4.z, to_f32(vs[(c + 2) * D + d]), a);
        a = fmaf(p4.w, to_f32(vs[(c + 3) * D + d]), a);
      }
      acc[i] = a;
    }
  }
  attn_common::cp_async_wait<0>();
  __syncthreads();   // ms, ls are final

  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = g0 + i * TPD;
      if (g >= G) break;
      store_out(out + qo + g * D + d, acc[i] / fmaxf(ls[g], 1e-30f));
    }
    return;
  }
  // partial of (b, h, split): acc [G][D], then m [G], then l [G]
  float* pp = part + ((b * Hkv + h) * n_split + split) * static_cast<long long>(G) * (D + 2);
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + i * TPD;
    if (g >= G) break;
    pp[g * D + d] = acc[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    pp[G * D + g] = ms[g];
    pp[G * D + G + g] = ls[g];
  }
}

// out[b, h, g, :] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - max_s m_s), summed in split order; the weights of all
// splits are computed first, so the partials are then read with no
// dependence between splits
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_merge_kernel(const float* __restrict__ part,
                                                               T* __restrict__ out, int Hkv,
                                                               int G, int n_split) {
  extern __shared__ float ws[];     // [n_split][G] weights, then [G] 1 / denominator
  float* inv = ws + n_split * G;
  const long long bh = static_cast<long long>(blockIdx.y) * Hkv + blockIdx.x;
  const long long stride = static_cast<long long>(G) * (D + 2);   // one split's partial
  const float* pp = part + bh * n_split * stride;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float mx = NEG_INF;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pp[s * stride + G * D + g]);
    float den = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(pp[s * stride + G * D + g] - mx);
      ws[s * G + g] = w;
      den = fmaf(w, pp[s * stride + G * D + G + g], den);
    }
    inv[g] = 1.0f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D;
    float num = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) num = fmaf(ws[s * G + g], pp[s * stride + i], num);
    store_out(out + bh * G * D + i, num * inv[g]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, float* part,
           const Strides* st, int B, int Hkv, int G, int S, int n_split, float scale,
           cudaStream_t stream) {
  using L = DecodeLayout<T, D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::smem(G_MAX)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  decode_split_kernel<T, D><<<dim3(n_split, Hkv, B), THREADS, L::smem(G), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), part, st[0], st[1], Hkv, G, S, n_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  decode_merge_kernel<T, D><<<dim3(Hkv, B), THREADS, sizeof(float) * (n_split + 1) * G, stream>>>(
      part, static_cast<T*>(o), Hkv, G, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const int* lengths, void* o,
             float* part, const Strides* st, int B, int Hkv, int G, int S, int n_split,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kv_strides: 6 element strides, (b, h, s) of k then v; q and out are
// contiguous [B, Hkv, G, D].  is_bf16: q, k, v and out are bf16, else f32.
// part: f32 scratch of B * Hkv * n_split * G * (D + 2) floats (unused, may be
// null, when n_split is 1).  Launches the split kernel and, for n_split > 1,
// the merge kernel; returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* lengths,
                                void* o, float* part, int is_bf16, int D,
                                const long long* kv_strides, int B, int Hkv, int G, int S,
                                int n_split, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > G_MAX || S < 1 || n_split < 1 || n_split > S ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[2] = {Strides{kv_strides[0], kv_strides[1], kv_strides[2]},
                         Strides{kv_strides[3], kv_strides[4], kv_strides[5]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale,
                                   s);
  return dispatch<float>(D, q, k, v, lengths, o, part, st, B, Hkv, G, S, n_split, scale, s);
}
