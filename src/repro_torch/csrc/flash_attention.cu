// Causal / GQA flash attention for prefill: out = softmax(q k^T * scale) v
// with online softmax, f32 math, read in bf16 or f32 and written in the
// input's dtype.
//
//   q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], out [B, Hq, Sq, D]
//
// every operand addressed through explicit (b, h, s) element strides with a
// contiguous last dim, so the model's [B, S, H, D] activations go in as
// they are (no transposes) and so does the op-level [B, H, S, D] layout.
//
// Replaces: src/repro/kernels/flash_attention.py : _flash_kernel
//           (flash_attention_pallas), reached from models/attention.py's
//           `_pallas_attn` on the prefill path.
//
// Semantics (those of _flash_kernel / kernels/ref.py mha_ref):
//   * causal: column c of query row r is visible when c <= r + (Sk - Sq)
//     (the reference's tril offset; Sq == Sk on the model path);
//   * kv columns >= Sk are masked (no padding to a block multiple is needed:
//     ragged edges are masked and zero-filled here);
//   * GQA by index: query head hq reads kv head hq / (Hq / Hkv); repeated
//     K/V are never materialised;
//   * a row whose softmax mass is 0 writes acc / max(l, 1e-30) = 0.
//
// Bound on the H100: two chained products, 4 * Hq * Sq * Sk * D FLOPs
// (halved under the causal mask) against some (Hq + 2 Hkv) * S * D * bytes
// of operands: at the serving shape [1, 16, 2048, 128] with Hkv 8, causal,
// 17.2 GFLOP against 16.8 MB, far above the card's ~295 FLOP/byte ridge, so
// operations bound it (17 us at the 989 TFLOP/s bf16 tensor-core peak).
//
// Design (simple and right first; wgmma and TMA come later):
//   * one block of 128 threads per (64-row q tile, hq, b); causal tiles
//     wholly above the diagonal are never visited;
//   * the q tile and each 64-row K and V tile are converted to f32 in
//     shared memory once (16-byte global loads, rows past the edge zeroed;
//     K and Q rows padded to D + 1 floats so the strided reads of the score
//     product hit 32 different banks);
//   * thread (g = tid / 8, l = tid % 8) owns rows 4g..4g+3 and the columns
//     l, l + 8, ... of each 64x64 score tile, and the same rows and output
//     columns l, l + 8, ... of the accumulator, all in registers; row max
//     and row sum are reduced over the 8 lanes of a row with shuffles;
//   * P goes through shared memory for the PV product (written and read by
//     the same warp).  The math is f32 on the CUDA cores: bf16 tensor-core
//     MMA would round P to bf16, and an f32 input would need TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace {

using attn_common::load_rows;
using attn_common::NEG_INF;
using attn_common::store_out;
using attn_common::Strides;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so, int Sq, int Sk,
    int group, float scale, int causal) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDP = BK + 1;
  constexpr int DC = D / 8;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = hq / group;
  const T* qb = q + b * sq.b + hq * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = out + b * so.b + hq * so.h;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows 4*rg .. 4*rg+3 of the tile
  const int cl = tid & 7;   // columns cl, cl+8, ...
  const int off = Sk - Sq;  // causal diagonal offset

  load_rows<T, D, BQ>(qb, sq.s, q0, Sq, Qs, LDQ);

  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.0f;
#pragma unroll
    for (int m = 0; m < DC; ++m) acc[i][m] = 0.0f;
  }

  // kv columns [0, kv_end) can be visible to some row of this tile
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + BQ + off);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    load_rows<T, D, BK>(kb, sk.s, k0, Sk, Ks, LDK);
    load_rows<T, D, BK>(vb, sv.s, k0, Sk, Vs, LDV);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(cl + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cl + 8 * j;
        const bool ok = col < Sk && (!causal || col <= row + off);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cl + 8 * j;
        const bool ok = col < Sk && (!causal || col <= row + off);
        const float p = ok ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(rg * 4 + i) * LDP + cl + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int m = 0; m < DC; ++m) acc[i][m] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the lanes of one warp

    const int n_cols = min(BK, Sk - k0);
    for (int c = 0; c < n_cols; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * LDP + c];
#pragma unroll
      for (int m = 0; m < DC; ++m) {
        const float vv = Vs[c * LDV + cl + 8 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(pv[i], vv, acc[i][m]);
      }
    }
    __syncwarp();  // P is read before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int m = 0; m < DC; ++m) store_out(ob + row * so.s + cl + 8 * m, acc[i][m] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st, int B,
           int Hq, int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], Sq, Sk, Hq / Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, const Strides* st,
             int B, int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v, out in that order; the
// last dim of every operand is contiguous.  is_bf16: all four are bf16,
// else all f32.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int is_bf16,
                               int D, const long long* strides, int B, int Hq, int Hkv, int Sq,
                               int Sk, float scale, int causal, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, s);
  return dispatch<float>(D, q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, s);
}
