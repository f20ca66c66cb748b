// Causal / GQA flash attention for prefill: out = softmax(q k^T * scale) v
// with online softmax, f32 softmax state and accumulation, read in bf16 or
// f32 and written in the input's dtype.
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
//   * P stays f32 as in the reference (see the split below);
//   * a row whose softmax mass is 0 writes acc / max(l, 1e-30) = 0.
//
// Bound on the H100: two chained products, 4 * Hq * Sq * Sk * D FLOPs
// (halved under the causal mask) against some (Hq + 2 Hkv) * S * D * bytes
// of operands: at the serving shape [1, 16, 2048, 128] with Hkv 8, causal,
// 17.2 GFLOP against 16.8 MB, far above the card's ~295 FLOP/byte ridge, so
// operations bound it (17 us at the 989 TFLOP/s bf16 tensor-core peak).
//
// bf16 design (flash_wgmma_kernel), on the tensor cores:
//   * one block per 128-row q tile: two consumer warpgroups of 64 rows each
//     and one producer warp.  The block index walks the causal q tiles from
//     the last (heaviest) to the first, so the long blocks start first and
//     the short ones fill the tail;
//   * the producer starts TMA loads (tma.cuh) of the q tile and of 64-row
//     K/V tiles into a four-stage ring, described by 4-D tensor maps of the
//     strided views (rows past Sk read as zeros), with a full and an empty
//     mbarrier per stage: consumers wait for "full", and each consumer warp
//     arrives at "empty" once its products on the tile are done.  Tiles
//     stay bf16 in the swizzled layouts the wgmma descriptors read
//     (wgmma.cuh); causal tiles wholly above the diagonal are never loaded;
//   * S = Q K^T: wgmma m64n64k16, A and B K-major from shared memory, f32
//     accumulators; bf16 x bf16 products are exact in f32, so only the
//     summation order differs from the reference;
//   * each warpgroup starts S of tile j + 1 and O += P V of tile j together
//     and runs the softmax of tile j + 1 while P V of tile j is on the
//     tensor cores; no branch surrounds a wgmma (the compiler serializes
//     wgmma under a branch it cannot prove warp-uniform);
//   * the online softmax runs on the accumulator fragments in registers (a
//     row lives in the 4 lanes of a quad: two shuffles per reduction), in
//     the log2 domain with the special-function unit's exp2; masks cut
//     columns >= Sk and above the diagonal (a tile wholly above warpgroup
//     0's rows is computed all-masked, P = 0);
//   * O += P V: wgmma m64nDk16 with A = P from registers and B = the V tile
//     read MN-major (transpose bit).  A bf16 P would round the
//     probabilities, which neither the reference nor the Pallas kernel
//     does, so P is split: P_hi = bf16(P), P_lo = bf16(P - P_hi) (exact
//     subtraction), and O += P_hi V + P_lo V carries P to ~2^-17 relative:
//     1.5x the tensor-core work of a bf16-P kernel, inside the same bound.
//
// f32 design (flash_kernel), kept for the f32 parity checks: CUDA cores,
// one block of 128 threads per (64-row q tile, hq, b); q, K and V tiles
// converted to f32 in shared memory (K and Q rows padded to D + 1 floats);
// thread (g = tid / 8, l = tid % 8) owns rows 4g..4g+3 and the columns l,
// l + 8, ... of each 64x64 score tile and of the accumulator; P goes through
// shared memory for the PV product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attn_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int WG_BK = 64;         // kv rows per tile
constexpr int WG_STAGES = 4;      // K/V ring depth: tiles j, j + 1 in use, two more in flight
constexpr int WG_CONSUMERS = 256;
constexpr int WG_THREADS = WG_CONSUMERS + 32;   // + one producer warp

template <int D>
struct WgLayout {
  static constexpr uint32_t Q_BYTES = WG_BQ * D * 2;
  static constexpr uint32_t KV_BYTES = WG_BK * D * 2;   // one K or V tile
  static constexpr uint32_t TILES = Q_BYTES + 2 * WG_STAGES * KV_BYTES;
  // tiles (1024-aligned), then the barriers: q, full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = 1024 + TILES + 8 * (1 + 2 * WG_STAGES);
};

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// one warpgroup's 64 rows of the tensor-core body; the accumulator
// fragment of an m64nN wgmma holds row 16 (warp % 4) + quad + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 tig + (i & 1) in its register i
template <int D>
struct WgRows {
  using Tl = wgmma::Tile<D>;
  static constexpr int W = Tl::W;
  static constexpr int PSTEPS = WG_BK / 16;   // k16 steps of O += P V
  float s[WG_BK / 2];                          // S, then P, of the tile in flight
  float o[D / 2];
  uint32_t ph[PSTEPS][4], pl[PSTEPS][4];       // P_hi, P_lo as the A fragments of P V
  float m[2], l[2];                            // log2-domain max; this thread's row-sum share

  // start S = Q K^T on the K tile at `ks` (uncommitted)
  __device__ __forceinline__ void start_qk(uint32_t q_rows, uint32_t ks) {
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i) {
      s[i] = 0.0f;
      wgmma::hold(s[i]);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t pan = (kk * 32) / W, in = (kk * 32) % W;
      wgmma::wgmma_ss_n64(s,
                          wgmma::desc(q_rows + pan * (WG_BQ * W) + in, 16, 8 * W, Tl::LAYOUT),
                          wgmma::desc(ks + pan * (WG_BK * W) + in, 16, 8 * W, Tl::LAYOUT),
                          kk > 0);
    }
  }

  // start O += P_hi V + P_lo V on the V tile at `vs` (uncommitted)
  __device__ __forceinline__ void start_pv(uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      const uint64_t dv = wgmma::desc(vs + kk * 16 * W, WG_BK * W, 8 * W, Tl::LAYOUT);
      wgmma::rs<D>(o, ph[kk], dv);
      wgmma::rs<D>(o, pl[kk], dv);
    }
  }

  // online softmax of the landed S in place (S -> P in f32), for the tile
  // whose first column is k0; returns nothing, leaves the rescale in alpha
  __device__ __forceinline__ void softmax(int k0, int row0, int first_row, int Sk, int off,
                                          int causal, float scale_log2, int tig, float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i) wgmma::hold(s[i]);
    const bool masked = k0 + WG_BK > Sk || (causal && k0 + WG_BK - 1 > first_row + off);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const int col = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= Sk || (causal && col > row + off)) x = NEG_INF;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_ftz(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (masked && s[i] == NEG_INF) ? 0.0f : exp2_ftz(s[i] - m[r]);
      s[i] = p;
      l[r] += p;   // the quad's shares are summed at the end
    }
  }

  // after the P V product in flight has landed: rescale O and split P
  // into the A fragments of the next one (s[8 kk .. 8 kk + 7] -> step kk)
  __device__ __forceinline__ void rescale_and_split(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float x0 = s[8 * kk + 2 * t], x1 = s[8 * kk + 2 * t + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][t] = bf16x2_bits(hi);
        pl[kk][t] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
    }
  }

  // the P V product has landed: its registers may be read and reused
  __device__ __forceinline__ void hold_pv() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) wgmma::hold(o[i]);
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wgmma::hold(ph[kk][t]);
        wgmma::hold(pl[kk][t]);
      }
  }
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, Strides so, int Hq,
    int B, int Sq, int Sk, int group, float scale_log2, int causal) {
  using L = WgLayout<D>;
  constexpr int W = wgmma::Tile<D>::W;
  constexpr int PANELS = 2 * D / W;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (attn_common::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + L::Q_BYTES;                 // stage i at + i * KV_BYTES
  const uint32_t v_s = k_s + WG_STAGES * L::KV_BYTES;
  const uint32_t q_bar = q_s + L::TILES;
  const uint32_t full = q_bar + 8;                       // full[i] at + 8 i
  const uint32_t empty = full + 8 * WG_STAGES;

  const int n_qt = (Sq + WG_BQ - 1) / WG_BQ;
  const int bh = static_cast<int>(blockIdx.x % (Hq * B));
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / (Hq * B))) * WG_BQ;
  const int hq = bh % Hq;
  const int b = bh / Hq;
  const int hk = hq / group;
  const int off = Sk - Sq;   // causal diagonal offset
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + WG_BQ + off);
  const int n_kv = kv_end > 0 ? (kv_end + WG_BK - 1) / WG_BK : 0;   // kv tiles loaded

  const int tid = threadIdx.x;
  if (tid == 0) {
    tma::bar_init(q_bar, 1);
    for (int i = 0; i < WG_STAGES; ++i) {
      tma::bar_init(full + 8 * i, 1);
      tma::bar_init(empty + 8 * i, WG_CONSUMERS / 32);   // one arrival per consumer warp
    }
    tma::bar_init_fence();
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    // producer warp: the q tile, then K/V tile j into stage j % STAGES once
    // both warpgroups have released the tile that held it
    if (tid == WG_CONSUMERS) {
      tma::bar_expect(q_bar, L::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma::load_4d(q_s + p * WG_BQ * W, &tq, p * (W / 2), q0, hq, b, q_bar);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % WG_STAGES;
        tma::bar_wait(empty + 8 * st, ((j / WG_STAGES) & 1) ^ 1);
        tma::bar_expect(full + 8 * st, 2 * L::KV_BYTES);
        for (int p = 0; p < PANELS; ++p) {
          tma::load_4d(k_s + st * L::KV_BYTES + p * WG_BK * W, &tk, p * (W / 2), j * WG_BK, hk, b,
                       full + 8 * st);
          tma::load_4d(v_s + st * L::KV_BYTES + p * WG_BK * W, &tv, p * (W / 2), j * WG_BK, hk, b,
                       full + 8 * st);
        }
      }
    }
    return;
  }

  // consumers.  The warpgroup index is broadcast from lane 0 so that the
  // compiler sees it warp-uniform: wgmma under a branch it cannot prove
  // uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // rows q0 + 64 wg .. + 63
  const int lane = tid & 31;
  const int quad = lane >> 2, tig = lane & 3;
  const int first_row = q0 + wg * 64;
  const int row0 = first_row + ((tid / 32) & 3) * 16 + quad;   // this thread's rows: row0, row0 + 8
  const uint32_t q_rows = q_s + wg * 64 * W;
  auto landed = [&](int j) { tma::bar_wait(full + 8 * (j % WG_STAGES), (j / WG_STAGES) & 1); };
  auto release = [&](int j) {
    if (lane == 0) tma::bar_arrive(empty + 8 * (j % WG_STAGES));
  };

  WgRows<D> w;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.o[i] = 0.0f;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.0f;
  float alpha[2];

  tma::bar_wait(q_bar, 0);
  if (n_kv > 0) {
    landed(0);
    wgmma::fence();
    w.start_qk(q_rows, k_s);
    wgmma::commit();
    wgmma::wait<0>();
    w.softmax(0, row0, first_row, Sk, off, causal, scale_log2, tig, alpha);
    w.rescale_and_split(alpha);
  }
  // steady state: S of tile j + 1 and O += P V of tile j go to the tensor
  // cores together, and the softmax of tile j + 1 runs while P V of tile j
  // does; no branch around the wgmma
  int j = 0;
  for (; j + 1 < n_kv; ++j) {
    landed(j + 1);
    wgmma::fence();
    w.start_qk(q_rows, k_s + ((j + 1) % WG_STAGES) * L::KV_BYTES);
    wgmma::commit();
    w.start_pv(v_s + (j % WG_STAGES) * L::KV_BYTES);
    wgmma::commit();
    wgmma::wait<1>();
    w.softmax((j + 1) * WG_BK, row0, first_row, Sk, off, causal, scale_log2, tig, alpha);
    wgmma::wait<0>();
    w.hold_pv();
    release(j);
    w.rescale_and_split(alpha);
  }
  if (n_kv > 0) {   // the last tile's P V
    wgmma::fence();
    w.start_pv(v_s + (j % WG_STAGES) * L::KV_BYTES);
    wgmma::commit();
    wgmma::wait<0>();
    w.hold_pv();
    release(j);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w.l[r] += __shfl_xor_sync(0xffffffffu, w.l[r], 1);
    w.l[r] += __shfl_xor_sync(0xffffffffu, w.l[r], 2);
    w.l[r] = 1.0f / fmaxf(w.l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + static_cast<long long>(b) * so.b + hq * so.h;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + (i >> 2) * 8 + 2 * tig) =
          __floats2bfloat162_rn(w.o[i] * w.l[r], w.o[i + 1] * w.l[r]);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const Strides* st, int B,
                 int Hq, int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = WgLayout<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long blocks = static_cast<long long>((Sq + WG_BQ - 1) / WG_BQ) * Hq * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int COLS = wgmma::Tile<D>::W / 2;   // box width: one swizzle panel
  CUtensorMap tq, tk, tv;
  int e = tma::map_bf16(&tq, q, B, Hq, Sq, D, st[0].b, st[0].h, st[0].s, WG_BQ, COLS);
  if (e == 0) e = tma::map_bf16(&tk, k, B, Hkv, Sk, D, st[1].b, st[1].h, st[1].s, WG_BK, COLS);
  if (e == 0) e = tma::map_bf16(&tv, v, B, Hkv, Sk, D, st[2].b, st[2].h, st[2].s, WG_BK, COLS);
  if (e != 0) return e;
  flash_wgmma_kernel<D><<<static_cast<unsigned>(blocks), WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], Hq, B, Sq, Sk, Hq / Hkv,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 -> the tensor-core body, f32 -> the CUDA-core body
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const Strides* st, int B,
           int Hq, int Hkv, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wgmma<D>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, scale, causal, stream);
  } else {
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
