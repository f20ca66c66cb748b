// Fused stage-2 kernel: tool scoring + candidate walk + streaming top-k +
// softmax expertise + QoS/load/RTT/affinity fusion + argmax, one warp per
// query, never materialising the [n_q, n_tools] score matrix.
//
// Replaces: src/repro/kernels/score_fuse.py : _score_kernel
//           (fused_score_select_pallas), all of stage 2 of the routing pipeline.
//
// Bound on the H100: at the main path's shape (256 queries, 20,010 tools,
// V_t 123, top_s 8, k 8) only the ~16 tools of each query's 8 candidate
// servers are scored, over the query's ~17 non-zero terms.  The work the
// data needs is the query rows, the candidates, their CSR segments, the
// candidate tools' weights and a few per-tool operands: tens of KB, well
// under a microsecond of bytes.  The kernel is bound by latency: a chain of
// dependent loads (candidates -> segments -> tool ids -> weights) and the
// one-lane finale (its divisions and exponentials, one candidate after
// another).
//
// Design:
//   * One warp per query, four queries per 128-thread block; warps never
//     wait for each other (no block barrier).
//   * The candidate walk: the tools of candidate server s are
//     tools[offsets[s] .. offsets[s + 1]) of a CSR map built once from the
//     tool -> server array (a stable sort, so each server's tools are
//     ascending; the engine keeps it beside its index).  A candidate
//     repeated in a row is walked once.  The pool is the concatenation of the candidates' segments; a
//     warp scan gives each segment's start in it, and a lane finds the
//     segment of a pool position by binary search.
//   * The query's first 128 columns and the candidates are loaded together,
//     so the chain of dependent loads is: (query, candidates) -> segments
//     -> tool ids -> weights -> the finale's per-tool rows, which every
//     lane loads at once into shared memory.
//   * Scores: each lane takes up to 4 pool tools per round of 128.  The
//     query's non-zero terms (and the rerank query's) are compacted on the
//     card, in index order, into per-warp lists (a ballot per 32 columns,
//     128 columns per pass, so any V fits), and each tool's dot runs over
//     them with one rounding per multiply and per add (no FMA).  A term
//     the query lacks would add 0 * w = +-0, which leaves the sum (never
//     -0) unchanged, so the sparse sum has the bits of the plain version's
//     sum over all of V, for finite weights.  bf16 q/w are widened on load.
//   * Merge: the running list and the round's tools form one pool; each
//     entry's rank is the number of pool entries that beat it under
//     (score desc, global tool id asc), exactly lax.top_k's order over the
//     full tool axis, whatever order the tools were visited in.  Ranks
//     below k are written to their slot.  Tool ids are int32.
//   * Finale (lane 0, select_tail.cuh, shared with select_fuse.cu), fed
//     the top-k's rows from shared memory (stride 0, indexed by rank, the
//     rank standing in for the tool id, mapped back after):
//     softmax over the valid candidates, fusion
//     alpha*C + beta*N - gamma*U - delta*R (+ eps*W) in the reference's
//     operation order without contraction, dead candidates excluded from
//     the argmax only, strict '>' so the first maximum wins.  Per-tool rows
//     are read at the winners' ids, broadcast (stride 0) or per query.  The
//     fusion weights are static floats or a live [4] f32 device vector.
//     A query whose candidate servers host no tool returns tool 0 with
//     C = 1/k and S = NEG, as the plain version's argmax over all-NEG
//     scores does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "select_tail.cuh"

namespace {

using select_tail::beats;
using select_tail::NEG;
using select_tail::Rows;
using select_tail::ROW_QOS;
using select_tail::N_ROWS;

constexpr int WARPS = 4;               // queries per block, one warp each
constexpr int THREADS = 32 * WARPS;
constexpr int PER_LANE = 4;            // pool tools per lane per round
constexpr int CH = 32 * PER_LANE;      // pool tools per round
constexpr int VC = 128;                // vocabulary columns compacted per pass
constexpr int K_MAX = 128;
constexpr int S_MAX = 128;             // largest top_s
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct WarpState {
  float run_sel[K_MAX], run_val[K_MAX];
  int run_gid[K_MAX];
  float new_sel[K_MAX], new_val[K_MAX];
  int new_gid[K_MAX];
  float mem_sel[CH], mem_val[CH];
  int mem_gid[CH];
  int cs[S_MAX];                       // candidate server ids
  int seg_lo[S_MAX], seg_start[S_MAX]; // segment start in `tools`, and in the pool
  int qcol[VC], rcol[VC];              // compacted non-zero terms of q and qr
  float qval[VC], rval[VC];
  float row_val[N_ROWS][K_MAX];        // the finale's per-tool rows at the top-k tools
  int win[1];                          // the finale's winner, as a rank
};

// One pass of the vocabulary: columns [c0, c0 + VC) of a query row, VC / 32
// per lane, loaded before any is used.
template <typename TQ>
__device__ __forceinline__ void load_terms(const TQ* __restrict__ row, int c0, int V, int lane,
                                           float (&x)[VC / 32]) {
#pragma unroll
  for (int s = 0; s < VC / 32; ++s) {
    const int c = c0 + 32 * s + lane;
    x[s] = c < V ? to_f32(row[c]) : 0.0f;
  }
}

// Compact a pass's non-zero terms into (col, val), increasing; returns
// their count (the same in every lane).
__device__ __forceinline__ int compact_terms(const float (&x)[VC / 32], int c0, int lane,
                                             int* col, float* val) {
  int n = 0;
#pragma unroll
  for (int s = 0; s < VC / 32; ++s) {
    const unsigned b = __ballot_sync(FULL, x[s] != 0.0f);
    if (x[s] != 0.0f) {
      const int pos = n + __popc(b & ((1u << lane) - 1u));
      col[pos] = c0 + 32 * s + lane;
      val[pos] = x[s];
    }
    n += __popc(b);
  }
  return n;
}

// acc + sum over the n terms of val[t] * wrow[col[t]], in order, one
// rounding per multiply and per add.
template <typename TW>
__device__ __forceinline__ float sparse_dot(const TW* __restrict__ wrow, const int* col,
                                            const float* val, int n, float acc) {
  for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, __fmul_rn(val[t], to_f32(wrow[col[t]])));
  return acc;
}

template <typename TQ, typename TW>
__global__ void __launch_bounds__(THREADS) score_fuse_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ qr, const TW* __restrict__ w,
    const int* __restrict__ tools, const int* __restrict__ offsets,
    const int* __restrict__ cand, Rows rows, const float* __restrict__ wlive, float alpha, float beta,
    float gamma, float delta, float eps, int use_aff, float temp, int n_q, int V, int top_s,
    int k, int* __restrict__ out_idx, float* __restrict__ out_c, float* __restrict__ out_n,
    float* __restrict__ out_s) {
  __shared__ WarpState state[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (qi >= n_q) return;               // the whole warp: nothing below waits on others
  WarpState& st = state[warp];
  const bool rerank = qr != nullptr;
  const TQ* qrow = q + qi * V;
  const TQ* qrrow = rerank ? qr + qi * V : nullptr;

  // -- the first loads go out together: the query's first pass of terms
  // (and the rerank query's) and the candidates --
  float xq[VC / 32], xr[VC / 32];
  load_terms(qrow, 0, V, lane, xq);
  if (rerank) load_terms(qrrow, 0, V, lane, xr);
  for (int i = lane; i < top_s; i += 32) st.cs[i] = cand[qi * top_s + i];
  int nq_terms = compact_terms(xq, 0, lane, st.qcol, st.qval);
  int nr_terms = rerank ? compact_terms(xr, 0, lane, st.rcol, st.rval) : 0;
  __syncwarp();

  // -- the candidates' segments and where each starts in the pool --
  int carry = 0;
  for (int i0 = 0; i0 < top_s; i0 += 32) {
    const int i = i0 + lane;
    int lo = 0, n = 0;
    if (i < top_s) {
      const int s = st.cs[i];
      bool repeat = false;
      for (int j = 0; j < i; ++j) repeat |= st.cs[j] == s;
      if (!repeat) {
        lo = offsets[s];
        n = offsets[s + 1] - lo;
      }
    }
    int incl = n;                      // inclusive scan over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (i < top_s) {
      st.seg_lo[i] = lo;
      st.seg_start[i] = carry + incl - n;
    }
    carry += __shfl_sync(FULL, incl, 31);
  }
  const int pool = carry;
  __syncwarp();

  // -- rounds of up to CH pool tools: score, then merge into the top-k --
  const int n_vc = (V + VC - 1) / VC;
  int filled = 0;                      // valid entries of the running list
  for (int p0 = 0; p0 < pool; p0 += CH) {
    int gid[PER_LANE];
    float acc[PER_LANE], accr[PER_LANE];
#pragma unroll
    for (int h = 0; h < PER_LANE; ++h) {
      const int p = p0 + lane + 32 * h;
      gid[h] = -1;
      acc[h] = 0.0f;
      accr[h] = 0.0f;
      if (p < pool) {
        int a = 0, b = top_s;          // first segment starting after p
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (st.seg_start[mid] <= p) a = mid + 1; else b = mid;
        }
        gid[h] = tools[st.seg_lo[a - 1] + (p - st.seg_start[a - 1])];
      }
    }
    for (int vc = 0; vc < n_vc; ++vc) {
      if (n_vc > 1 && (p0 > 0 || vc > 0)) {   // one pass of V keeps its lists for every round
        __syncwarp();
        load_terms(qrow, vc * VC, V, lane, xq);
        if (rerank) load_terms(qrrow, vc * VC, V, lane, xr);
        nq_terms = compact_terms(xq, vc * VC, lane, st.qcol, st.qval);
        if (rerank) nr_terms = compact_terms(xr, vc * VC, lane, st.rcol, st.rval);
        __syncwarp();
      }
#pragma unroll
      for (int h = 0; h < PER_LANE; ++h) {
        if (gid[h] < 0) continue;
        const TW* wrow = w + static_cast<long long>(gid[h]) * V;
        acc[h] = sparse_dot(wrow, st.qcol, st.qval, nq_terms, acc[h]);
        if (rerank) accr[h] = sparse_dot(wrow, st.rcol, st.rval, nr_terms, accr[h]);
      }
    }
    const int m = min(CH, pool - p0);
#pragma unroll
    for (int h = 0; h < PER_LANE; ++h) {
      const int e = lane + 32 * h;
      if (e < m) {
        st.mem_sel[e] = acc[h];
        st.mem_val[e] = rerank ? accr[h] : acc[h];
        st.mem_gid[e] = gid[h];
      }
    }
    __syncwarp();

    // rank merge of (running list U this round's tools); ranks are distinct
    // because tool ids are, so the slots < k receive exactly one entry each
    const int all = filled + m;
    for (int e = lane; e < all; e += 32) {
      float se, ve;
      int ge;
      if (e < filled) {
        se = st.run_sel[e]; ve = st.run_val[e]; ge = st.run_gid[e];
      } else {
        se = st.mem_sel[e - filled]; ve = st.mem_val[e - filled]; ge = st.mem_gid[e - filled];
      }
      int rank = 0;
#pragma unroll 8
      for (int p = 0; p < filled; ++p) rank += beats(st.run_sel[p], st.run_gid[p], se, ge);
#pragma unroll 8
      for (int p = 0; p < m; ++p) rank += beats(st.mem_sel[p], st.mem_gid[p], se, ge);
      if (rank < k) {
        st.new_sel[rank] = se;
        st.new_val[rank] = ve;
        st.new_gid[rank] = ge;
      }
    }
    __syncwarp();
    filled = min(k, all);
    for (int e = lane; e < filled; e += 32) {
      st.run_sel[e] = st.new_sel[e];
      st.run_val[e] = st.new_val[e];
      st.run_gid[e] = st.new_gid[e];
    }
    __syncwarp();
  }

  // the finale (one lane) would read the per-tool rows at the top-k tools
  // one candidate after another, a round trip each; every lane loads them
  // into shared memory at once instead, and the finale reads them there
  // through rows indexed by rank (stride 0), with the rank as the tool id
  Rows staged = rows;
  for (int e = lane; e < filled; e += 32) {
    const int g = st.run_gid[e];
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r)
      if (rows.ptr[r]) st.row_val[r][e] = rows.ptr[r][qi * rows.stride[r] + g];
    st.new_gid[e] = e;
  }
#pragma unroll
  for (int r = 0; r < N_ROWS; ++r) {
    if (rows.ptr[r]) staged.ptr[r] = st.row_val[r];
    staged.stride[r] = 0;
  }
  __syncwarp();
  if (lane != 0) return;

  if (filled == 0) {
    out_idx[qi] = 0;
    out_c[qi] = 1.0f / static_cast<float>(k);
    out_n[qi] = select_tail::row_at(rows, ROW_QOS, qi, 0);
    out_s[qi] = NEG;
    return;
  }
  const select_tail::Weights wt{wlive, alpha, beta, gamma, delta, eps, use_aff, temp};
  select_tail::finale(filled, st.run_sel, st.run_val, st.new_gid, staged, 0, wt, st.win,
                      out_c + qi, out_n + qi, out_s + qi);
  out_idx[qi] = st.run_gid[st.win[0]];    // the winner's rank -> its tool id
}

template <typename TQ, typename TW>
int launch(const void* q, const void* qr, const void* w, const int* tools, const int* offsets,
           const int* cand, const Rows& rows, const float* wlive, float alpha, float beta,
           float gamma, float delta, float eps, int use_aff, float temp, int n_q, int V,
           int top_s, int k, int* idx, float* c, float* n, float* s, cudaStream_t stream) {
  const int blocks = (n_q + WARPS - 1) / WARPS;
  score_fuse_kernel<TQ, TW><<<blocks, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(qr), static_cast<const TW*>(w), tools,
      offsets, cand, rows, wlive, alpha, beta, gamma, delta, eps, use_aff, temp, n_q, V, top_s,
      k, idx, c, n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tools [n_tools] i32 and offsets [n_servers + 1] i32: the CSR map, server
// s hosts tools[offsets[s] .. offsets[s + 1]), ascending.  cand [n_q, top_s]
// i32 server ids in [0, n_servers).  rows_ptr / rows_stride: qos, load,
// rtt, dead, aff (nullptr = absent, stride 0 = broadcast row, n_t = per
// query).  wlive: nullptr for the static alpha..delta, else a device [4]
// f32 vector.
extern "C" int fused_score_select(const void* q, const void* qr, int q_bf16, const void* w,
                                  int w_bf16, const int* tools, const int* offsets,
                                  const int* cand, const float* const* rows_ptr,
                                  const long long* rows_stride, const float* wlive, float alpha,
                                  float beta, float gamma, float delta, float eps, int use_aff,
                                  float temp, int n_q, int V, int top_s, int k, int* idx,
                                  float* c, float* n, float* s, void* stream) {
  if (top_s > S_MAX || k > K_MAX || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  Rows rows;
  for (int i = 0; i < N_ROWS; ++i) {
    rows.ptr[i] = rows_ptr[i];
    rows.stride[i] = rows_stride[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, qr, w, tools, offsets, cand, rows, wlive,
                                                alpha, beta, gamma, delta, eps, use_aff, temp,
                                                n_q, V, top_s, k, idx, c, n, s, st);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, qr, w, tools, offsets, cand, rows, wlive, alpha,
                                        beta, gamma, delta, eps, use_aff, temp, n_q, V, top_s,
                                        k, idx, c, n, s, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(q, qr, w, tools, offsets, cand, rows, wlive, alpha,
                                        beta, gamma, delta, eps, use_aff, temp, n_q, V, top_s,
                                        k, idx, c, n, s, st);
  return launch<float, float>(q, qr, w, tools, offsets, cand, rows, wlive, alpha, beta, gamma,
                              delta, eps, use_aff, temp, n_q, V, top_s, k, idx, c, n, s, st);
}
